"""The dense decodes' least time (K1 + K2 + K3 work at real widths) over
the device time inside the decode ranges less the trunk's and the CSA's
ranges nested in them, %."""


def read(t):
    r = t.ranged
    dev = r.range_dev.get("decode", 0.0) - r.range_dev.get("encoder", 0.0) \
        - r.range_dev.get("csa", 0.0)
    least = r.ranges.least_s.get("decode", 0.0)
    return least / dev * 100.0 if dev > 0 and least > 0 else None
