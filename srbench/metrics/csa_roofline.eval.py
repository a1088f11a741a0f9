"""The CSA calls' least time at real widths over the device time inside
their ranges, %."""


def read(t):
    r = t.ranged
    dev = r.range_dev.get("csa", 0.0)
    least = r.ranges.least_s.get("csa", 0.0)
    return least / dev * 100.0 if dev > 0 and least > 0 else None
