"""The Swin blocks' least time over the device time inside their ranges, %."""


def read(t):
    r = t.ranged
    dev = r.range_dev.get("swin_block", 0.0)
    least = r.ranges.least_s.get("swin_block", 0.0)
    return least / dev * 100.0 if dev > 0 and least > 0 else None
