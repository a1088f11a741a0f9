"""The Swin blocks' least time, forward and backward, over the device time
inside their forward and backward ranges, %."""


def read(t):
    r = t.ranged
    dev = r.range_dev.get("swin_block", 0.0) \
        + r.range_dev.get("swin_block_bwd", 0.0)
    least = r.ranges.least_s.get("swin_block", 0.0) \
        + r.ranges.least_s.get("swin_block_bwd", 0.0)
    return least / dev * 100.0 if dev > 0 and least > 0 else None
