"""Device time of the convolutions' kernels, forward and backward (those
launched only under operators named ...convolution...), per training
step of the fully profiled stretch, ms."""


def read(t):
    r = t.ranged
    dev, n = r.op_dev("convolution"), r.info.get("steps", 0)
    return dev / n * 1e3 if dev > 0 and n else None
