"""Device time inside the trunk's range, ms per output megapixel of the
fully profiled stretch."""


def read(t):
    r = t.ranged
    dev, mp = r.range_dev.get("encoder", 0.0), r.info.get("output_mp", 0.0)
    return dev / mp * 1e3 if dev > 0 and mp > 0 else None
