"""1 - (union of device activity) / stretch, over the device-only
stretch (no host operators recorded, no ranges), %."""


def read(t):
    busy, span = t.light.busy_s, t.light.window_s
    return (1.0 - busy / span) * 100.0 if busy > 0 and span > 0 else None
