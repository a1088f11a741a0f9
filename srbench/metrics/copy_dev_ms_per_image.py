"""Device time of host-device copies (memcpy, both ways) per picture of
the device-only stretch, ms."""


def read(t):
    n = t.light.info.get("items", 0)
    copies = t.light.device_s("Memcpy")
    return copies / n * 1e3 if n and copies > 0 else None
