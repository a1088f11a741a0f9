"""Peak device memory allocated in the window (reset at its start), GiB."""


def read(t):
    peak = t.info.get("window_peak_bytes", 0)
    return peak / 2 ** 30 if peak > 0 else None
