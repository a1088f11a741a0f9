"""The training step's least time (each product at the peak of the
precision it runs in) times the steps of the unprofiled window, over the
window, %."""


def read(t):
    least, n = t.info.get("step_least_s", 0.0), t.info.get("steps", 0)
    span = t.info.get("window_s", 0.0)
    return least * n / span * 100.0 if least > 0 and n and span > 0 \
        else None
