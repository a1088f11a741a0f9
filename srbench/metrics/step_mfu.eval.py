"""Operations of every picture finished in the unprofiled window (trunk,
CSA and decode of each tile at real widths) over the window and the bf16
dense peak, %."""

from srbench.flops.ciaosr import PEAK_BF16


def read(t):
    flops, span = t.info.get("step_flops", 0.0), t.info.get("window_s", 0.0)
    return flops / span / PEAK_BF16 * 100.0 if flops > 0 and span > 0 \
        else None
