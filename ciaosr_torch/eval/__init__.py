"""Dataset evaluation (counterpart of ciaosr_tpu/eval)."""
