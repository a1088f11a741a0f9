"""Training losses: adversarial, pixel and perceptual (counterpart of
ciaosr_tpu/losses)."""
