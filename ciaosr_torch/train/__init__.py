"""Training: optimizers and LR schedules from config dicts, the train
step (counterpart of ciaosr_tpu/train)."""
