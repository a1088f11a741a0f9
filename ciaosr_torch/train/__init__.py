"""Classical training: optimizers and LR schedules from config dicts, the
train step, the Trainer loop and its checkpoints (counterpart of
ciaosr_tpu/train)."""
