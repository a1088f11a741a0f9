"""Several GPUs: one process per GPU on torch.distributed (counterpart of
ciaosr_tpu/parallel)."""
