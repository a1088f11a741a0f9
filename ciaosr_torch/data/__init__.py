"""Host data layer: the PNG codec, the pipeline ops, the folder datasets
and the prefetching loader (counterpart of ciaosr_tpu/data)."""
