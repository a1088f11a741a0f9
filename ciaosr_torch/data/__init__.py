"""Host data layer: the PNG codec, the eval pipeline ops and the folder
datasets (counterpart of ciaosr_tpu/data)."""
