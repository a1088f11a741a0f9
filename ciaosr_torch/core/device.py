"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"`` they raise, so nothing
silently falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the first CUDA device; raise if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is "
                               "not available")
        # f32 reference runs use full f32: no TF32 in matmuls or cuDNN
        # convolutions (cuDNN's default is TF32). The bf16 main path is
        # unaffected.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


_DTYPES = {None: torch.float32, "float32": torch.float32,
           "fp32": torch.float32, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16}


def resolve_dtype(dtype) -> torch.dtype:
    """Config compute dtype (None / 'bf16' / torch dtype) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[dtype]
