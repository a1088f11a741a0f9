"""Hand-written Hopper kernels of the port and their plain versions.

Each wrapper launches its CUDA kernel for CUDA tensors and runs the plain
PyTorch version only for CPU tensors. ``LAUNCHES`` counts kernel launches
per wrapper (one per call that reaches the card); ``reset_launches`` sets
every count to 0. ``route_dtype`` is the dtype the models' kernel routes
hand the wrappers.
"""

from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {"f3p_build": 0, "wt_hoist": 0,
                            "grid_decode": 0, "grid_decode_rational": 0,
                            "csa_stencil_fused": 0, "csa_stencil": 0,
                            "csa_fused": 0, "csa_attention": 0,
                            "csa_attention_overlap_add": 0,
                            "plane_overlap_add": 0,
                            "swin_block": 0, "swin_block_bwd": 0,
                            "swin_block_wgrad": 0, "swin_block_gsum": 0,
                            "conv3x3_f32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route_dtype(device, dtype: torch.dtype) -> torch.dtype:
    """The dtype a model's kernel route casts its kernel inputs (maps and
    packed weights) to on ``device``: bf16 on a CUDA device, where every
    kernel takes bf16, whatever the model's compute dtype ``dtype`` (the
    JAX package's kernels cast an f32 model's inputs to bf16 inside);
    ``dtype`` itself on the CPU, where the plain versions take either."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else dtype
