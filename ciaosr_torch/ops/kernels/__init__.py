"""Hand-written Hopper kernels of the port and their plain versions.

Each wrapper launches its CUDA kernel for CUDA tensors and runs the plain
PyTorch version only for CPU tensors. ``LAUNCHES`` counts kernel launches
per wrapper (one per call that reaches the card); ``reset_launches`` sets
every count to 0.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"f3p_build": 0, "wt_hoist": 0,
                            "grid_decode": 0, "csa_stencil": 0,
                            "grid_decode_rational": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
