"""Coordinate grids for implicit image functions (LIIF convention).

Counterpart of ciaosr_tpu/core/coords.py. Per-axis pixel centres
``-1 + (2 i + 1) / n`` for ``i in [0, n)``, stacked in (y, x) order on the
last axis, row-major flatten. Each op runs in float32, in the JAX order,
so the centres (and the nearest-neighbour ties they decide) are
bit-identical to the JAX package's.
"""

from __future__ import annotations

import torch


def _axis_centers(n: int, device=None) -> torch.Tensor:
    return -1.0 + (2.0 * torch.arange(n, dtype=torch.float32,
                                      device=device) + 1.0) / n


def make_coord(shape, flatten: bool = True, device=None) -> torch.Tensor:
    """Pixel-centre grid in [-1, 1], float32: (H·W, 2) if flatten else
    (H, W, 2); the last axis is (y, x)."""
    h, w = shape
    ys, xs = _axis_centers(h, device), _axis_centers(w, device)
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    return grid.reshape(-1, 2) if flatten else grid


def make_cell(target_shape, device=None) -> torch.Tensor:
    """Per-query cell sizes (2/H, 2/W) of a target grid: (H·W, 2)."""
    h, w = target_shape
    n = h * w
    return torch.stack([torch.full((n,), 2.0 / h, dtype=torch.float32,
                                   device=device),
                        torch.full((n,), 2.0 / w, dtype=torch.float32,
                                   device=device)], dim=-1)


def make_coord_cell(target_shape, device=None):
    """(coord, cell) of a full target grid, each (H·W, 2) float32."""
    return (make_coord(target_shape, device=device),
            make_cell(target_shape, device=device))
