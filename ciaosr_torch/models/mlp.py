"""Implicit MLPs — the imnet_q/k/v heads of the CiaoSR decoder.

Counterpart of ciaosr_tpu/models/mlp.py (ImplicitMLP). Reference layout:
``layers`` is one nn.Sequential of Linear (even indices) and ReLU, so the
state_dict keys are ``layers.{2i}.weight`` as in the reference MLPRefiner.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, layer: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (params stay f32)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class ImplicitMLP(nn.Module):
    """Linear → ReLU × len(hidden_list) → Linear."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_list: Sequence[int] = ()):
        super().__init__()
        mods: list[nn.Module] = []
        last = in_dim
        for h in hidden_list:
            mods += [nn.Linear(last, h), nn.ReLU()]
            last = h
        mods.append(nn.Linear(last, out_dim))
        self.layers = nn.Sequential(*mods)

    @property
    def linears(self) -> list[nn.Linear]:
        return [m for m in self.layers if isinstance(m, nn.Linear)]

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or x.dtype
        lins = self.linears
        for lin in lins[:-1]:
            x = torch.relu(linear(x, lin, dt))
        return linear(x, lins[-1], dt)

    def tail(self, h: torch.Tensor,
             dtype: torch.dtype | None = None) -> torch.Tensor:
        """Continue after the first activation (h = relu(layer0(x)))."""
        dt = dtype or h.dtype
        lins = self.linears
        for lin in lins[1:-1]:
            h = torch.relu(linear(h, lin, dt))
        return linear(h, lins[-1], dt)
