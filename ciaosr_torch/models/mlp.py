"""Implicit MLPs — the imnet_q/k/v heads of the CiaoSR decoder — and the
positional MLP refiner.

Counterpart of ciaosr_tpu/models/mlp.py (ImplicitMLP, registered as
``MLPRefiner``; ``positional_encoding_1d``; ``PosMLPRefiner``). Reference
layout: ImplicitMLP's ``layers`` is one nn.Sequential of Linear (even
indices) and the activation, so the state_dict keys are
``layers.{2i}.weight`` as in the reference MLPRefiner. ``in_dim`` is
required in both modules: an nn.Linear needs its fan-in at construction.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ciaosr_torch.config.registry import COMPONENTS

_ACTS = {"relu": torch.relu, "sin": torch.sin, "cos": torch.cos}


def linear(x: torch.Tensor, layer: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (params stay f32)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class Activation(nn.Module):
    """The elementwise activation ``act`` (relu, sin or cos) as a module."""

    def __init__(self, act: str):
        super().__init__()
        self.act, self.fn = act, _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.act


@COMPONENTS.register(name="MLPRefiner")
class ImplicitMLP(nn.Module):
    """Linear → act × len(hidden_list) → Linear (act: relu, sin or cos)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_list: Sequence[int] = (), act: str = "relu"):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown act {act}")
        mods: list[nn.Module] = []
        last = in_dim
        for h in hidden_list:
            mods += [nn.Linear(last, h), Activation(act)]
            last = h
        mods.append(nn.Linear(last, out_dim))
        self.layers = nn.Sequential(*mods)
        self.act = _ACTS[act]

    @property
    def linears(self) -> list[nn.Linear]:
        return [m for m in self.layers if isinstance(m, nn.Linear)]

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or x.dtype
        lins = self.linears
        for lin in lins[:-1]:
            x = self.act(linear(x, lin, dt))
        return linear(x, lins[-1], dt)

    def tail(self, h: torch.Tensor,
             dtype: torch.dtype | None = None) -> torch.Tensor:
        """Continue after the first activation (h = act(layer0(x)))."""
        dt = dtype or h.dtype
        lins = self.linears
        for lin in lins[1:-1]:
            h = self.act(linear(h, lin, dt))
        return linear(h, lins[-1], dt)


def positional_encoding_1d(n: int, channels: int,
                           dtype: torch.dtype = torch.float32,
                           device=None) -> torch.Tensor:
    """Interleaved sin/cos 1-D positional encoding, (n, channels), on
    ``device``: inv_freq = 10000^(-2j/ch) with ch = 2⌈channels/2⌉, rows
    [sin(p·f_0), cos(p·f_0), sin(p·f_1), ...] truncated to ``channels``,
    computed in float64 and cast to ``dtype``."""
    ch = int(np.ceil(channels / 2) * 2)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, ch, 2, dtype=np.float64) / ch))
    ang = np.arange(n, dtype=np.float64)[:, None] * inv_freq[None, :]
    emb = np.stack([np.sin(ang), np.cos(ang)], -1).reshape(n, ch)
    return torch.tensor(emb[:, :channels], dtype=dtype, device=device)


@lru_cache(maxsize=64)
def _encoding(n: int, channels: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """``positional_encoding_1d`` kept on its device (read only)."""
    return positional_encoding_1d(n, channels, dtype, device)


@COMPONENTS.register(name="PosMLPRefiner")
class PosMLPRefiner(nn.Module):
    """MLP on (B, C, D) inputs whose hidden activations get a 1-D
    positional encoding added over the middle axis: Linear → ReLU → (+ the
    encoding of the hidden's own (C, width) shape) per hidden, then a
    final Linear. Its layers are registered modules (``layers.{i}``,
    ``out``), as in the JAX package."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_list: Sequence[int] = (), is_pos: bool = True):
        super().__init__()
        dims = [in_dim] + list(hidden_list)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.out = nn.Linear(dims[-1], out_dim)
        self.is_pos = is_pos

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError("PosMLPRefiner expects (B, C, D) inputs, got "
                             f"{tuple(x.shape)}")
        for layer in self.layers:
            x = torch.relu(layer(x))
            if self.is_pos:
                x = x + _encoding(x.shape[1], x.shape[-1], x.dtype,
                                  x.device)[None]
        return self.out(x)
