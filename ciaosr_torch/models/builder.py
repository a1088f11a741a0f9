"""Config-driven generator builder with the reference's config surface.

Counterpart of ciaosr_tpu/models/builder.py for ``LocalImplicitSRRDN``:
an RDN encoder plus MLPRefiner imnet_q/k/v configs. The imnet in/out dims
are recomputed from the feature width, not read from the config (the net
overwrites them): imnet_k 580 → 576, imnet_v 644 → 640, imnet_q 640 → 3
at C = 64. Weights are random, drawn from an explicit seed with PyTorch's
default Linear/Conv2d init (U(±1/√fan_in)) and PReLU 0.25.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn as nn

from ciaosr_torch.core.device import resolve_device, resolve_dtype
from ciaosr_torch.models.ciaosr import CiaoSRNet
from ciaosr_torch.models.rdn import RDN

_NOT_PORTED = {
    "LocalImplicitSREDSR": "ROADMAP.md queue 1 item 8 (EDSR encoder)",
    "LocalImplicitSRSWINIR": "ROADMAP.md queue 1 item 8 (SwinIR encoder)",
    "LocalImplicitSRNet": "ROADMAP.md queue 1 item 8 (EDSR encoder)",
}


def _hidden(imnet_cfg: dict | None, default=(256, 256, 256, 256)) -> tuple:
    if not imnet_cfg:
        return tuple(default)
    return tuple(imnet_cfg.get("hidden_list", default))


@torch.no_grad()
def init_weights_(module: nn.Module, seed: int) -> None:
    """PyTorch's default init, drawn from a ``torch.Generator`` seeded
    with ``seed``: weights and biases U(±1/√fan_in), PReLU slopes 0.25."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                -bound, bound, generator=g))
            m.bias.copy_(torch.empty(m.bias.shape).uniform_(
                -bound, bound, generator=g))
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)


def build_generator(cfg: dict, *, device=None, seed: int = 0) -> CiaoSRNet:
    """Build the generator on ``device`` (default: the CUDA device; raises
    without one unless ``device="cpu"``) with seeded random weights."""
    dev = resolve_device(device)
    cfg = copy.deepcopy(dict(cfg))
    gname = cfg.pop("type")
    if gname in _NOT_PORTED:
        raise NotImplementedError(f"generator {gname} is not ported yet: "
                                  f"{_NOT_PORTED[gname]}")
    if gname != "LocalImplicitSRRDN":
        raise KeyError(f"unknown generator type {gname}")
    enc_cfg = dict(cfg.pop("encoder"))
    if enc_cfg.pop("type", "RDN") != "RDN":
        raise NotImplementedError("LocalImplicitSRRDN takes an RDN encoder")
    for knob in ("feat_unfold", "non_local_attn"):
        if not cfg.pop(knob, True):
            raise NotImplementedError(
                f"{knob}=False is not ported yet: ROADMAP.md queue 1 item 4")
    # query chunking of the per-query decoder, which is not ported yet
    cfg.pop("eval_bsize", None)
    encoder = RDN(**enc_cfg)
    imnet_q = cfg.pop("imnet_q", None)
    imnet_k = cfg.pop("imnet_k", None)
    imnet_v = cfg.pop("imnet_v", None)
    net = CiaoSRNet(
        encoder=encoder,
        feat_dim=encoder.mid_channels,
        out_dim=(imnet_q or {}).get("out_dim", 3),
        hidden_q=_hidden(imnet_q),
        hidden_k=_hidden(imnet_k),
        hidden_v=_hidden(imnet_v),
        local_size=cfg.pop("local_size", 2),
        multi_scale=tuple(cfg.pop("multi_scale", (2,))),
        softmax_scale=cfg.pop("softmax_scale", 1.0),
        dtype=resolve_dtype(cfg.pop("dtype", None)),
        use_kernels=cfg.pop("use_kernels", False),
    )
    if cfg:
        raise KeyError(f"unknown generator config keys: {sorted(cfg)}")
    init_weights_(net, seed)
    return net.to(dev).eval()
