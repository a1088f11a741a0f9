"""Config-driven generator builder with the reference's config surface.

Counterpart of ciaosr_tpu/models/builder.py for ``LocalImplicitSRRDN``
(an RDN encoder), ``LocalImplicitSREDSR`` (an EDSR encoder),
``LocalImplicitSRNet`` (an RDN or EDSR encoder, named by the encoder's
``type``) and ``LocalImplicitSRSWINIR`` (a SwinIR encoder; the
generator's ``window_size`` reaches the encoder), plus MLPRefiner
imnet_q/k/v configs and ``feat_unfold``. The imnet in/out dims are
recomputed from the feature width, not read from the config (the net
overwrites them): imnet_k 580 → 576, imnet_v 644 → 640, imnet_q 640 → 3
at C = 64 with CSA (68 → 64, 132 → 128, 128 → 3 with
``feat_unfold=False``). The 002
configs' decoder knobs with baked-in semantics are accepted and checked
as in the JAX package. The encoder is built from ``BACKBONES`` by
its ``type`` (``RDN``, ``EDSR`` or ``SwinIR``, the JAX package's names).
The fixed-scale nets ``EDSRNet`` and ``RDNNet`` (models/basic_sr.py,
``FIXED_SCALE``, also in ``BACKBONES``) build from their own keys.
``build_model`` builds a restorer from a config's ``model`` dict
(``build_model`` at ciaosr_tpu/models/builder.py): ``CiaoSR``,
``RealCiaoSR`` (models/real_restorer.py) or ``BasicRestorer``. Weights are
random, drawn from an explicit seed with PyTorch's default Linear/Conv2d
init (U(±1/√fan_in)) and PReLU 0.25;
the SwinIR trunk then takes the reference's own init (trunc-normal(0.02)
Linear weights and bias tables, zero Linear biases, LayerNorms 1 / 0).
"""

from __future__ import annotations

import copy
import math
import warnings

import torch
import torch.nn as nn

from ciaosr_torch.config.registry import BACKBONES, build_from_cfg
from ciaosr_torch.core.device import resolve_device, resolve_dtype
from ciaosr_torch.models.basic_sr import FIXED_SCALE
from ciaosr_torch.models.ciaosr import CiaoSRNet
from ciaosr_torch.models.swinir import SwinIR

# generator type -> the encoder types it takes (the first is the default)
_ENCODERS = {"LocalImplicitSRRDN": ("RDN",),
             "LocalImplicitSREDSR": ("EDSR",),
             "LocalImplicitSRNet": ("RDN", "EDSR"),
             "LocalImplicitSRSWINIR": ("SwinIR",)}

# Knobs the 002 configs pass that are constants in the shipped decoder
# (unfold + lec + mulwkv + res always on): name -> required value.
_BAKED_IN = {
    "local_ensemble_coord": True,
    "imnet_k_type": "mul_w_cell",
    "imnet_v_type": "mul_w_cell",
    "res": True,
    "cat_nla_v": True,
    "query_mlp": None,
    "key_mlp": None,
    "value_mlp": None,
}


def _hidden(imnet_cfg: dict | None, default=(256, 256, 256, 256)) -> tuple:
    if not imnet_cfg:
        return tuple(default)
    return tuple(imnet_cfg.get("hidden_list", default))


def _check_baked_in(cfg: dict) -> None:
    """Pop the baked-in knobs; a contradicting value warns, or raises with
    ``strict_knobs=True`` (the reference's own __init__ rejects them)."""
    strict = cfg.pop("strict_knobs", False)
    for knob, baked in _BAKED_IN.items():
        if knob in cfg:
            v = cfg.pop(knob)
            if v != baked and v is not None:
                msg = (f"{knob}={v!r} has baked-in semantics "
                       f"{knob}={baked!r} — the reference collapses these "
                       "knobs to constants and its own __init__ rejects "
                       "them; proceeding with the baked-in behavior")
                if strict:
                    raise ValueError(msg)
                warnings.warn(msg, stacklevel=3)


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
            if m.bias is not None:
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(
                    -bound, bound, generator=g))
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)
    if isinstance(getattr(module, "encoder", None), SwinIR):
        module.encoder.init_trunk_(g)


def make_generator(cfg: dict) -> nn.Module:
    """The generator's modules as ``cfg`` gives them, with PyTorch's own
    initial weights, on the default device (``torch.device("meta")`` as a
    context gives its parameter shapes without storage): a CiaoSR
    generator, or a fixed-scale net of ``FIXED_SCALE``."""
    cfg = copy.deepcopy(dict(cfg))
    gname = cfg.pop("type")
    if gname in FIXED_SCALE:
        return BACKBONES.get(gname)(**cfg)
    if gname not in _ENCODERS:
        raise KeyError(f"unknown generator type {gname}")
    _check_baked_in(cfg)
    enc_cfg = dict(cfg.pop("encoder"))
    enc_cfg.setdefault("type", _ENCODERS[gname][0])
    if enc_cfg["type"] not in _ENCODERS[gname]:
        raise KeyError(f"{gname} takes a {' or '.join(_ENCODERS[gname])} "
                       f"encoder, got {enc_cfg['type']}")
    window_size = cfg.pop("window_size", None)
    if enc_cfg["type"] == "SwinIR" and window_size is not None:
        enc_cfg.setdefault("window_size", window_size)
    encoder = build_from_cfg(enc_cfg, BACKBONES)
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
        feat_unfold=cfg.pop("feat_unfold", True),
        non_local_attn=cfg.pop("non_local_attn", True),
        multi_scale=tuple(cfg.pop("multi_scale", (2,))),
        softmax_scale=cfg.pop("softmax_scale", 1.0),
        eval_bsize=cfg.pop("eval_bsize", None),
        dtype=resolve_dtype(cfg.pop("dtype", None)),
        use_kernels=cfg.pop("use_kernels", False),
    )
    if cfg:
        raise KeyError(f"unknown generator config keys: {sorted(cfg)}")
    return net


def build_generator(cfg: dict, *, device=None, seed: int = 0) -> nn.Module:
    """Build the generator on ``device`` (default: the CUDA device; raises
    without one unless ``device="cpu"``) with seeded random weights."""
    dev = resolve_device(device)
    net = make_generator(cfg)
    init_weights_(net, seed)
    return net.to(dev).eval()


def build_model(cfg: dict, train_cfg=None, test_cfg=None, *, device=None,
                seed: int = 0):
    """A restorer from a config's ``model`` dict on ``device`` (default:
    the CUDA device; raises without one unless ``device="cpu"``), with
    seeded random weights. On a CUDA device a CiaoSR generator takes the
    kernel route (``use_kernels=True``), whatever the config says; the
    fixed-scale nets have no kernel route."""
    import ciaosr_torch.models.real_restorer  # noqa: F401  (registry)
    from ciaosr_torch.config.registry import MODELS

    cfg = copy.deepcopy(dict(cfg))
    mtype = cfg.pop("type")
    cls = MODELS.get(mtype) if isinstance(mtype, str) else mtype
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg["generator"].get("type") in _ENCODERS:
        cfg["generator"] = dict(cfg["generator"], use_kernels=True)
    return cls(train_cfg=train_cfg, test_cfg=test_cfg, device=dev,
               seed=seed, **cfg)
