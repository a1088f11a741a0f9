"""JAX (flax) param tree → the port's reference-layout state_dict.

Inverts each step of ciaosr_tpu/convert/torch_weights.py::convert_generator
(RDN, EDSR and SwinIR generators): Dense (in, out) → Linear (out, in); HWIO →
OIHW; LayerNorm ``scale`` → ``weight``; the PReLU scalar → a (1,) weight;
``rdb_i/layers_j`` → ``rdbs.i.layers.j.conv``; ``gff_0/1`` → ``gff.0/1``;
``body_i/conv1`` → ``body.i.conv1``; a fixed-scale net's
``upsample/up_i`` → ``upsample.i`` beside its trunk's keys
(``basic_sr_state_dict_from_jax``); ``patch_embed_norm`` →
``patch_embed.norm``; ``layers_i/blocks_j/mlp_fc1`` →
``layers.i.residual_group.blocks.j.mlp.fc1`` (and the SwinIR
converter's other block keys); ``cs_attn/*_conv``/``*_prelu``/``down`` →
``cs_attn.*.0``/``.1``/``down``; and the tap-major → channel-major
permutation of the imnet unfold blocks (none without the unfold). Input:
nested dicts of arrays (optionally under a top-level "params" key).
Output: a dict of f32 CPU tensors for
``CiaoSRNet.load_state_dict(strict=True)``. The GAN stack's modules
convert too (``discriminator_state_dict_from_jax``,
``vgg19_state_dict_from_jax``), so a whole ``GANTrainState`` (g_params,
ema_params, d_vars) carries into the port.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ciaosr_torch.ops.neighborhood import tap_major_perm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p: dict, key: str, sd: dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _ln(p: dict, key: str, sd: dict) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _linear(p: dict, key: str, sd: dict, in_perm=None, out_perm=None):
    w = np.asarray(p["kernel"], np.float32).T          # (out, in) ours
    if "bias" not in p:       # a bias-free Dense (SwinIR qkv_bias=False)
        sd[f"{key}.weight"] = _t(w)
        return
    b = np.asarray(p["bias"], np.float32)
    if in_perm is not None:
        w_t = np.empty_like(w)
        w_t[:, in_perm] = w
        w = w_t
    if out_perm is not None:
        w_t, b_t = np.empty_like(w), np.empty_like(b)
        w_t[out_perm] = w
        b_t[out_perm] = b
        w, b = w_t, b_t
    sd[f"{key}.weight"] = _t(w)
    sd[f"{key}.bias"] = _t(b)


def _mlp(p: dict, prefix: str, n_hidden: int, sd: dict, in_perm=None,
         out_perm=None) -> None:
    for i in range(n_hidden):
        _linear(p[f"layers_{i}"], f"{prefix}.layers.{2 * i}", sd,
                in_perm=in_perm if i == 0 else None)
    _linear(p["out"], f"{prefix}.layers.{2 * n_hidden}", sd,
            in_perm=in_perm if n_hidden == 0 else None, out_perm=out_perm)


def rdn_state_dict_from_jax(enc: dict) -> dict:
    """The RDN encoder subtree → ``sfe1``/``rdbs.*``/``gff.*`` keys."""
    sd: dict[str, torch.Tensor] = {}
    _conv(enc["sfe1"], "sfe1", sd)
    _conv(enc["sfe2"], "sfe2", sd)
    n_rdb = len([k for k in enc if k.startswith("rdb_")])
    for i in range(n_rdb):
        blk = enc[f"rdb_{i}"]
        n_layers = len([k for k in blk if k.startswith("layers_")])
        for j in range(n_layers):
            _conv(blk[f"layers_{j}"], f"rdbs.{i}.layers.{j}.conv", sd)
        _conv(blk["lff"], f"rdbs.{i}.lff", sd)
    _conv(enc["gff_0"], "gff.0", sd)
    _conv(enc["gff_1"], "gff.1", sd)
    return sd


def edsr_state_dict_from_jax(enc: dict) -> dict:
    """The EDSR encoder subtree → ``conv_first``/``body.*``/
    ``conv_after_body`` keys (the inverse of
    ciaosr_tpu/convert/torch_weights.py::convert_edsr_encoder)."""
    sd: dict[str, torch.Tensor] = {}
    _conv(enc["conv_first"], "conv_first", sd)
    n_blocks = len([k for k in enc if k.startswith("body_")])
    for i in range(n_blocks):
        for name in ("conv1", "conv2"):
            _conv(enc[f"body_{i}"][name], f"body.{i}.{name}", sd)
    _conv(enc["conv_after_body"], "conv_after_body", sd)
    return sd


def swin_block_state_dict_from_jax(blk: dict) -> dict:
    """One Swin block's subtree → ``norm1``/``attn.*``/``norm2``/``mlp.*``
    keys (no prefix)."""
    sd: dict[str, torch.Tensor] = {}
    _ln(blk["norm1"], "norm1", sd)
    _ln(blk["norm2"], "norm2", sd)
    _linear(blk["attn"]["qkv"], "attn.qkv", sd)
    _linear(blk["attn"]["proj"], "attn.proj", sd)
    sd["attn.relative_position_bias_table"] = _t(
        blk["attn"]["relative_position_bias_table"])
    _linear(blk["mlp_fc1"], "mlp.fc1", sd)
    _linear(blk["mlp_fc2"], "mlp.fc2", sd)
    return sd


def swinir_state_dict_from_jax(enc: dict) -> dict:
    """The SwinIR encoder subtree → ``conv_first``/``patch_embed.norm``/
    ``layers.*``/``norm``/``conv_after_body`` keys (the inverse of
    ciaosr_tpu/convert/swinir_weights.py::convert_swinir_encoder)."""
    sd: dict[str, torch.Tensor] = {}
    _conv(enc["conv_first"], "conv_first", sd)
    if "patch_embed_norm" in enc:
        _ln(enc["patch_embed_norm"], "patch_embed.norm", sd)
    n_layers = len([k for k in enc if k.startswith("layers_")])
    for i in range(n_layers):
        lp = enc[f"layers_{i}"]
        n_blocks = len([k for k in lp if k.startswith("blocks_")])
        for j in range(n_blocks):
            for k, v in swin_block_state_dict_from_jax(
                    lp[f"blocks_{j}"]).items():
                sd[f"layers.{i}.residual_group.blocks.{j}.{k}"] = v
        _conv(lp["conv"], f"layers.{i}.conv", sd)
    _ln(enc["norm"], "norm", sd)
    _conv(enc["conv_after_body"], "conv_after_body", sd)
    return sd


_ENCODERS = {"rdn": rdn_state_dict_from_jax,
             "edsr": edsr_state_dict_from_jax,
             "swinir": swinir_state_dict_from_jax}


def _n_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def basic_sr_state_dict_from_jax(params: dict, family: str) -> dict:
    """Flax params of an EDSRNet (``family`` 'edsr') or RDNNet ('rdn') →
    the port's keys (models/basic_sr.py): ``trunk/*`` as the encoder's
    converter gives them, ``upsample/up_i`` → ``upsample.i``,
    ``conv_last``. Every JAX leaf becomes one tensor; a leaf left over is
    a KeyError."""
    p = params.get("params", params)
    sd = _ENCODERS[family](p["trunk"])
    ups = p["upsample"]
    for i in range(len(ups)):
        _conv(ups[f"up_{i}"], f"upsample.{i}", sd)
    _conv(p["conv_last"], "conv_last", sd)
    if len(sd) != _n_leaves(p):
        raise KeyError(f"{_n_leaves(p) - len(sd)} JAX leaves left over by "
                       f"the {family} converter")
    return sd


def state_dict_from_jax(params: dict, *, feat_dim: int, n_hidden: int = 4,
                        multi_scale=(2,), encoder: str = "rdn",
                        non_local_attn: bool = True,
                        feat_unfold: bool = True) -> dict:
    """Flax params of a LocalImplicitSR{RDN,EDSR,SWINIR} generator
    (non-local attention and the unfold as given) → reference-layout
    state_dict. Without the unfold the blocks are C wide and their
    permutation is the identity."""
    p = params.get("params", params)
    c = feat_dim
    taps = 9 if feat_unfold else 1
    base = taps * c
    nla = c * len(multi_scale) if non_local_attn else 0
    perm = tap_major_perm(c, taps)

    def block_perm(extra: int) -> np.ndarray:
        return np.concatenate([perm, base + np.arange(extra)])

    sd = _ENCODERS[encoder](p["encoder"])
    _mlp(p["imnet_q"], "imnet_q", n_hidden, sd, in_perm=block_perm(nla))
    _mlp(p["imnet_k"], "imnet_k", n_hidden, sd, in_perm=block_perm(4),
         out_perm=perm)
    _mlp(p["imnet_v"], "imnet_v", n_hidden, sd, in_perm=block_perm(nla + 4),
         out_perm=block_perm(nla))
    if non_local_attn:
        for k, v in csa_state_dict_from_jax(p["cs_attn"],
                                            multi_scale).items():
            sd[f"cs_attn.{k}"] = v
    return sd


def csa_state_dict_from_jax(cs: dict, scales=(2,)) -> dict:
    """The cs_attn subtree → CrossScaleAttention keys (no prefix)."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("conv_match_1", "conv_match_2", "conv_assembly"):
        _conv(cs[f"{name}_conv"], f"{name}.0", sd)
        sd[f"{name}.1.weight"] = _t(
            np.asarray(cs[f"{name}_prelu"]["negative_slope"]).reshape(1))
    for s in scales:
        name = "down" if s == 2 else f"downx{s}"
        _conv(cs[name], name, sd)
    return sd


def discriminator_state_dict_from_jax(d_vars: dict) -> dict:
    """A flax U-Net SN discriminator's variables ({'params',
    'batch_stats'}) → the port's ``UNetDiscriminatorSN`` /
    ``SmallUNetDiscriminatorSN`` keys: ``conv_k`` (HWIO → OIHW, with its
    bias) for the plain convs, ``conv_k.weight`` from ``conv_k_inner`` and
    the power-iteration state ``conv_k.u`` (1, out) and ``conv_k.sigma``
    () from ``batch_stats``."""
    sd: dict[str, torch.Tensor] = {}
    for name, p in d_vars["params"].items():
        _conv(p, name[:-len("_inner")] if name.endswith("_inner") else name,
              sd)
    for name, stats in d_vars.get("batch_stats", {}).items():
        sd[f"{name}.u"] = _t(stats[f"{name}_inner/kernel/u"])
        sd[f"{name}.sigma"] = _t(stats[f"{name}_inner/kernel/sigma"])
    return sd


def vgg19_state_dict_from_jax(params: dict) -> dict:
    """Flax ``VGG19Features`` params (``conv_N``) → torchvision's
    ``features.N.weight`` / ``.bias``."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    for name, conv in p.items():
        _conv(conv, f"features.{name[len('conv_'):]}", sd)
    return sd
