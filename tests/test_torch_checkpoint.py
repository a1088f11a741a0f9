"""The port's checkpoint loading (convert/load.py, convert/audit.py),
mirroring tests/test_convert_audit.py on checkpoints the test writes with
``torch.save``: a full restorer checkpoint in an mmcv meta dict (the live
generator, the EMA copy and discriminator RealCiaoSR saves beside it, a
step counter), its EMA variant, a raw SwinIR-family checkpoint with the
upsampler head, the strict failures and the missing-key and shape
messages; and one ``.pth`` loaded by the port and converted by JAX's
``load_torch_checkpoint`` giving the same outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.audit import ConversionAuditError
from ciaosr_torch.convert.load import load_torch_checkpoint
from ciaosr_torch.models.builder import build_generator
from ciaosr_tpu.convert.load import load_torch_checkpoint as jax_load
from ciaosr_tpu.models.builder import build_generator as jax_build
from tests.test_torch_weights import SMALL, jax_query_rgb

SWIN_CSA = dict(
    type="LocalImplicitSRSWINIR", window_size=4,
    encoder=dict(type="SwinIR", embed_dim=12, depths=(2,), num_heads=(3,),
                 window_size=4, img_size=16, mlp_ratio=2,
                 upsampler="pixelshuffle"),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[16, 16]),
    imnet_k=dict(type="MLPRefiner", out_dim=1, hidden_list=[16, 16]),
    imnet_v=dict(type="MLPRefiner", out_dim=1, hidden_list=[16, 16]))
EDSR_SMALL = dict(
    type="LocalImplicitSREDSR",
    encoder=dict(type="EDSR", in_channels=3, mid_channels=16, num_blocks=2),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[16, 16]),
    imnet_k=dict(type="MLPRefiner", out_dim=1, hidden_list=[16, 16]),
    imnet_v=dict(type="MLPRefiner", out_dim=1, hidden_list=[16, 16]))
GENERATORS = {"rdn": SMALL, "edsr": EDSR_SMALL, "swinir": SWIN_CSA}


def _save(path, sd, meta=True):
    torch.save({"meta": {"note": "synthetic"}, "state_dict": sd}
               if meta else sd, str(path))
    return str(path)


@pytest.fixture(scope="module")
def full_ckpt(tmp_path_factory):
    """A RealCiaoSR-shaped mmcv checkpoint of a small RDN generator."""
    gsd = build_generator(SMALL, device="cpu", seed=7).state_dict()
    ema = {k: v + 0.5 for k, v in gsd.items()}   # distinct from live copy
    sd = {f"generator.{k}": v for k, v in gsd.items()}
    sd.update({f"generator_ema.{k}": v for k, v in ema.items()})
    sd["discriminator.conv_0.weight"] = torch.zeros(8, 3, 3, 3)
    sd["discriminator.conv_0.bias"] = torch.zeros(8)
    sd["step_counter"] = torch.zeros((), dtype=torch.long)
    path = _save(tmp_path_factory.mktemp("ckpt") / "real_gan_latest.pth", sd)
    return {"path": path, "gsd": gsd, "ema": ema, "sd": sd}


MODEL_CFG = {"generator": SMALL}


def test_strict_load_full_checkpoint(full_ckpt):
    """Every generator key taken; the EMA, discriminator and step-counter
    families recognized as other modules; the generator loads it."""
    lines = []
    sd = load_torch_checkpoint(full_ckpt["path"], MODEL_CFG, strict=True,
                               log=lines.append)
    assert any("consumed" in ln and "generator_ema" in ln for ln in lines)
    assert set(sd) == set(full_ckpt["gsd"])
    for k, v in full_ckpt["gsd"].items():
        assert torch.equal(sd[k], v), k
    net = build_generator(SMALL, device="cpu", seed=0)
    net.load_state_dict(sd, strict=True)


def test_strict_load_ema_variant(full_ckpt):
    live = load_torch_checkpoint(full_ckpt["path"], MODEL_CFG)
    ema = load_torch_checkpoint(full_ckpt["path"], MODEL_CFG, ema=True,
                                strict=True)
    for k in live:
        torch.testing.assert_close(ema[k], live[k] + 0.5, rtol=0, atol=1e-6)


def test_ema_requires_ema_keys(full_ckpt, tmp_path):
    classical = {k: v for k, v in full_ckpt["sd"].items()
                 if k.startswith("generator.")}
    path = _save(tmp_path / "classical.pth", classical)
    with pytest.raises(KeyError, match="generator_ema"):
        load_torch_checkpoint(path, MODEL_CFG, ema=True)


@pytest.mark.parametrize("key", ["generator.imnet_z.layers.0.weight",
                                 "mystery_module.weight"])
def test_strict_fails_on_unexplained_key(full_ckpt, tmp_path, key):
    """A weight the load would drop, or a family no restorer saves, is an
    error in strict mode and a warning otherwise."""
    sd = dict(full_ckpt["sd"], **{key: torch.zeros(2)})
    path = _save(tmp_path / "extra.pth", sd)
    name = key.split(".")[1 if key.startswith("generator.") else 0]
    with pytest.raises(ConversionAuditError, match=name):
        load_torch_checkpoint(path, MODEL_CFG, strict=True)
    lines = []
    got = load_torch_checkpoint(path, MODEL_CFG, log=lines.append)
    assert set(got) == set(full_ckpt["gsd"])
    assert any("WARNING" in ln and name in ln for ln in lines)


def test_missing_key_message(full_ckpt, tmp_path):
    """A truncated checkpoint fails with the missing key named, strict or
    not."""
    sd = dict(full_ckpt["sd"])
    del sd["generator.imnet_q.layers.0.weight"]
    path = _save(tmp_path / "truncated.pth", sd)
    for strict in (False, True):
        with pytest.raises(KeyError, match="imnet_q.layers.0.weight"):
            load_torch_checkpoint(path, MODEL_CFG, strict=strict)


def test_shape_mismatch(full_ckpt, tmp_path):
    sd = dict(full_ckpt["sd"])
    sd["generator.imnet_q.layers.2.weight"] = torch.zeros(7, 7)
    path = _save(tmp_path / "reshaped.pth", sd)
    with pytest.raises(ConversionAuditError,
                       match=r"imnet_q\.layers\.2\.weight: shape \(7, 7\)"):
        load_torch_checkpoint(path, MODEL_CFG)


def test_raw_swinir_checkpoint(tmp_path):
    """A raw SwinIR-family checkpoint (no prefix, no meta dict: the
    reference's '^' → 'generator.' rewrite) with the upsampler head, the
    img-norm buffer, the recomputed SwinIR buffers, CSA's escape_NaN and,
    with 2 not in multi_scale, the CSA ``down`` conv: every extra key is
    explained by a rule, and strict mode passes."""
    cfg = dict(SWIN_CSA, multi_scale=(3,))
    gsd = build_generator(cfg, device="cpu", seed=3).state_dict()
    assert "cs_attn.downx3.weight" in gsd and "cs_attn.down.weight" not in gsd
    sd = dict(gsd)
    sd.update({"conv_before_upsample.0.weight": torch.zeros(64, 12, 3, 3),
               "upsample.0.weight": torch.zeros(256, 64, 3, 3),
               "conv_last.weight": torch.zeros(3, 64, 3, 3),
               "mean": torch.zeros(1, 3, 1, 1),
               "cs_attn.escape_NaN": torch.tensor([1e-4]),
               "cs_attn.down.weight": torch.zeros(12, 12, 3, 3),
               "cs_attn.down.bias": torch.zeros(12)})
    for j in range(2):
        blk = f"layers.0.residual_group.blocks.{j}"
        sd[f"{blk}.attn.relative_position_index"] = torch.zeros(16, 16)
        sd[f"{blk}.attn_mask"] = torch.zeros(16, 16, 16)
    path = _save(tmp_path / "raw_swinir.pth", sd, meta=False)
    lines = []
    got = load_torch_checkpoint(path, {"generator": cfg}, strict=True,
                                log=lines.append)
    assert set(got) == set(gsd)
    text = "\n".join(lines)
    for why in ("upsampler head", "recomputed", "escape", "multi_scale",
                "img-norm"):
        assert why.split()[0] in text, why


@pytest.mark.parametrize("name", sorted(GENERATORS))
@torch.no_grad()
def test_port_and_jax_load_the_same_pth(name, tmp_path):
    """One ``.pth`` of a seeded port generator: the port's load into a
    generator of other weights, and JAX's conversion (strict) into its
    flax generator, decode the same queries (features, CSA and per-query
    decode) at ≤ 1e-5 in f32."""
    cfg = GENERATORS[name]
    gsd = build_generator(cfg, device="cpu", seed=11).state_dict()
    path = _save(tmp_path / f"{name}.pth",
                 {f"generator.{k}": v for k, v in gsd.items()})
    pnet = build_generator(cfg, device="cpu", seed=0)
    pnet.load_state_dict(load_torch_checkpoint(path, {"generator": cfg},
                                               strict=True), strict=True)
    params = jax_load(path, {"generator": cfg}, strict=True)
    jnet = jax_build(cfg)

    rng = np.random.default_rng(5)
    x = rng.random((1, 12, 16, 3), dtype=np.float32)
    coord = rng.uniform(-1, 1, (1, 64, 2)).astype(np.float32)
    cell = np.full((1, 64, 2), 0.04, np.float32)
    feat = jax.jit(lambda p, x: jnet.apply(p, x, method="gen_feature"))(
        params, jnp.asarray(x))
    nl = jax.jit(lambda p, f: jnet.apply(p, f, method="nl_feature"))(
        params, feat)
    ref = jax_query_rgb(jnet, params, feat, x, coord, cell, nl)

    pfeat = pnet.gen_feature(torch.from_numpy(x))
    np.testing.assert_allclose(pfeat.numpy(), np.asarray(feat), atol=1e-5,
                               rtol=0)
    got = pnet.query_rgb(pfeat, torch.from_numpy(x), torch.from_numpy(coord),
                         torch.from_numpy(cell), None)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_rules_are_the_jax_packages():
    """The ignore rules and the stripped families are JAX's, copied."""
    from ciaosr_torch.convert import audit as port
    from ciaosr_tpu.convert import audit as ref
    assert [(r.pattern, why) for r, why in port._IGNORED_RULES] == \
        [(r.pattern, why) for r, why in ref._IGNORED_RULES]
    assert port._STRIPPED_FAMILIES.pattern == ref._STRIPPED_FAMILIES.pattern
