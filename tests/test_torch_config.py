"""The port's config surface against the JAX package's: ``Config.fromfile``
reads every file under ``configs/`` into the same dicts, and
``build_model`` on each 001 config (its generator cut to a few layers and
narrow widths) builds a restorer that, carrying JAX's weights across with
``state_dict_from_jax``, gives JAX's ``build_model``'s outputs.
"""

import glob
import os

import numpy as np
import pytest
import torch

from ciaosr_torch.config import Config
from ciaosr_torch.config.registry import MODELS, Registry, build_from_cfg
from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.models import builder
from ciaosr_torch.models.builder import build_model
from ciaosr_tpu.config.config import Config as JaxConfig
from ciaosr_tpu.models.builder import build_model as jax_build_model
import ciaosr_tpu.models.restorers  # noqa: F401  (registers CiaoSR)
from tests.test_torch_weights import ROOT, seeded_params

CONFIG_FILES = sorted(glob.glob(str(ROOT / "configs" / "*.py")))
CONFIGS_001 = {name: glob.glob(str(
    ROOT / "configs" / f"001_localimplicitsr_{name}_*.py"))[0]
    for name in ("rdn", "edsr", "swinir")}
HIDDEN = [32, 32]
# each 001 generator's encoder cut to a CPU size: (encoder keys, C)
CUTS = {"rdn": (dict(mid_channels=16, num_blocks=2, num_layers=3,
                     channel_growth=8), 16),
        "edsr": (dict(mid_channels=16, num_blocks=2), 16),
        "swinir": (dict(embed_dim=12, depths=(2,), num_heads=(3,)), 12)}


def _plain(x):
    """A config value as plain dicts, lists and scalars."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=[os.path.basename(p)[:-3] for p in CONFIG_FILES])
def test_fromfile_matches_jax(path):
    port, ref = Config.fromfile(path), JaxConfig.fromfile(path)
    assert sorted(port.keys()) == sorted(ref.keys())
    for k in ref.keys():
        assert _plain(port.get(k)) == _plain(ref.get(k)), k
        assert type(port.get(k)).__name__ == type(ref.get(k)).__name__, k
    assert port.filename == ref.filename and port.text == ref.text
    # attribute access reaches nested dicts, as in JAX
    assert port.model.generator.type == ref.model.generator.type


def test_registry_and_build_from_cfg():
    reg = Registry("things")

    @reg.register(name="Pair")
    class Pair:
        def __init__(self, a, b=2):
            self.a, self.b = a, b

    got = build_from_cfg({"type": "Pair", "a": 1}, reg, default_args={"b": 5})
    assert (got.a, got.b) == (1, 5)
    assert build_from_cfg({"type": Pair, "a": 3}, reg).a == 3
    with pytest.raises(KeyError, match="already registered"):
        reg.register(type("Pair", (), {}))
    with pytest.raises(KeyError, match="not found"):
        build_from_cfg({"type": "Nope"}, reg)
    from ciaosr_torch.models.restorers import CiaoSRRestorer
    assert MODELS.get("CiaoSR") is CiaoSRRestorer


def _cut_model(name):
    """The 001 config's ``model`` dict, its generator cut to CPU size."""
    cfg = Config.fromfile(CONFIGS_001[name])
    model = _plain(cfg.model)
    enc, c = CUTS[name]
    gen = model["generator"]
    gen["encoder"] = dict(gen["encoder"], **enc)
    for k in ("imnet_q", "imnet_k", "imnet_v"):
        gen[k] = dict(gen[k], hidden_list=HIDDEN)
    return cfg, model, c


@pytest.mark.parametrize("name", sorted(CONFIGS_001))
@torch.no_grad()
def test_build_model_matches_jax(name):
    """The port's restorer, with JAX's seeded weights carried across,
    against JAX's restorer of the same config: the per-query ``predict``
    of a 16 × 16 image to 101 × 83 (too many phases for a dense decode in
    either package) at ≤ 1e-5, and the same stored test_cfg."""
    cfg, model, c = _cut_model(name)
    jax_model = jax_build_model(model, test_cfg=cfg.test_cfg)
    params = seeded_params(
        jax_model.generator, c, np.zeros((1, 8, 8, 3), np.float32),
        np.zeros((1, 4, 2), np.float32), np.zeros((1, 4, 2), np.float32))
    port = build_model(model, test_cfg=cfg.test_cfg, device="cpu")
    assert not port.generator.use_kernels
    assert _plain(port.test_cfg) == _plain(jax_model.test_cfg)
    port.generator.load_state_dict(state_dict_from_jax(
        params, feat_dim=c, n_hidden=len(HIDDEN), encoder=name),
        strict=True)
    lq = np.random.default_rng(c).random((16, 16, 3), dtype=np.float32)
    got = port.predict(lq, (101, 83))
    ref = jax_model.predict(params, lq, (101, 83))
    assert got.shape == (101, 83, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)


def test_build_model_takes_the_kernel_route_on_cuda(monkeypatch):
    """On a CUDA device the generator config gets ``use_kernels=True``,
    whatever the config says; on the CPU it stays as the config says."""
    seen = {}

    class Recorder:
        def __init__(self, **kw):
            seen.update(kw)

    monkeypatch.setattr(builder, "resolve_device",
                        lambda d: torch.device(d or "cuda"))
    gen = dict(type="LocalImplicitSRRDN", use_kernels=False)
    build_model(dict(type=Recorder, generator=gen), test_cfg={"t": 1})
    assert seen["generator"]["use_kernels"] is True
    assert seen["device"] == torch.device("cuda") and seen["seed"] == 0
    assert seen["test_cfg"] == {"t": 1} and seen["train_cfg"] is None
    build_model(dict(type=Recorder, generator=gen), device="cpu")
    assert seen["generator"]["use_kernels"] is False


@pytest.mark.parametrize("mtype,item", [("RealCiaoSR", "item 7"),
                                        ("BasicRestorer", "item 5")])
def test_build_model_names_what_is_not_ported(mtype, item, tmp_path):
    path = glob.glob(str(ROOT / "configs" / "002_real_gan_*.py"))[0]
    cfg = Config.fromfile(path)
    if mtype == "RealCiaoSR":
        # item 7 is closed: the model builds (tests/test_torch_gan_
        # trainer.py) and so does its train split, whose sample has the
        # keys, shapes and dtypes of JAX's
        from ciaosr_torch.data.datasets import build_dataset
        from ciaosr_tpu.data.datasets import build_dataset as jax_build
        from tests.test_torch_degradations import derived_002, write_df2k
        write_df2k(tmp_path, n=1)
        cfg = Config.fromfile(derived_002("gan", tmp_path))
        got = build_dataset(cfg.data["train"]).load(
            0, np.random.default_rng(1))
        ref = jax_build(cfg.data["train"])[0]
        assert set(got) == set(ref) == {"lq", "gt", "gt_unsharp", "coord",
                                        "cell", "meta"}
        for k in set(got) - {"meta"}:
            assert (got[k].shape, got[k].dtype) == (ref[k].shape,
                                                    ref[k].dtype), k
        return
    model = dict(_plain(cfg.model), type=mtype)
    with pytest.raises(NotImplementedError, match=item):
        build_model(model, device="cpu")
