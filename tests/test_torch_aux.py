"""The port's last public pieces against the JAX package, on the CPU:
``positional_encoding_1d`` (≤ 1e-7), ``PosMLPRefiner`` and a
registry-built ``MLPRefiner`` with each ``act`` on the same weights
(carried by ``pos_mlp_state_dict_from_jax`` / ``mlp_state_dict_from_jax``;
≤ 1e-5 abs), ``grid_sample_nearest`` (bit for bit against JAX's and
``F.grid_sample(mode="nearest")``, exact half-pixel ties and coords
outside [-1, 1] included), ``imresize_torch`` (≤ 1e-5 of ``imresize_jnp``,
≤ 1e-4 of ``imresize_np``, with and without a leading batch axis), the
six registries' names, and ``make_generator``'s encoders from ``BACKBONES``
beside the loader's fixed-scale rule.
"""

import glob
import importlib
import math
import os
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.test_torch_weights  # noqa: F401  (caps torch's CPU threads)
from ciaosr_torch.config import registry as port_registry
from ciaosr_torch.config.config import Config
from ciaosr_torch.config.registry import BACKBONES, COMPONENTS, build_from_cfg
from ciaosr_torch.convert.from_jax import (mlp_state_dict_from_jax,
                                           pos_mlp_state_dict_from_jax)
from ciaosr_torch.convert.load import _fixed_scale, generator_shapes
from ciaosr_torch.core.resize import imresize_np, imresize_torch
from ciaosr_torch.models.builder import make_generator
from ciaosr_torch.models.mlp import PosMLPRefiner, positional_encoding_1d
from ciaosr_torch.ops.sampling import grid_sample_nearest
from ciaosr_tpu.config import registry as jax_registry
from ciaosr_tpu.config.registry import COMPONENTS as JAX_COMPONENTS
from ciaosr_tpu.core.resize import imresize_jnp
from ciaosr_tpu.models import mlp as jax_mlp
from ciaosr_tpu.ops.sampling import (
    grid_sample_nearest as jax_grid_sample_nearest)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.py")))
REGISTRIES = ("MODELS", "BACKBONES", "DATASETS", "PIPELINES", "LOSSES",
              "COMPONENTS")


# ------------------------------------------------------ positional MLP ---

@pytest.mark.parametrize("n,ch", [(32, 10), (7, 9), (64, 256)])
def test_positional_encoding_matches_jax(n, ch):
    got = positional_encoding_1d(n, ch)
    want = np.asarray(jax_mlp.positional_encoding_1d(n, ch))
    assert got.shape == (n, ch) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    f64 = positional_encoding_1d(n, ch, torch.float64, "cpu")
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.float().numpy(), want, rtol=0, atol=1e-7)


def _jax_pos_mlp(is_pos: bool):
    m = jax_mlp.PosMLPRefiner(out_dim=5, hidden_list=[8, 6], in_dim=7,
                              is_pos=is_pos)
    x = np.random.default_rng(0).random((2, 4, 7), np.float32)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return m, params, x


@pytest.mark.parametrize("is_pos", [True, False])
@torch.no_grad()
def test_pos_mlp_refiner_matches_jax(is_pos):
    m, params, x = _jax_pos_mlp(is_pos)
    want = np.asarray(m.apply(params, jnp.asarray(x)))
    net = PosMLPRefiner(in_dim=7, out_dim=5, hidden_list=[8, 6],
                        is_pos=is_pos)
    sd = pos_mlp_state_dict_from_jax(params)
    assert set(sd) == set(net.state_dict()) == {
        "layers.0.weight", "layers.0.bias", "layers.1.weight",
        "layers.1.bias", "out.weight", "out.bias"}
    net.load_state_dict(sd, strict=True)
    got = net(torch.from_numpy(x))
    assert got.shape == (2, 4, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # every Linear is a parameter the optimizer sees
    assert len(list(net.parameters())) == 6


def test_pos_mlp_refiner_rank_and_registry():
    m, params, x = _jax_pos_mlp(True)
    net = build_from_cfg(dict(type="PosMLPRefiner", in_dim=7, out_dim=5,
                              hidden_list=[8, 6]), COMPONENTS)
    assert isinstance(net, PosMLPRefiner)
    with pytest.raises(ValueError):
        net(torch.from_numpy(x[0]))          # must be (B, C, D)
    with pytest.raises(ValueError):
        m.apply(params, jnp.asarray(x[0]))   # as in the JAX package


@pytest.mark.parametrize("act", ["relu", "sin", "cos"])
@torch.no_grad()
def test_mlp_refiner_from_both_registries(act):
    cfg = dict(type="MLPRefiner", in_dim=7, out_dim=5, hidden_list=[8, 6],
               act=act)
    jm = build_from_cfg(cfg, JAX_COMPONENTS)
    x = np.random.default_rng(1).standard_normal((3, 11, 7)).astype(
        np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    net = build_from_cfg(cfg, COMPONENTS)
    net.load_state_dict(mlp_state_dict_from_jax(params), strict=True)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(net(tx).numpy(), want, rtol=0, atol=1e-5)
    # tail continues after the first activation
    h = net.act(net.linears[0](tx))
    np.testing.assert_allclose(net.tail(h).numpy(), want, rtol=0,
                               atol=1e-5)


def test_mlp_refiner_config_errors():
    with pytest.raises(TypeError, match="in_dim"):
        build_from_cfg(dict(type="MLPRefiner", out_dim=3,
                            hidden_list=[8]), COMPONENTS)
    with pytest.raises(ValueError, match="tanh"):
        build_from_cfg(dict(type="MLPRefiner", in_dim=4, out_dim=3,
                            hidden_list=[8], act="tanh"), COMPONENTS)


# ------------------------------------------------------------ sampling ---

def _torch_nearest(feat: np.ndarray, coord: np.ndarray) -> np.ndarray:
    grid = torch.from_numpy(coord).flip(-1).unsqueeze(1)   # (x, y) order
    ref = F.grid_sample(torch.from_numpy(feat).permute(0, 3, 1, 2), grid,
                        mode="nearest", align_corners=False)
    return ref[:, :, 0, :].permute(0, 2, 1).numpy()


def _tie_coords(h: int, w: int) -> np.ndarray:
    """(y, x) pairs whose source index ((y + 1)·h − 1) / 2 is an exact
    half-integer (y = 2k/h − 1, exact in f32 for h a power of 2, and x
    likewise), from beyond −1 to beyond 1."""
    ys = 2.0 * np.arange(-1, h + 3) / h - 1.0
    xs = 2.0 * np.arange(-2, w + 4) / w - 1.0
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["jax_test", "ties_out_of_range"])
def test_grid_sample_nearest_bit_for_bit(case):
    rng = np.random.default_rng(2)
    if case == "jax_test":   # tests/test_core_numerics.py's shapes
        b, h, w, c, q = 2, 13, 9, 5, 64
        coord = rng.uniform(-1 + 1e-6, 1 - 1e-6, (b, q, 2)).astype(
            np.float32)
    else:
        b, h, w, c = 2, 8, 16, 5
        coord = np.stack([_tie_coords(h, w)] * b)
        coord[1] = coord[1, ::-1]
        # the sources are exact half-pixels, and some lie off the map
        ix = ((coord[..., 1] + 1.0) * w - 1.0) / 2.0
        assert np.all(ix == np.floor(ix) + 0.5)
        assert (np.abs(coord) > 1).any() and (np.abs(coord) == 1).any()
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    got = grid_sample_nearest(torch.from_numpy(feat),
                              torch.from_numpy(coord)).numpy()
    assert got.shape == (b, coord.shape[1], c)
    np.testing.assert_array_equal(
        got, np.asarray(jax_grid_sample_nearest(jnp.asarray(feat),
                                                jnp.asarray(coord))))
    np.testing.assert_array_equal(got, _torch_nearest(feat, coord))
    if case != "jax_test":
        assert (got == 0).all(-1).any()      # zeros off the map


# -------------------------------------------------------------- resize ---

@pytest.mark.parametrize("in_hw,scale", [
    ((24, 17), 0.5), ((24, 17), 0.25), ((12, 9), 2.0),
    ((20, 20), 1 / 3), ((16, 16), 0.4371), ((7, 11), 3.3)])
def test_imresize_torch_matches_jax_and_numpy(in_hw, scale):
    rng = np.random.default_rng(3)
    imgs = rng.random((2, *in_hw, 3)).astype(np.float32)
    size = (math.ceil(in_hw[0] * scale), math.ceil(in_hw[1] * scale))
    batched = imresize_torch(torch.from_numpy(imgs), size, scale)
    assert batched.shape == (2, *size, 3)
    assert batched.dtype == torch.float32
    np.testing.assert_allclose(
        batched.numpy(),
        np.asarray(imresize_jnp(jnp.asarray(imgs), size, scale)),
        rtol=0, atol=1e-5)
    for i in range(2):
        one = imresize_torch(torch.from_numpy(imgs[i]), size, scale)
        np.testing.assert_allclose(one.numpy(), batched[i].numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(one.numpy(),
                                   imresize_np(imgs[i], scale=scale),
                                   rtol=0, atol=1e-4)


# ---------------------------------------------------------- registries ---

def _import_all(package: str) -> None:
    """Import every module of ``package`` but its command-line tools, so
    that each registration has run."""
    pkg = importlib.import_module(package)
    for mod in pkgutil.walk_packages(pkg.__path__, package + "."):
        if ".tools" not in mod.name:
            importlib.import_module(mod.name)


@pytest.fixture(scope="module")
def both_packages():
    _import_all("ciaosr_tpu")
    _import_all("ciaosr_torch")


def _names(registry, package: str) -> set:
    """The names ``package`` registers (a test may register its own)."""
    return {k for k, v in registry._registry.items()
            if v.__module__.startswith(package + ".")}


@pytest.mark.parametrize("name", REGISTRIES)
def test_registry_names_equal_jax(both_packages, name):
    port = getattr(port_registry, name)
    assert set(port._registry) == _names(port, "ciaosr_torch")
    assert _names(port, "ciaosr_torch") == _names(
        getattr(jax_registry, name), "ciaosr_tpu"), name


# ------------------------------------------------- encoders and loading ---

@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p)[:24] for p in CONFIGS])
def test_generator_configs_build_encoders_from_backbones(path):
    gen = dict(Config.fromfile(path).model["generator"])
    assert gen["type"].startswith("LocalImplicitSR")
    assert not _fixed_scale(gen)
    with torch.device("meta"):
        net = make_generator(gen)
        enc_cfg = dict(gen["encoder"])
        enc_cls = BACKBONES.get(enc_cfg.pop("type"))
        if "window_size" in gen:
            enc_cfg.setdefault("window_size", gen["window_size"])
        direct = enc_cls(**enc_cfg)
    assert type(net.encoder) is enc_cls
    # the generator's state_dict holds the trunk's keys unprefixed
    shapes = generator_shapes(gen)
    want = {k: tuple(v.shape) for k, v in direct.state_dict().items()}
    assert {k: shapes.get(k) for k in want} == want


@pytest.mark.parametrize("gtype,fixed", [
    ("EDSRNet", True), ("RDNNet", True), ("RDN", False), ("EDSR", False),
    ("SwinIR", False), ("LocalImplicitSRRDN", False)])
def test_fixed_scale_rule(gtype, fixed):
    assert _fixed_scale({"type": gtype}) is fixed
    if gtype in ("RDN", "EDSR", "SwinIR"):
        # a trunk is a backbone, not a generator of its own
        assert gtype in BACKBONES
        with pytest.raises(KeyError, match="unknown generator type"):
            make_generator({"type": gtype})
