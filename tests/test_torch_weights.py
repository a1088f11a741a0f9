"""Port weight layout: state_dict_from_jax inverts convert_generator
bit-exactly, and the port package stays free of JAX."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import state_dict_from_jax
from ciaosr_torch.models.builder import build_generator
from ciaosr_tpu.convert.torch_weights import convert_generator
from ciaosr_tpu.models.builder import build_generator as jax_build

ROOT = Path(__file__).resolve().parents[1]

SMALL = dict(
    type="LocalImplicitSRRDN",
    encoder=dict(type="RDN", in_channels=3, mid_channels=16, num_blocks=2,
                 num_layers=3, channel_growth=8),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[32, 32]),
    imnet_k=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]),
    imnet_v=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]))

# __graft_entry__._flagship's generator (config 001 rdn)
FLAGSHIP = dict(
    type="LocalImplicitSRRDN",
    encoder=dict(type="RDN", in_channels=3, out_channels=3, mid_channels=64,
                 num_blocks=16, upscale_factor=4, num_layers=8,
                 channel_growth=64),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[256] * 4),
    imnet_k=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    imnet_v=dict(type="MLPRefiner", out_dim=64, hidden_list=[256] * 4),
    feat_unfold=True, eval_bsize=30000)


def seeded_params(module, seed, *args):
    """``module``'s param tree (jax.eval_shape: nothing compiles) filled
    from a seeded numpy generator at PyTorch's default init scale:
    kernels U(±1/√fan_in), biases U(±0.1), PReLU slopes 0.25."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "negative_slope" in name:
            return np.full(s.shape, 0.25, np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 \
            else 0.1
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def generator_params(cfg, seed):
    """(flax generator, seeded params) for a generator config."""
    net = jax_build(cfg)
    return net, seeded_params(net, seed, jnp.zeros((1, 8, 8, 3)),
                              jnp.zeros((1, 4, 2)), jnp.zeros((1, 4, 2)))


def _same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("cfg,feat_dim,n_hidden",
                         [(SMALL, 16, 2), (FLAGSHIP, 64, 4)],
                         ids=["small", "flagship"])
def test_state_dict_roundtrip(cfg, feat_dim, n_hidden):
    _, params = generator_params(cfg, seed=n_hidden)
    sd = state_dict_from_jax(params, feat_dim=feat_dim, n_hidden=n_hidden)
    back = convert_generator(sd, encoder="rdn", feat_dim=feat_dim,
                             n_hidden=n_hidden, strict=True)
    _same_tree(back, params)
    # the port's own modules take the same keys and shapes
    net = build_generator(cfg, device="cpu")
    net.load_state_dict(sd, strict=True)
    assert set(net.state_dict()) == set(sd)


def test_port_import_leaves_jax_out():
    code = ("import sys, ciaosr_torch.models.restorers, "
            "ciaosr_torch.convert.from_jax\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ciaosr_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|ciaosr_tpu)\b",
                     re.M)
    files = sorted((ROOT / "ciaosr_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
