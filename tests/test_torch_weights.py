"""Port weight layout: state_dict_from_jax inverts convert_generator
bit-exactly, and the port package stays free of JAX.

Also the helpers the other ``test_torch_*`` files import: the small and
flagship configs, seeded JAX params, the JAX per-query oracle, and the cap
on torch's CPU threads (below).
"""

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


def cap_torch_threads(n: int = 2) -> None:
    """Keep torch's CPU pools small: every test worker imports every test
    file, so each one holds JAX's CPU runtime (8 virtual devices) and
    torch side by side, and torch's default of one spinning intra-op
    thread per core of the host, in each worker, oversubscribes a shared
    host many times over."""
    if torch.get_num_threads() > n:
        torch.set_num_threads(n)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:   # set already, or inter-op work has started
        pass


cap_torch_threads()

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


# a small SwinIR-CiaoSR generator of the 002 kind: no CSA, window 8
SWIN_SMALL = dict(
    type="LocalImplicitSRSWINIR", window_size=8,
    encoder=dict(type="SwinIR", embed_dim=12, depths=(2, 2),
                 num_heads=(3, 3)),
    imnet_q=dict(type="MLPRefiner", out_dim=3, hidden_list=[32, 32]),
    imnet_k=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]),
    imnet_v=dict(type="MLPRefiner", out_dim=1, hidden_list=[32, 32]),
    non_local_attn=False)


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


_query_rgb = jax.jit(lambda net, p, f, x, co, ce, nl: net.apply(
    p, f, x, co, ce, nl, method="query_rgb"), static_argnums=0)


def jax_query_rgb(net, params, feat, x, coord, cell, nl):
    """The JAX per-query decoder (f32, no Pallas) as numpy: the oracle of
    the port's decoders."""
    return np.asarray(_query_rgb(net, params, feat, jnp.asarray(x),
                                 jnp.asarray(coord), jnp.asarray(cell), nl))


def _same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("cfg,feat_dim,n_hidden,encoder,nla",
                         [(SMALL, 16, 2, "rdn", True),
                          (FLAGSHIP, 64, 4, "rdn", True),
                          (SWIN_SMALL, 12, 2, "swinir", False)],
                         ids=["small", "flagship", "swinir"])
def test_state_dict_roundtrip(cfg, feat_dim, n_hidden, encoder, nla):
    _, params = generator_params(cfg, seed=n_hidden)
    sd = state_dict_from_jax(params, feat_dim=feat_dim, n_hidden=n_hidden,
                             encoder=encoder, non_local_attn=nla)
    back = convert_generator(sd, encoder=encoder, feat_dim=feat_dim,
                             n_hidden=n_hidden, non_local_attn=nla,
                             strict=True)
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
