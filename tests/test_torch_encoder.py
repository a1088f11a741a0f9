"""Port RDN (dense-concat, NCHW convs) vs JAX RDNEncoder (slice-sum with
layer pairing), f32, same weights through state_dict_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciaosr_torch.convert.from_jax import rdn_state_dict_from_jax
from ciaosr_torch.models.rdn import RDN
from ciaosr_tpu.models.rdn import RDNEncoder
from tests.test_torch_weights import seeded_params


@pytest.mark.parametrize("num_layers", [3, 4])
def test_rdn_matches_jax(rng, num_layers):
    cfg = dict(in_channels=3, mid_channels=16, num_blocks=3,
               num_layers=num_layers, channel_growth=8)
    x = rng.random((2, 11, 13, 3), dtype=np.float32)
    enc = RDNEncoder(**cfg)
    params = seeded_params(enc, num_layers, jnp.asarray(x))
    ref = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(x)))
    sd = rdn_state_dict_from_jax(params["params"])
    net = RDN(**cfg)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
