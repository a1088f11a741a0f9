"""The port's ``CiaoSRRestorer`` built from each shipped 001 config's
``model`` dict, as the JAX package's ``build_model`` builds its own: the
same ``pixel_loss``, ``train_cfg`` and ``test_cfg`` stored in both, and a
generator of the config's widths (feature and CSA channels, the unfold,
the imnet dims). On the CPU, at the configs' full widths and depths.
"""

import glob
import os

import pytest
import torch

from ciaosr_torch.models.restorers import CiaoSRRestorer
from ciaosr_tpu.config.config import Config
from ciaosr_tpu.models.builder import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {name: glob.glob(os.path.join(
    ROOT, "configs", f"001_localimplicitsr_{name}_*.py"))[0]
    for name in ("rdn", "edsr", "swinir")}


def _plain(x):
    """A config value as plain dicts, lists and scalars."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("name", sorted(CONFIGS))
@torch.no_grad()
def test_restorer_takes_config_model(name):
    cfg = Config.fromfile(CONFIGS[name])
    model = _plain(cfg.model)
    assert model.pop("type") == "CiaoSR"
    assert set(model) == {"generator", "pixel_loss", "rgb_mean", "rgb_std"}
    port = CiaoSRRestorer(**model, train_cfg=cfg.train_cfg,
                          test_cfg=cfg.test_cfg, device="cpu")
    ref = build_model(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert _plain(port.pixel_loss_cfg) == _plain(ref.pixel_loss_cfg) \
        == model["pixel_loss"]
    assert port.train_cfg == ref.train_cfg == cfg.train_cfg
    assert _plain(port.test_cfg) == _plain(ref.test_cfg) \
        == _plain(cfg.test_cfg)

    gen, enc = model["generator"], model["generator"]["encoder"]
    c = enc.get("mid_channels", enc.get("embed_dim"))
    net, jnet = port.generator, ref.generator
    assert jnet.feat_dim == c and jnet.feat_unfold == gen["feat_unfold"]
    assert net.feat_unfold == gen["feat_unfold"]
    taps = 9 if gen["feat_unfold"] else 1
    csa = net.cs_attn
    assert csa.conv_assembly[0].out_channels == c
    assert csa.conv_match_1[0].out_channels == c // 2
    dv = taps * c + c * len(jnet.multi_scale)
    for mlp, key, dims in ((net.imnet_k, "imnet_k", (taps * c + 4,
                                                      taps * c)),
                           (net.imnet_v, "imnet_v", (dv + 4, dv)),
                           (net.imnet_q, "imnet_q", (dv, 3))):
        lin = mlp.linears
        assert (lin[0].in_features, lin[-1].out_features) == dims
        assert [m.out_features for m in lin[:-1]] == \
            gen[key]["hidden_list"]
