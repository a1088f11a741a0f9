"""Seeded weights in the published checkpoints' names, made on the device.

Every tensor of the reference generator's state dict gets PyTorch's own
initial distribution for its module: Conv2d and Linear weights and biases
U(±1/√fan_in), PReLU slopes 0.25; inside a SwinIR trunk, Linear weights
and the relative-position bias tables N(0, 0.02²) cut at ±2, Linear
biases 0 and LayerNorms 1 / 0 (the published SwinIR init). One uniform
and one normal draw of the whole model's size, sliced; the same dict is
loaded into the program and into the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from srbench.reference.models import CiaoSR, SwinIR, fan_in_bound


def reference_on_meta(gen_cfg: dict) -> CiaoSR:
    with torch.device("meta"):
        return CiaoSR(gen_cfg)


def _kinds(model: nn.Module) -> dict:
    """state-dict name → (kind, scale): 'u' uniform ±scale, 'n' normal of
    std scale, 'c' the constant scale."""
    trunk = model.trunk
    swin = isinstance(trunk, SwinIR)
    in_trunk = {id(m) for m in trunk.modules()} if swin else set()
    kinds = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        swin_m = id(m) in in_trunk
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if swin_m and isinstance(m, nn.Linear):
                kinds[pre + "weight"] = ("n", 0.02)
                kinds[pre + "bias"] = ("c", 0.0)
            else:
                bound = fan_in_bound(m.weight)
                kinds[pre + "weight"] = ("u", bound)
                kinds[pre + "bias"] = ("u", bound)
        elif isinstance(m, nn.LayerNorm):
            kinds[pre + "weight"] = ("c", 1.0)
            kinds[pre + "bias"] = ("c", 0.0)
        elif isinstance(m, nn.PReLU):
            kinds[pre + "weight"] = ("c", 0.25)
        elif hasattr(m, "relative_position_bias_table"):
            kinds[pre + "relative_position_bias_table"] = ("n", 0.02)
    return kinds


@torch.no_grad()
def seeded_state_dict(gen_cfg: dict, seed: int, device) -> dict:
    """The generator's weights for ``seed``, float32 on ``device``."""
    model = reference_on_meta(gen_cfg)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    kinds = _kinds(model)
    missing = set(shapes) - set(kinds)
    if missing:
        raise KeyError(f"no initial distribution for {sorted(missing)}")
    total = sum(s.numel() for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    uni = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    nor = torch.randn(total, generator=g, device=device).clamp_(-100, 100)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = shape.numel()
        kind, scale = kinds[name]
        if kind == "u":
            t = uni[at:at + n] * scale
        elif kind == "n":
            t = (nor[at:at + n] * scale).clamp_(-2.0, 2.0)
        else:
            t = torch.full((n,), scale, device=device)
        out[name] = t.reshape(shape).clone()
        at += n
    return out
