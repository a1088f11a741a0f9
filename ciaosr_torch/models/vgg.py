"""VGG19 feature extractor for the perceptual loss, NCHW, on cuDNN convs.

Counterpart of ciaosr_tpu/models/vgg.py: torchvision's ``vgg19.features``
layers, numbered as its Sequential numbers them ([conv, ReLU] × 2, pool,
× 2, pool, [conv, ReLU] × 4, pool, × 3), built up to the deepest tap
only. Tap k is the output of layer k, so the 002 config's taps 2, 7, 16,
25 and 34 are conv outputs BEFORE their ReLU (the JAX module's loop does
this; its docstring's "after relu1_2" does not). The input is normalized
with the ImageNet mean and std first. The state_dict is torchvision's
(``features.N.weight`` / ``.bias``), so a torchvision ``vgg19`` file
loads as it is (``load_torchvision_``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

# Sequential indices of vgg19.features' convs and their widths
VGG19_CONVS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
VGG19_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256,
                  512, 512, 512, 512, 512, 512, 512, 512)
VGG19_POOLS = (4, 9, 18, 27, 36)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg19_layers(last: int) -> list[nn.Module]:
    """vgg19.features' layers 0..last."""
    layers: list[nn.Module] = []
    cin, conv = 3, 0
    for idx in range(last + 1):
        if idx in VGG19_POOLS:
            layers.append(nn.MaxPool2d(2, 2))
        elif idx in VGG19_CONVS:
            cout = VGG19_CHANNELS[conv]
            layers.append(nn.Conv2d(cin, cout, 3, padding=1))
            cin, conv = cout, conv + 1
        else:
            layers.append(nn.ReLU(inplace=False))
    return layers


class VGG19Features(nn.Module):
    """Runs vgg19.features up to max(layer_name_list); returns
    {index: output of that layer}, NCHW."""

    def __init__(self, layer_name_list: Sequence[int] = (2, 7, 16, 25, 34),
                 use_input_norm: bool = True):
        super().__init__()
        self.layer_name_list = tuple(int(k) for k in layer_name_list)
        self.use_input_norm = use_input_norm
        self.features = nn.Sequential(*vgg19_layers(max(self.layer_name_list)))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        taps = {}
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.layer_name_list:
                taps[idx] = x
        return taps

    def load_torchvision_(self, state_dict: dict) -> None:
        """Load a torchvision vgg19 (or vgg19.features) state_dict: its
        ``features.N`` keys, or the same keys without the prefix; the
        layers past the deepest tap and the classifier are left out."""
        if not any(k.startswith("features.") for k in state_dict):
            state_dict = {f"features.{k}": v for k, v in state_dict.items()}
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        if missing:
            raise KeyError(f"VGG19 weights lack {missing[:4]}")
        self.load_state_dict({k: state_dict[k] for k in own}, strict=True)

    @torch.no_grad()
    def init_synthetic_(self, seed: int = 7) -> None:
        """Seeded random weights (He-normal kernels, zero biases) from a
        generator seeded with ``seed``: feature magnitudes hold through the
        ReLUs, as trained ones roughly do."""
        g = torch.Generator().manual_seed(seed)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / fan_in) ** 0.5)
                m.bias.zero_()
