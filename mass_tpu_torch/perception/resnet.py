"""ResNet-50 feature extractor, stem and stage 1 (port of
``mass_tpu.perception.resnet``).

The cross-phase instance matcher of ``--use-feature-matching`` pools
256-d embeddings from a ResNet-50 cut after its first bottleneck stage,
at 1/4 of the camera's resolution (reference:
mass/nn/applications/resnet_projection_layer.py:134-157, with ImageNet
preprocessing at :136-141).  Batch norm runs in inference mode with eps
1e-5, as flax's does, and the strides sit where torchvision puts them
(the 3x3 conv of a bottleneck strides, not the 1x1).

The module keeps torchvision's parameter names (``conv1.weight``,
``bn1.*``, ``layer1.{b}.conv{i}.weight``, ``layer1.{b}.bn{i}.*``,
``layer1.0.downsample.{0,1}.*``), so a torchvision resnet50 state dict
loads into it as it is.  On a card it runs float32 with TF32 off and
deterministic cuDNN algorithms, as the search policy's convs do.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from mass_tpu_torch import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4 channels), each with inference
    batch norm, plus the identity or a projected shortcut."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=1e-5)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, out, 1, stride=stride, bias=False),
            nn.BatchNorm2d(out, eps=1e-5)) if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet50Stage1(nn.Module):
    """conv1 7x7/2 -> bn -> relu -> 3x3/2 max-pool -> layer1 (three
    bottlenecks, 256 channels).  ``[B, h, w, 3]`` RGB in 0-1 ->
    ``[B, h/4, w/4, 256]`` (channels last at both ends, NCHW inside)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU()
        # implicit -inf padding, as the JAX package pads before its pool
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, project=True),
                                    Bottleneck(256, 64),
                                    Bottleneck(256, 64))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.eval()

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        x = ((rgb - self.mean) / self.std).permute(0, 3, 1, 2).contiguous()
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.layer1(x)
        return x.permute(0, 2, 3, 1)


def make_backbone(module: ResNet50Stage1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``[h, w, 3]`` in 0-1 -> ``[h/4, w/4, 256]`` feature function for
    ``FeatureMap``; a leading batch ``[B, h, w, 3]`` is kept (the fleet
    sends its B frames in one call)."""
    module.eval()

    @torch.no_grad()
    def backbone(rgb: torch.Tensor) -> torch.Tensor:
        rgb = rgb.to(torch.float32)
        if rgb.dim() == 3:
            return module(rgb[None])[0]
        return module(rgb)

    return backbone


def from_state_dict(state: Dict[str, torch.Tensor],
                    device=None) -> ResNet50Stage1:
    """A stage-1 module on ``device`` (``None`` means CUDA) holding
    ``state``'s stage-1 entries (a whole torchvision resnet50 state dict
    works too: the later stages' entries are ignored).  Every entry the
    module has must be present."""
    module = ResNet50Stage1()
    own = module.state_dict()
    missing = sorted(k for k in own if k not in state)
    if missing:
        raise ValueError(f"backbone state dict lacks {missing}")
    module.load_state_dict({k: state[k] for k in own})
    return module.to(resolve_device(device)).eval()


def load_backbone_checkpoint(path: str, device=None):
    """The stage-1 backbone of a ``.pth`` state dict (torchvision names)
    on ``device`` (``None`` means CUDA): ``(backbone fn, module)``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    module = from_state_dict(state, device)
    return make_backbone(module), module


def feature_flops(height: int, width: int) -> int:
    """Multiply-adds (two operations each) of the stage-1 convs on one
    ``height`` x ``width`` frame; batch norm, ReLU and the pool add under
    1%."""
    h2, w2 = -(-height // 2), -(-width // 2)
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    macs = h2 * w2 * 64 * 3 * 49
    per_block = [64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256,  # + proj
                 256 * 64 + 9 * 64 * 64 + 64 * 256,
                 256 * 64 + 9 * 64 * 64 + 64 * 256]
    macs += h4 * w4 * int(np.sum(per_block))
    return 2 * macs
