"""ResNet-50: the stage-1 feature extractor (port of
``mass_tpu.perception.resnet``) and the full trunk of the Mask R-CNN
(``mass_tpu.perception.maskrcnn.ResNet50``).

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

The full trunk (:class:`ResNet50`, C2..C5 with frozen batch norm) keeps
detectron2's names (``stem.conv1``, ``res{2-5}.{b}.conv{1-3}`` with their
``norm``, ``shortcut``) and strides the first 1x1 conv by default, so a
detectron2 ``model_final.pth`` loads into the Mask R-CNN as it is.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from mass_tpu_torch import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4 channels), each with inference batch norm,
    plus the identity or a projected shortcut.  The 3x3 conv strides
    (torchvision), or the first 1x1 under ``stride_in_1x1`` (detectron2's
    Caffe-style ResNets: the same weights, other numbers)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 project: bool = False, stride_in_1x1: bool = False):
        super().__init__()
        out = features * 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = nn.Conv2d(in_channels, features, 1, stride=s1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, stride=s3,
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


# ---------------------------------------------------------------------
# the full ResNet-50 trunk of the Mask R-CNN, in detectron2's names
# ---------------------------------------------------------------------

STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)


class FrozenBatchNorm2d(nn.Module):
    """Inference batch norm with fixed statistics (detectron2's
    ``FrozenBatchNorm2d``: buffers ``weight``, ``bias``, ``running_mean``,
    ``running_var``; eps 1e-5, as flax's ``BatchNorm``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            False, 0.0, 1e-5)


class ConvNorm(nn.Conv2d):
    """A bias-free conv followed by its frozen norm, held as the conv's
    ``norm`` child (detectron2's ``Conv2d`` layout: ``<name>.weight``,
    ``<name>.norm.*``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)
        self.norm = FrozenBatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BottleneckBlock(nn.Module):
    """:class:`Bottleneck` in detectron2's names (``conv{1,2,3}`` with
    their norms, ``shortcut``), striding the first 1x1 by default, as
    detectron2's Caffe-style R50 does."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 project: bool = False, stride_in_1x1: bool = True):
        super().__init__()
        out = features * 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(in_channels, features, 1, stride=s1)
        self.conv2 = ConvNorm(features, features, 3, stride=s3, padding=1)
        self.conv3 = ConvNorm(features, out, 1)
        self.shortcut = (ConvNorm(in_channels, out, 1, stride=stride)
                         if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        relu = torch.nn.functional.relu
        y = relu(self.conv1(x))
        y = relu(self.conv2(y))
        y = self.conv3(y)
        residual = x if self.shortcut is None else self.shortcut(x)
        return relu(y + residual)


class ResNet50(nn.Module):
    """The full ResNet-50 trunk with frozen batch norm: NCHW input (already
    normalised) -> ``[C2, C3, C4, C5]`` (NCHW, strides 4-32).  Names are
    detectron2's ``backbone.bottom_up``: ``stem.conv1``, ``res2``..``res5``.
    The stem's max-pool pads with -inf, as the JAX package does."""

    def __init__(self, stride_in_1x1: bool = True):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv1 = ConvNorm(3, 64, 7, stride=2, padding=3)
        cin = 64
        for stage, (blocks, width) in enumerate(zip(STAGE_BLOCKS,
                                                    STAGE_WIDTHS)):
            layers = []
            for b in range(blocks):
                layers.append(BottleneckBlock(
                    cin, width, stride=2 if (b == 0 and stage > 0) else 1,
                    project=b == 0, stride_in_1x1=stride_in_1x1))
                cin = width * 4
            setattr(self, f"res{stage + 2}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.nn.functional.relu(self.stem.conv1(x))
        x = torch.nn.functional.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage in range(4):
            x = getattr(self, f"res{stage + 2}")(x)
            outs.append(x)
        return outs


def trunk_flops(height: int, width: int) -> int:
    """Multiply-adds (two operations each) of the full trunk's convs on
    one ``height`` x ``width`` image (stride in the 1x1, detectron2's);
    norms, ReLUs and the pool are left out."""
    def down(n, s=2):
        return -(-n // s)
    h, w = down(height), down(width)
    macs = h * w * 64 * 3 * 49
    h, w = down(h), down(w)
    cin = 64
    for stage, (blocks, width_) in enumerate(zip(STAGE_BLOCKS,
                                                 STAGE_WIDTHS)):
        for b in range(blocks):
            if b == 0 and stage > 0:
                h, w = down(h), down(w)
            macs += h * w * (cin * width_ + 9 * width_ * width_
                             + width_ * width_ * 4)
            if b == 0:
                macs += h * w * cin * width_ * 4
            cin = width_ * 4
    return 2 * macs


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
