"""The per-pixel segmentation network and instances from its logits (port
of ``mass_tpu.perception.detector``).

The JAX package's compact learned leg is a small UNet trained directly on
per-pixel classes; its argmax is the class image the semantic map reads.
:func:`instances_from_logits` turns the logits into the
:class:`~mass_tpu_torch.perception.segmentation.Detections` contract
(connected regions, majority classes, mean-probability scores, greedy NMS
through ``ops/detection.nms``) for the mask-fusion sensor.

The module's names are the port's own (``blocks.{i}.conv1/norm1/conv2/
norm2``, ``head``); ``convert.unet_state_dict_from_jax`` carries the
flax parameters across.  Group norm is computed as flax computes it
(variance as E[x^2] - E[x]^2, clipped at 0, eps 1e-6); convs run fp32
with TF32 off and deterministic cuDNN.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mass_tpu_torch import resolve_device, taxonomy
from mass_tpu_torch.ops.components import extract_instances
from mass_tpu_torch.ops.detection import nms
from mass_tpu_torch.perception.segmentation import Detections
from mass_tpu_torch.utils.checkpoint import load_state_dict
from mass_tpu_torch.utils.training import flax_init_

WIDTHS = (32, 64, 128, 256)


class FlaxGroupNorm(nn.GroupNorm):
    """``flax.linen.GroupNorm`` on NCHW: per-group mean and E[x^2] -
    E[x]^2 variance, then ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` (``nn.GroupNorm``'s parameters, flax's arithmetic)."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-6):
        super().__init__(groups, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        groups = self.num_groups
        g = x.view(b, groups, c // groups, h, w)
        mean = g.mean(dim=(2, 3, 4), keepdim=True)
        mean2 = (g * g).mean(dim=(2, 3, 4), keepdim=True)
        var = (mean2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(
            1, groups, -1, 1, 1)
        y = (g - mean) * mul + self.bias.view(1, groups, -1, 1, 1)
        return y.view(b, c, h, w)


class ConvBlock(nn.Module):
    """Two bias-free 3x3 convs, each with group norm and ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, padding=1, bias=False)
        self.norm1 = FlaxGroupNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm2 = FlaxGroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(x)))


class SegmenterUNet(nn.Module):
    """Small UNet: RGB ``[B, H, W, 3]`` -> class logits ``[B, H, W, C]``
    (channels last at both ends; H and W divisible by 8)."""

    def __init__(self, num_classes: int = taxonomy.NUM_CLASSES,
                 widths: Sequence[int] = WIDTHS):
        super().__init__()
        blocks, cin = [], 3
        for w in widths:                          # down path and bottom
            blocks.append(ConvBlock(cin, w))
            cin = w
        for w in reversed(widths[:-1]):           # up path
            blocks.append(ConvBlock(cin + w, w))
            cin = w
        self.depth = len(widths) - 1
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Conv2d(cin, num_classes, 1)
        self.eval()

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        x = rgb.permute(0, 3, 1, 2).contiguous()
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            skips = []
            for i in range(self.depth):
                x = self.blocks[i](x)
                skips.append(x)
                x = F.max_pool2d(x, 2, 2)
            x = self.blocks[self.depth](x)
            for i, skip in enumerate(reversed(skips)):
                x = F.interpolate(x, scale_factor=2, mode="nearest-exact")
                x = self.blocks[self.depth + 1 + i](torch.cat([x, skip], 1))
            x = self.head(x)
        return x.permute(0, 2, 3, 1)


def init_segmenter(generator: torch.Generator,
                   num_classes: int = taxonomy.NUM_CLASSES) -> SegmenterUNet:
    """A freshly initialised UNet on the CPU, drawn from ``generator``
    with flax's defaults (the counterpart of the JAX package's
    ``init_segmenter``; the draws are torch's)."""
    return flax_init_(SegmenterUNet(num_classes), generator)


def from_state_dict(state_dict, device=None) -> SegmenterUNet:
    """A UNet on ``device`` (``None`` means CUDA) holding ``state_dict``
    (the port's names), its class count read from the head."""
    model = SegmenterUNet(num_classes=int(state_dict["head.weight"]
                                          .shape[0]))
    model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval()


def load_segmenter(path: str, device=None) -> SegmenterUNet:
    """The UNet of a ``.pth`` state dict in the port's names."""
    return from_state_dict(load_state_dict(path), device)


def make_segmentation_sensor(model: SegmenterUNet):
    """RGB observation -> ``[h, w, 1]`` int32 class image (host numpy):
    the argmax of the UNet's logits (the learned alternative to ground
    truth)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def sensor(observation) -> np.ndarray:
        rgb = torch.as_tensor(np.asarray(observation["rgb"], np.float32)
                              ).to(device)
        logits = model(rgb[None])[0]
        return torch.argmax(logits, -1).to(torch.int32)[..., None
                                                        ].cpu().numpy()

    return sensor


def instances_from_logits(logits: torch.Tensor, max_instances: int = 32,
                          score_threshold: float = 0.0,
                          iou_threshold: float = 0.9) -> Detections:
    """Instance detections from per-pixel class logits ``[H, W, C]``:
    connected foreground regions of the argmax become instances, each with
    its majority class, its mean probability of that class as the score
    and its tight box, deduplicated by greedy NMS."""
    probs = torch.softmax(logits, dim=-1)
    classes = torch.argmax(logits, dim=-1)
    inst = extract_instances(classes > 0, max_instances)
    masks = inst.masks.to(torch.float32)                     # [K, H, W]
    denom = masks.sum((1, 2)).clamp_min(1.0)
    onehot = F.one_hot(classes, logits.shape[-1]).to(torch.float32)
    counts = torch.einsum("khw,hwc->kc", masks, onehot)
    inst_cls = torch.argmax(counts[:, 1:], dim=-1) + 1
    conf = torch.gather(torch.einsum("khw,hwc->kc", masks, probs), 1,
                        inst_cls[:, None])[:, 0] / denom
    ninf = torch.full_like(conf, float("-inf"))
    scores = torch.where(inst.present & (conf >= score_threshold), conf,
                         ninf)
    x, y, w, h = inst.boxes.unbind(-1)
    boxes = torch.stack([x, y, x + w, y + h], -1).to(torch.float32)
    keep = nms(boxes[None], scores[None], iou_threshold, max_instances)[0]
    keep_mask = torch.zeros(max_instances + 1, dtype=torch.bool,
                            device=keep.device)
    keep_mask[torch.where(keep >= 0, keep.long(),
                          torch.full_like(keep.long(), max_instances))] = True
    keep_mask = keep_mask[:max_instances]
    scores = torch.where(keep_mask & torch.isfinite(scores), scores,
                         torch.zeros_like(scores))
    return Detections(masks=masks, classes=inst_cls.to(torch.int32),
                      scores=scores)
