"""Plain stage-1 ResNet-50: the feature extractor of upstream MaSS's
``--use-feature-matching`` (``mass/nn/applications/resnet_projection_layer.py``,
its ``pseudo_forward``: ImageNet normalisation, conv1 7x7/2, batch norm,
ReLU, max-pool 3x3/2, ``layer1``), written with ``torch.nn.functional``
on a torchvision-layout state dict.

Batch norm is in inference form (running statistics, eps 1e-5); a
bottleneck strides nowhere (``layer1`` keeps the pool's resolution) and
projects its shortcut in block 0 only.  Everything runs in float32, with
TF32 off unless ``tf32`` (the control's precision) asks for it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STRIDE = 4
CHANNELS = 256
BLOCKS = 3
WIDTH = 64


def _bn(x, sd, key):
    return F.batch_norm(x, sd[f"{key}.running_mean"],
                        sd[f"{key}.running_var"], sd[f"{key}.weight"],
                        sd[f"{key}.bias"], False, 0.0, 1e-5)


def _bottleneck(x, sd, pre):
    y = F.relu(_bn(F.conv2d(x, sd[f"{pre}.conv1.weight"]), sd, f"{pre}.bn1"))
    y = F.relu(_bn(F.conv2d(y, sd[f"{pre}.conv2.weight"], padding=1), sd,
                   f"{pre}.bn2"))
    y = _bn(F.conv2d(y, sd[f"{pre}.conv3.weight"]), sd, f"{pre}.bn3")
    if f"{pre}.downsample.0.weight" in sd:
        x = _bn(F.conv2d(x, sd[f"{pre}.downsample.0.weight"]), sd,
                f"{pre}.downsample.1")
    return F.relu(y + x)


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], rgb: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """``[B, h, w, 3]`` RGB in 0-1 -> ``[B, h/4, w/4, 256]`` features."""
    mean = torch.tensor(MEAN, device=rgb.device)
    std = torch.tensor(STD, device=rgb.device)
    x = ((rgb.to(torch.float32) - mean) / std).permute(0, 3, 1, 2)
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=tf32):
            x = F.conv2d(x.contiguous(), sd["conv1.weight"], stride=2,
                         padding=3)
            x = F.max_pool2d(F.relu(_bn(x, sd, "bn1")), 3, 2, 1)
            for b in range(BLOCKS):
                x = _bottleneck(x, sd, f"layer1.{b}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
    return x.permute(0, 2, 3, 1)


def flops(height: int, width: int) -> int:
    """Multiply-adds (two operations each) of the stage's convs on one
    ``height`` x ``width`` frame; batch norm, ReLU and the pool are left
    out (under 1%).  1.572 GFLOP at 224 x 224."""
    h2, w2 = -(-height // 2), -(-width // 2)
    h4, w4 = -(-h2 // 2), -(-w2 // 2)
    macs = h2 * w2 * WIDTH * 3 * 49
    cin = WIDTH
    for b in range(BLOCKS):
        macs += h4 * w4 * (cin * WIDTH + 9 * WIDTH * WIDTH
                           + WIDTH * CHANNELS)
        if b == 0:
            macs += h4 * w4 * cin * CHANNELS
        cin = CHANNELS
    return 2 * macs
