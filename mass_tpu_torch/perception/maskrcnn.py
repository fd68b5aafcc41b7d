"""Mask R-CNN inference (port of ``mass_tpu.perception.maskrcnn``).

The reference's learned perception is a Detectron2
``mask_rcnn_R_50_FPN_3x`` fine-tuned to the 54-class THOR taxonomy
(reference: mass/thor/detectron_utils.py:6-33), whose instance masks are
fused into the per-pixel class image (segmentation_config.py:311-337).
This module is the JAX package's fixed-shape pipeline in PyTorch:

  * ResNet-50 (frozen batch norm, ``perception/resnet.ResNet50``) + FPN
    -> P2..P6, fp32 cuDNN with TF32 off and deterministic algorithms;
  * the RPN head on every level; per-level top-k (a stable descending
    sort: ``lax.top_k`` puts the lower index first among equal values,
    ``torch.topk`` promises no order), decode, clip, greedy NMS and a
    global top-k.  The five levels' NMS problems of every frame go to the
    hand-written kernel (``ops/detection.nms``) in one launch;
  * multilevel ROIAlign, the two-FC box head, class-specific decoding and
    one class-aware NMS launch (classes offset into islands);
  * the 4-conv mask head with its 2x2 deconv, mask pasting and
    binarisation.

Every function takes a batch of frames (``[B, H, W, 3]``; one frame
``[H, W, 3]`` works too), so the fleet's B frames are one forward.  No
step syncs with the host.  The module's parameter names are detectron2's,
so a ``model_final.pth`` loads with ``load_state_dict(strict=True)``; a
torchvision ``maskrcnn_resnet50_fpn`` state dict is re-keyed first
(:func:`state_dict_from_torchvision`).  Public methods keep the JAX
package's channels-last layout; convs run NCHW inside.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mass_tpu_torch import resolve_device
from mass_tpu_torch.ops.detection import _bilinear_pool, nms
from mass_tpu_torch.perception.resnet import (STAGE_WIDTHS, ResNet50,
                                              trunk_flops)
from mass_tpu_torch.perception.segmentation import Detections


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    """Static architecture and inference settings; the defaults are
    detectron2's COCO ``mask_rcnn_R_50_FPN_3x`` as the reference runs it
    (54 classes, a square SCREEN_SIZE input)."""

    num_classes: int = 54
    image_size: int = 224
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    pre_nms_topk: int = 500        # per FPN level
    post_nms_topk: int = 256       # proposals entering the box head
    rpn_nms_threshold: float = 0.7
    score_threshold: float = 0.05
    nms_threshold: float = 0.5
    max_detections: int = 64
    candidate_pool: int = 512      # scored (box, class) pairs before NMS
    # detectron2 preprocessing: 0-255 BGR, mean-subtract, unit std
    pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    bgr: bool = True
    pixel_scale: float = 255.0
    # detectron2's Caffe-style R50 strides the 1x1 bottleneck conv
    stride_in_1x1: bool = True

    def torchvision_style(self) -> "MaskRCNNConfig":
        """torchvision's ``maskrcnn_resnet50_fpn`` conventions: 0-1 RGB,
        ImageNet normalisation, the stride on the 3x3 conv."""
        return dataclasses.replace(
            self, pixel_mean=(0.485, 0.456, 0.406),
            pixel_std=(0.229, 0.224, 0.225), bgr=False,
            pixel_scale=1.0, stride_in_1x1=False)

    @property
    def strides(self) -> Tuple[int, ...]:
        return (4, 8, 16, 32, 64)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_ratios)


def _cudnn():
    return torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                      allow_tf32=False)


# ---------------------------------------------------------------------
# network modules (detectron2's names)
# ---------------------------------------------------------------------

class FPN(nn.Module):
    """``backbone``: the trunk (``bottom_up``) plus lateral 1x1 and output
    3x3 convs (``fpn_lateral{2-5}``, ``fpn_output{2-5}``): a normalised
    NCHW image -> ``[P2, P3, P4, P5, P6]`` NCHW."""

    def __init__(self, stride_in_1x1: bool = True, features: int = 256):
        super().__init__()
        self.bottom_up = ResNet50(stride_in_1x1)
        for i, width in enumerate(STAGE_WIDTHS):
            setattr(self, f"fpn_lateral{i + 2}",
                    nn.Conv2d(width * 4, features, 1))
            setattr(self, f"fpn_output{i + 2}",
                    nn.Conv2d(features, features, 3, padding=1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        c = self.bottom_up(x)
        laterals = [getattr(self, f"fpn_lateral{i + 2}")(ci)
                    for i, ci in enumerate(c)]
        tops = [laterals[-1]]
        for lat in laterals[-2::-1]:
            # to the lateral's own size: at a camera that is not a
            # multiple of 32 the stages are odd.  jax.image.resize's
            # "nearest" samples at half-pixel centres: nearest-exact
            up = F.interpolate(tops[-1], size=lat.shape[-2:],
                               mode="nearest-exact")
            tops.append(up + lat)
        tops = tops[::-1]
        outs = [getattr(self, f"fpn_output{i + 2}")(t)
                for i, t in enumerate(tops)]
        # P6: the stride-2 subsample of P5 (max_pool2d(p5, 1, 2))
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs


class RPNHead(nn.Module):
    """``proposal_generator.rpn_head``: a shared 3x3 conv, per-anchor
    objectness and box deltas."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor):
        """NCHW level -> (objectness ``[B, H, W, A]``, deltas
        ``[B, H, W, 4A]``), channels last as the JAX package's."""
        t = F.relu(self.conv(feat))
        return (self.objectness_logits(t).permute(0, 2, 3, 1),
                self.anchor_deltas(t).permute(0, 2, 3, 1))


class BoxHead(nn.Module):
    """``roi_heads.box_head``: two FCs over the flattened ``[256, 7, 7]``
    ROI features (channel-major, detectron2's flattening)."""

    def __init__(self, in_features: int = 256 * 7 * 7, hidden: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc2(F.relu(self.fc1(x.flatten(1)))))


class BoxPredictor(nn.Module):
    """``roi_heads.box_predictor``: the classifier (background LAST,
    detectron2's convention) and class-specific box deltas."""

    def __init__(self, num_classes: int, hidden: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.cls_score = nn.Linear(hidden, num_classes + 1)
        self.bbox_pred = nn.Linear(hidden, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return (self.cls_score(x),
                self.bbox_pred(x).view(x.shape[0], self.num_classes, 4))


class MaskHead(nn.Module):
    """``roi_heads.mask_head``: four 3x3 convs, the 2x2 stride-2 deconv
    (weight ``[cin, cout, 2, 2]``) and per-class 1x1 mask logits:
    ``[N, 256, 14, 14]`` -> ``[N, C, 28, 28]``."""

    def __init__(self, num_classes: int, channels: int = 256):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_fcn{i + 1}",
                    nn.Conv2d(channels, channels, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.predictor = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class MaskRCNN(nn.Module):
    """The network, with the stages the pipeline calls as methods.  Its
    state dict is detectron2's ``model`` dict (``backbone.*``,
    ``proposal_generator.rpn_head.*``, ``roi_heads.*``)."""

    def __init__(self, config: MaskRCNNConfig = MaskRCNNConfig()):
        super().__init__()
        self.config = config
        self.backbone = FPN(config.stride_in_1x1)
        self.proposal_generator = nn.Module()
        self.proposal_generator.rpn_head = RPNHead(
            num_anchors=config.num_anchors)
        self.roi_heads = nn.Module()
        self.roi_heads.box_head = BoxHead()
        self.roi_heads.box_predictor = BoxPredictor(config.num_classes)
        self.roi_heads.mask_head = MaskHead(config.num_classes)
        self.register_buffer("pixel_mean",
                             torch.tensor(config.pixel_mean), False)
        self.register_buffer("pixel_std", torch.tensor(config.pixel_std),
                             False)
        self.eval()

    def feature_maps(self, images: torch.Tensor) -> List[torch.Tensor]:
        """RGB ``[B, H, W, 3]`` in 0-1 -> ``[P2..P6]`` NCHW."""
        c = self.config
        x = images * c.pixel_scale
        if c.bgr:
            x = x.flip(-1)
        x = (x - self.pixel_mean) / self.pixel_std
        with _cudnn():
            return self.backbone(x.permute(0, 3, 1, 2).contiguous())

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """``MaskRCNN.features`` of the JAX package: ``[B, H, W, 3]`` ->
        ``[P2..P6]`` channels last."""
        return [f.permute(0, 2, 3, 1) for f in self.feature_maps(images)]

    def rpn(self, feat: torch.Tensor):
        """One channels-last level -> (objectness ``[B, H, W, A]``,
        deltas ``[B, H, W, 4A]``)."""
        with _cudnn():
            return self.proposal_generator.rpn_head(
                feat.permute(0, 3, 1, 2).contiguous())

    def box(self, rois: torch.Tensor):
        """``[N, 7, 7, 256]`` ROI features -> (logits ``[N, C + 1]``,
        deltas ``[N, C, 4]``)."""
        x = rois.permute(0, 3, 1, 2)
        return self.roi_heads.box_predictor(self.roi_heads.box_head(x))

    def mask_logits(self, rois: torch.Tensor) -> torch.Tensor:
        """``[N, 14, 14, 256]`` -> ``[N, C, 28, 28]`` (NCHW)."""
        with _cudnn():
            return self.roi_heads.mask_head(
                rois.permute(0, 3, 1, 2).contiguous())

    def masks(self, rois: torch.Tensor) -> torch.Tensor:
        """``[N, 14, 14, 256]`` -> ``[N, 28, 28, C]`` mask logits."""
        return self.mask_logits(rois).permute(0, 2, 3, 1)


def model_flops(config: MaskRCNNConfig, rois: int = None,
                slots: int = None) -> Dict[str, int]:
    """Operations (two per multiply-add) of one frame's convs and linears
    by stage: the trunk, the FPN, the RPN head, the box head over
    ``rois`` ROIs (the ``post_nms_topk`` proposals by default) and the
    mask head over ``slots`` ROIs (by default the ``max_detections``
    slots: every slot runs, valid or not)."""
    side = config.image_size
    rois = config.post_nms_topk if rois is None else rois
    slots = config.max_detections if slots is None else slots
    sides = [side]
    for _ in range(5):
        sides.append(-(-sides[-1] // 2))
    c_sides = sides[2:6]                          # C2..C5
    fpn = sum(s * s * (w * 4 * 256 + 9 * 256 * 256)
              for s, w in zip(c_sides, STAGE_WIDTHS))
    p_sides = c_sides + [-(-c_sides[-1] // 2)]
    rpn = sum(s * s * (9 * 256 * 256 + 256 * config.num_anchors * 5)
              for s in p_sides)
    box = rois * (256 * 49 * 1024 + 1024 * 1024
                  + 1024 * (config.num_classes * 5 + 1))
    mask = slots * (4 * 14 * 14 * 9 * 256 * 256 + 14 * 14 * 256 * 256 * 4
                    + 28 * 28 * 256 * config.num_classes)
    return dict(trunk=trunk_flops(side, side), fpn=2 * fpn, rpn=2 * rpn,
                box_head=2 * box, mask_head=2 * mask)


# ---------------------------------------------------------------------
# anchors and box coding
# ---------------------------------------------------------------------

def cell_anchors(size: float, ratios: Sequence[float]) -> np.ndarray:
    """Zero-centred anchors (x0, y0, x1, y1) for one level."""
    out = []
    for r in ratios:
        w = size / math.sqrt(r)
        h = size * math.sqrt(r)
        out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


def level_anchors(config: MaskRCNNConfig) -> List[np.ndarray]:
    """Per-level ``[H*W*A, 4]`` anchor grids for a square image, centres
    at ``index * stride``.  The grids are sized ``side // stride``, as the
    JAX package sizes them: at a camera that is not a multiple of 32 a
    level's feature map has more cells than anchors (48 px: P5 is 2x2,
    its anchors 1x1), and :func:`generate_proposals` clamps the index."""
    side = config.image_size
    sizes = [side // s for s in (4, 8, 16, 32)]
    sizes.append((sizes[-1] + 1) // 2)
    out = []
    for size, stride, hw in zip(config.anchor_sizes, config.strides,
                                sizes):
        base = cell_anchors(size, config.anchor_ratios)
        xs = np.arange(hw, dtype=np.float32) * stride
        sx, sy = np.meshgrid(xs, xs)
        shifts = np.stack([sx, sy, sx, sy], -1)
        anch = shifts[:, :, None, :] + base[None, None]
        out.append(anch.reshape(-1, 4))
    return out


_DW_CLAMP = math.log(1000.0 / 16)
BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to xyxy anchors."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    cxa = anchors[..., 0] + wa / 2
    cya = anchors[..., 1] + ha / 2
    dx = deltas[..., 0] / weights[0]
    dy = deltas[..., 1] / weights[1]
    dw = (deltas[..., 2] / weights[2]).clamp_max(_DW_CLAMP)
    dh = (deltas[..., 3] / weights[3]).clamp_max(_DW_CLAMP)
    cx = dx * wa + cxa
    cy = dy * ha + cya
    w = wa * torch.exp(dw)
    h = ha * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Inverse of :func:`decode_boxes` (training targets); widths and
    heights are floored at 1e-6."""
    floor = anchors.new_full((), 1e-6)
    wa = torch.maximum(anchors[..., 2] - anchors[..., 0], floor)
    ha = torch.maximum(anchors[..., 3] - anchors[..., 1], floor)
    cxa = anchors[..., 0] + wa / 2
    cya = anchors[..., 1] + ha / 2
    w = torch.maximum(boxes[..., 2] - boxes[..., 0], floor)
    h = torch.maximum(boxes[..., 3] - boxes[..., 1], floor)
    cx = boxes[..., 0] + w / 2
    cy = boxes[..., 1] + h / 2
    return torch.stack([weights[0] * (cx - cxa) / wa,
                        weights[1] * (cy - cya) / ha,
                        weights[2] * torch.log(w / wa),
                        weights[3] * torch.log(h / ha)], dim=-1)


def clip_boxes(boxes: torch.Tensor, size: float) -> torch.Tensor:
    return boxes.clamp(0.0, float(size))


def _top_k(values: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, the lower index
    first among equal values."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def _degenerate(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0] < 1e-3)
            | (boxes[..., 3] - boxes[..., 1] < 1e-3))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [B, n, ...]`` gathered at ``idx [B, k]`` -> ``[B, k, ...]``."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


# ---------------------------------------------------------------------
# the inference pipeline
# ---------------------------------------------------------------------

def generate_proposals(config: MaskRCNNConfig, rpn_outputs, anchors
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape RPN proposals: per-level top-k, decode, clip, NMS
    (all levels of all frames in one :func:`~mass_tpu_torch.ops.detection.nms`
    call, each level padded to the longest with -inf scores), then the
    global top-k.  ``rpn_outputs`` holds per level (objectness
    ``[(B,) H, W, A]``, deltas ``[(B,) H, W, 4A]``); ``anchors`` the
    levels' ``[n, 4]`` grids.  Returns ``(boxes [(B,) R, 4], scores
    [(B,) R])``, ``R = post_nms_topk``, -inf scores marking padding."""
    single = rpn_outputs[0][0].dim() == 3
    level_boxes, level_scores, counts = [], [], []
    for (obj, deltas), anch in zip(rpn_outputs, anchors):
        if single:
            obj, deltas = obj[None], deltas[None]
        B = obj.shape[0]
        n = anch.shape[0]
        obj = obj.reshape(B, -1)
        deltas = deltas.reshape(B, -1, 4)
        k = min(config.pre_nms_topk, n)
        scores, idx = _top_k(obj, k)
        # XLA clamps an index past the anchor table: do so explicitly
        boxes = decode_boxes(anch[idx.clamp_max(n - 1)], _take(deltas, idx))
        boxes = clip_boxes(boxes, config.image_size)
        scores = torch.where(_degenerate(boxes),
                             torch.full_like(scores, float("-inf")), scores)
        level_boxes.append(boxes)
        level_scores.append(scores)
        counts.append(min(k, config.post_nms_topk))
    width = max(s.shape[1] for s in level_scores)
    padded_boxes = torch.stack([F.pad(b, (0, 0, 0, width - b.shape[1]))
                                for b in level_boxes], 1)
    padded_scores = torch.stack(
        [F.pad(s, (0, width - s.shape[1]), value=float("-inf"))
         for s in level_scores], 1)
    B, L = padded_scores.shape[:2]
    keep = nms(padded_boxes.view(B * L, width, 4),
               padded_scores.view(B * L, width), config.rpn_nms_threshold,
               counts).view(B, L, -1).long()
    all_boxes, all_scores = [], []
    for lvl, m in enumerate(counts):
        kept = keep[:, lvl, :m]
        safe = kept.clamp_min(0)
        all_boxes.append(_take(level_boxes[lvl], safe))
        all_scores.append(torch.where(
            kept >= 0, torch.gather(level_scores[lvl], 1, safe),
            torch.full_like(safe, float("-inf"), dtype=torch.float32)))
    boxes = torch.cat(all_boxes, 1)
    scores = torch.cat(all_scores, 1)
    top, idx = _top_k(scores, config.post_nms_topk)
    boxes = _take(boxes, idx)
    return (boxes[0], top[0]) if single else (boxes, top)


def assign_levels(boxes: torch.Tensor) -> torch.Tensor:
    """Canonical FPN level (0 = P2 .. 3 = P5) per box."""
    zero = boxes.new_zeros(())
    area = (torch.maximum(boxes[..., 2] - boxes[..., 0], zero)
            * torch.maximum(boxes[..., 3] - boxes[..., 1], zero))
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8))
    return lvl.clamp(2, 5).to(torch.int64) - 2


def multilevel_roi_align(features: List[torch.Tensor], boxes: torch.Tensor,
                         output_size: int) -> torch.Tensor:
    """ROIAlign each box on its assigned level (P2..P5).  ``features``
    are channels-last ``[(B,) H, W, C]`` levels, ``boxes [(B,) N, 4]``;
    returns ``[(B,) N, S, S, C]``.  The JAX package pools every box on all
    four levels and keeps its own; this gathers from its own level only,
    which gives the same numbers."""
    single = boxes.dim() == 2
    if single:
        features = [f[None] for f in features]
        boxes = boxes[None]
    B, n = boxes.shape[:2]
    levels = features[:4]
    sizes = [B * f.shape[1] * f.shape[2] for f in levels]
    table = torch.cat([f.reshape(-1, f.shape[-1]) for f in levels])
    lvl = assign_levels(boxes)                              # [B, N]

    def per_box(values, dtype=torch.int64):
        # each box's entry of a per-level list, with no host-to-device copy
        out = torch.full_like(lvl, values[-1], dtype=dtype)
        for i in range(len(values) - 2, -1, -1):
            out = torch.where(lvl == i, values[i], out)
        return out
    heights = per_box([f.shape[1] for f in levels])
    widths = per_box([f.shape[2] for f in levels])
    bases = per_box([int(b) for b in np.cumsum([0] + sizes[:-1])])
    strides = per_box([4.0, 8.0, 16.0, 32.0], torch.float32)
    frame = torch.arange(B, device=boxes.device)[:, None]
    offset = bases + frame * heights * widths
    pooled = _bilinear_pool(
        table, offset.reshape(-1), heights.reshape(-1), widths.reshape(-1),
        (boxes / strides[..., None]).reshape(-1, 4), output_size, 2)
    pooled = pooled.view(B, n, *pooled.shape[1:])
    return pooled[0] if single else pooled


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """Resample ``[..., K, M, M]`` box-local masks into ``[..., K, H, W]``
    image space (bilinear, zero outside the box)."""
    lead = masks.shape[:-2]
    m = masks.shape[-1]
    masks = masks.reshape(-1, m, m)
    boxes = boxes.reshape(-1, 4)
    k = masks.shape[0]
    dev = masks.device
    x0, y0, x1, y1 = boxes.unbind(-1)
    eps = boxes.new_full((), 1e-3)
    bw = torch.maximum(x1 - x0, eps)
    bh = torch.maximum(y1 - y0, eps)
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    gx = (xs[None] - x0[:, None]) / bw[:, None] * m - 0.5      # [K, W]
    gy = (ys[None] - y0[:, None]) / bh[:, None] * m - 0.5      # [K, H]
    inside = (xs[None] >= x0[:, None]) & (xs[None] <= x1[:, None])
    inside_y = (ys[None] >= y0[:, None]) & (ys[None] <= y1[:, None])
    cgx = gx.clamp(0.0, m - 1.0)
    cgy = gy.clamp(0.0, m - 1.0)
    x0i = torch.floor(cgx).to(torch.int64)
    y0i = torch.floor(cgy).to(torch.int64)
    x1i = (x0i + 1).clamp_max(m - 1)
    y1i = (y0i + 1).clamp_max(m - 1)
    fx = (cgx - x0i)[:, None, :]
    fy = (cgy - y0i)[:, :, None]

    def at(yi, xi):
        rows = torch.gather(masks, 1, yi[:, :, None].expand(k, height, m))
        return torch.gather(rows, 2, xi[:, None, :].expand(k, height, width))

    out = ((1 - fy) * (1 - fx) * at(y0i, x0i) + (1 - fy) * fx * at(y0i, x1i)
           + fy * (1 - fx) * at(y1i, x0i) + fy * fx * at(y1i, x1i))
    out = out * inside_y[:, :, None] * inside[:, None, :]
    return out.view(*lead, height, width)


def box_candidates(config: MaskRCNNConfig, proposals: torch.Tensor,
                   pscores: torch.Tensor, logits: torch.Tensor,
                   deltas: torch.Tensor):
    """The box head's outputs (``logits [B, R, C + 1]``, ``deltas
    [B, R, C, 4]``) on the proposals -> the ``candidate_pool`` best
    (box, class) pairs: ``(boxes [B, P, 4], scores [B, P], classes
    [B, P])``, -inf scores below ``score_threshold`` or on degenerate
    boxes.  A proposal that was padding (score -inf) detects nothing."""
    c = config
    probs = torch.softmax(logits, dim=-1)[..., :c.num_classes]  # bg last
    probs = torch.where(torch.isfinite(pscores)[..., None], probs,
                        torch.zeros_like(probs))
    boxes_c = clip_boxes(decode_boxes(proposals[:, :, None, :], deltas,
                                      BOX_REG_WEIGHTS), c.image_size)
    B = probs.shape[0]
    flat_scores = probs.reshape(B, -1)
    pool = min(c.candidate_pool, flat_scores.shape[1])
    top, idx = _top_k(flat_scores, pool)
    cls = (idx % c.num_classes).to(torch.int32)
    cand = _take(boxes_c.reshape(B, -1, 4), idx)
    ninf = torch.full_like(top, float("-inf"))
    top = torch.where(top >= c.score_threshold, top, ninf)
    top = torch.where(_degenerate(cand), ninf, top)
    return cand, top, cls


def select_detections(config: MaskRCNNConfig, cand: torch.Tensor,
                      top: torch.Tensor, cls: torch.Tensor):
    """Class-aware NMS of the candidates (each class offset into its own
    coordinate island; one kernel launch for the batch) -> ``(boxes
    [B, K, 4], scores [B, K], classes [B, K])`` with ``K =
    max_detections``; empty slots score 0."""
    c = config
    offset = cls.to(torch.float32)[..., None] * float(c.image_size + 2.0)
    keep = nms(cand + offset, top, c.nms_threshold,
               c.max_detections).long()
    valid = keep >= 0
    safe = keep.clamp_min(0)
    scores = torch.where(valid, torch.gather(top, 1, safe),
                         torch.full_like(safe, float("-inf"),
                                         dtype=torch.float32))
    scores = torch.where(torch.isfinite(scores), scores,
                         torch.zeros_like(scores))
    return _take(cand, safe), scores, torch.gather(cls, 1, safe)


@torch.no_grad()
def detect(model: MaskRCNN, rgb: torch.Tensor, anchors, marks=None,
           with_probs: bool = False):
    """Full inference (``mass_tpu.perception.maskrcnn.detect``, batched):
    RGB ``[(B,) H, W, 3]`` in 0-1 -> Detections (``masks [(B,) K, H, W]``
    binary, ``classes``, ``scores [(B,) K]``).
    ``marks``, if given, is called with a stage name after each of the
    network, the proposals, the heads and the paste (``chip_smoke.py``
    times the stages with it).  ``with_probs`` also returns the pasted
    mask probabilities that were binarised at 0.5 (zero on empty slots),
    the deciding values of the margin rule that compares two runs."""
    c = model.config
    single = rgb.dim() == 3
    x = (rgb[None] if single else rgb).to(torch.float32)
    B = x.shape[0]
    mark = marks or (lambda name: None)
    maps = model.feature_maps(x)
    feats = [f.permute(0, 2, 3, 1).contiguous() for f in maps[:4]]
    with _cudnn():
        rpn_out = [model.proposal_generator.rpn_head(f) for f in maps]
    mark("network")
    proposals, pscores = generate_proposals(c, rpn_out, anchors)
    mark("proposals")

    R = proposals.shape[1]
    rois = multilevel_roi_align(feats, proposals, 7)
    logits, deltas = model.box(rois.reshape(B * R, 7, 7, -1))
    cand, top, cls = box_candidates(c, proposals, pscores,
                                    logits.view(B, R, -1),
                                    deltas.view(B, R, c.num_classes, 4))
    det_boxes, det_scores, det_cls = select_detections(c, cand, top, cls)
    K = det_boxes.shape[1]
    mrois = multilevel_roi_align(feats, det_boxes, 14)
    mask_logits = model.mask_logits(mrois.reshape(B * K, 14, 14, -1))
    sel = torch.gather(mask_logits, 1, det_cls.reshape(-1, 1, 1, 1).long()
                       .expand(-1, 1, *mask_logits.shape[-2:]))[:, 0]
    mask_probs = torch.sigmoid(sel).view(B, K, *sel.shape[-2:])
    mark("heads")
    full = paste_masks(mask_probs, det_boxes, c.image_size, c.image_size)
    binary = (full >= 0.5).to(torch.float32)
    live = (det_scores > 0)[..., None, None]
    binary = binary * live
    mark("paste")
    det = Detections(masks=binary, classes=det_cls, scores=det_scores)
    full = full * live
    if single:
        det = Detections(*(t[0] for t in det))
        full = full[0]
    return (det, full) if with_probs else det


def device_anchors(config: MaskRCNNConfig, device) -> List[torch.Tensor]:
    return [torch.from_numpy(a).to(device) for a in level_anchors(config)]


def make_detector(model: MaskRCNN, class_offset: int = 0):
    """``rgb -> Detections`` closure on the model's device (the
    SegmentationModel protocol): one frame ``[H, W, 3]`` or a batch.
    ``class_offset`` maps detector class ids into taxonomy ids (0 for
    reference-style 54-class checkpoints, 1 for datasets that skip the
    OccupiedSpace class)."""
    model.eval()
    device = next(model.parameters()).device
    anchors = device_anchors(model.config, device)

    def run(rgb) -> Detections:
        rgb = torch.as_tensor(rgb, dtype=torch.float32).to(device)
        det = detect(model, rgb, anchors)
        return det._replace(classes=det.classes + class_offset)

    run.model = model
    return run


# ---------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------

def _tv_trunk_key(key: str) -> str:
    """A torchvision ``backbone.body.*`` key in detectron2's names."""
    k = key.replace("backbone.body.", "backbone.bottom_up.")
    k = k.replace("bottom_up.conv1.", "bottom_up.stem.conv1.")
    k = k.replace("bottom_up.bn1.", "bottom_up.stem.conv1.norm.")
    for s in range(4):
        k = k.replace(f"bottom_up.layer{s + 1}.", f"bottom_up.res{s + 2}.")
    for i in (1, 2, 3):
        k = k.replace(f".bn{i}.", f".conv{i}.norm.")
    k = k.replace(".downsample.0.", ".shortcut.")
    return k.replace(".downsample.1.", ".shortcut.norm.")


def state_dict_from_torchvision(sd: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A torchvision ``maskrcnn_resnet50_fpn`` state dict in this
    module's (detectron2's) names: the classifier's background row moved
    from first to last, the background box-regression row dropped (as
    ``params_from_torchvision_maskrcnn`` does)."""
    out: Dict[str, torch.Tensor] = {}

    def first(*keys):
        for k in keys:
            if f"{k}.weight" in sd:
                return k
        raise KeyError(keys[0])

    def put(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = sd[f"{src}.bias"]

    for key, value in sd.items():
        if key.startswith("backbone.body.") and \
                not key.endswith("num_batches_tracked"):
            out[_tv_trunk_key(key)] = value
    for i in range(4):
        put(f"backbone.fpn_lateral{i + 2}",
            first(f"backbone.fpn.inner_blocks.{i}.0",
                  f"backbone.fpn.inner_blocks.{i}"))
        put(f"backbone.fpn_output{i + 2}",
            first(f"backbone.fpn.layer_blocks.{i}.0",
                  f"backbone.fpn.layer_blocks.{i}"))
    rpn = "proposal_generator.rpn_head"
    put(f"{rpn}.conv", first("rpn.head.conv.0.0", "rpn.head.conv"))
    put(f"{rpn}.objectness_logits", "rpn.head.cls_logits")
    put(f"{rpn}.anchor_deltas", "rpn.head.bbox_pred")
    put("roi_heads.box_head.fc1", "roi_heads.box_head.fc6")
    put("roi_heads.box_head.fc2", "roi_heads.box_head.fc7")
    for name in ("weight", "bias"):
        cls = sd[f"roi_heads.box_predictor.cls_score.{name}"]
        out[f"roi_heads.box_predictor.cls_score.{name}"] = torch.cat(
            [cls[1:], cls[:1]])
        reg = sd[f"roi_heads.box_predictor.bbox_pred.{name}"]
        out[f"roi_heads.box_predictor.bbox_pred.{name}"] = reg[4:]
    for i in range(4):
        put(f"roi_heads.mask_head.mask_fcn{i + 1}",
            first(f"roi_heads.mask_head.mask_fcn{i + 1}",
                  f"roi_heads.mask_head.{i}.0"))
    put("roi_heads.mask_head.deconv", "roi_heads.mask_predictor.conv5_mask")
    put("roi_heads.mask_head.predictor",
        "roi_heads.mask_predictor.mask_fcn_logits")
    return out


def num_classes_of(state_dict: Dict[str, torch.Tensor]) -> int:
    """The class count a detectron2-named state dict was trained with."""
    return int(state_dict["roi_heads.box_predictor.cls_score.weight"]
               .shape[0]) - 1


def load_torch_checkpoint(path: str,
                          config: MaskRCNNConfig = MaskRCNNConfig()):
    """Read a detectron2 ``model_final.pth`` (``{"model": sd, ...}``) or a
    torchvision Mask R-CNN state dict, the format told by its keys, and
    return ``(state_dict, config, class_offset)``: the state dict in this
    module's names, the config with the format's preprocessing and stride
    (torchvision's for a torchvision file) and the class offset the file
    records (``class_offset``, written by the export of a 53-class JAX
    detector; 0 when absent)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    offset = int(ckpt.get("class_offset", 0)) if isinstance(ckpt, dict) \
        else 0
    sd = ckpt.get("model", ckpt)
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    if any(k.startswith("backbone.bottom_up") for k in sd):
        return sd, config, offset
    return state_dict_from_torchvision(sd), config.torchvision_style(), offset


def from_state_dict(state_dict: Dict[str, torch.Tensor],
                    config: MaskRCNNConfig = MaskRCNNConfig(),
                    device=None) -> MaskRCNN:
    """A :class:`MaskRCNN` on ``device`` (``None`` means CUDA) holding a
    detectron2-named state dict, every entry matched
    (``load_state_dict(strict=True)``)."""
    model = MaskRCNN(config)
    model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval()


def load_detector(path: str, image_size: int, num_classes=None,
                  device=None):
    """``(detector fn, model)`` of a Mask R-CNN ``.pth`` at a square
    camera of ``image_size`` (the default caps); the class count comes
    from the file, and ``num_classes``, if given, must agree with it."""
    sd, cfg, offset = load_torch_checkpoint(
        path, MaskRCNNConfig(image_size=image_size))
    found = num_classes_of(sd)
    if num_classes is not None and num_classes != found:
        raise ValueError(f"{path} holds a {found}-class detector, not "
                         f"{num_classes}")
    cfg = dataclasses.replace(cfg, num_classes=found)
    model = from_state_dict(sd, cfg, device)
    return make_detector(model, class_offset=offset), model
