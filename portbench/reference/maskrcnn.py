"""Plain Mask R-CNN R50-FPN inference (detectron2's
``mask_rcnn_R_50_FPN_3x`` as the grid-world agent runs it), written as
functions of a detectron2-named state dict, with a plain greedy NMS loop
on the host.

The pipeline: ResNet-50 with frozen batch norm (stride in the 1x1) and
FPN -> P2..P6; the RPN head on every level, the per-level top-k (ties to
the lower index), decode, clip, greedy NMS and the global top-k; ROIAlign
on each box's own level (aligned=False, two samples a bin); the two-FC
box head, class-specific decoding, the candidate pool and class-aware
NMS; the 4-conv mask head with its deconv, bilinear pasting and
binarisation at 0.5; the fusion into a class image (confident masks
summed per class, argmax per pixel, class 0 where nothing fired).

Convolutions run in fp32 through cuDNN's deterministic algorithms with
TF32 off, or with TF32 on for the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

BLOCKS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
DW_CLAMP = math.log(1000.0 / 16)


class Config(NamedTuple):
    image_size: int = 224
    num_classes: int = 54
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    pre_nms_topk: int = 500
    post_nms_topk: int = 256
    rpn_nms_threshold: float = 0.7
    score_threshold: float = 0.05
    nms_threshold: float = 0.5
    max_detections: int = 64
    candidate_pool: int = 512
    pixel_mean: tuple = (103.530, 116.280, 123.675)
    detection_threshold: float = 0.3


class Detections(NamedTuple):
    scores: torch.Tensor     # [B, K]
    classes: torch.Tensor    # [B, K]
    semantic: torch.Tensor   # [B, H, W] fused class image


# ------------------------------------------------------------- network

def _conv_norm(sd, key, x, stride=1, padding=0):
    x = F.conv2d(x, sd[f"{key}.weight"], None, stride, padding)
    return F.batch_norm(x, sd[f"{key}.norm.running_mean"],
                        sd[f"{key}.norm.running_var"],
                        sd[f"{key}.norm.weight"], sd[f"{key}.norm.bias"],
                        False, 0.0, 1e-5)


def _conv(sd, key, x, padding=0):
    return F.conv2d(x, sd[f"{key}.weight"], sd[f"{key}.bias"], 1, padding)


def trunk(sd, x) -> List[torch.Tensor]:
    pre = "backbone.bottom_up"
    x = F.relu(_conv_norm(sd, f"{pre}.stem.conv1", x, 2, 3))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for s, blocks in enumerate(BLOCKS):
        for b in range(blocks):
            key = f"{pre}.res{s + 2}.{b}"
            stride = 2 if (b == 0 and s > 0) else 1
            y = F.relu(_conv_norm(sd, f"{key}.conv1", x, stride))
            y = F.relu(_conv_norm(sd, f"{key}.conv2", y, 1, 1))
            y = _conv_norm(sd, f"{key}.conv3", y)
            res = (_conv_norm(sd, f"{key}.shortcut", x, stride) if b == 0
                   else x)
            x = F.relu(y + res)
        outs.append(x)
    return outs


def pyramid(sd, x) -> List[torch.Tensor]:
    c = trunk(sd, x)
    lat = [_conv(sd, f"backbone.fpn_lateral{i + 2}", ci)
           for i, ci in enumerate(c)]
    tops = [lat[-1]]
    for lt in lat[-2::-1]:
        up = F.interpolate(tops[-1], size=lt.shape[-2:],
                           mode="nearest-exact")
        tops.append(up + lt)
    tops = tops[::-1]
    outs = [_conv(sd, f"backbone.fpn_output{i + 2}", t, 1)
            for i, t in enumerate(tops)]
    outs.append(outs[-1][:, :, ::2, ::2])
    return outs


# --------------------------------------------------------------- boxes

def anchors(cfg: Config, device) -> List[torch.Tensor]:
    side = cfg.image_size
    sizes = [side // s for s in (4, 8, 16, 32)]
    sizes.append((sizes[-1] + 1) // 2)
    out = []
    for size, stride, hw in zip(cfg.anchor_sizes, (4, 8, 16, 32, 64),
                                sizes):
        base = []
        for r in cfg.anchor_ratios:
            w, h = size / math.sqrt(r), size * math.sqrt(r)
            base.append([-w / 2, -h / 2, w / 2, h / 2])
        base = np.asarray(base, np.float32)
        xs = np.arange(hw, dtype=np.float32) * stride
        sx, sy = np.meshgrid(xs, xs)
        shifts = np.stack([sx, sy, sx, sy], -1)
        grid = shifts[:, :, None, :] + base[None, None]
        out.append(torch.from_numpy(grid.reshape(-1, 4)).to(device))
    return out


def decode(anchor, deltas, weights=(1.0, 1.0, 1.0, 1.0)):
    wa = anchor[..., 2] - anchor[..., 0]
    ha = anchor[..., 3] - anchor[..., 1]
    cxa = anchor[..., 0] + wa / 2
    cya = anchor[..., 1] + ha / 2
    dx = deltas[..., 0] / weights[0]
    dy = deltas[..., 1] / weights[1]
    dw = (deltas[..., 2] / weights[2]).clamp_max(DW_CLAMP)
    dh = (deltas[..., 3] / weights[3]).clamp_max(DW_CLAMP)
    cx = dx * wa + cxa
    cy = dy * ha + cya
    w = wa * torch.exp(dw)
    h = ha * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _top_k(values, k):
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def _degenerate(boxes):
    return ((boxes[..., 2] - boxes[..., 0] < 1e-3)
            | (boxes[..., 3] - boxes[..., 1] < 1e-3))


def _take(x, idx):
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise float32 IoU of ``[N, 4]`` and ``[M, 4]`` boxes."""
    zero = np.float32(0)
    area_a = (np.maximum(a[:, 2] - a[:, 0], zero)
              * np.maximum(a[:, 3] - a[:, 1], zero))
    area_b = (np.maximum(b[:, 2] - b[:, 0], zero)
              * np.maximum(b[:, 3] - b[:, 1], zero))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, np.float32(1e-9))


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, threshold: float,
               count: int) -> np.ndarray:
    """The plain greedy loop: take the best live box (the lower index on
    ties), kill the live boxes whose IoU with it reaches the threshold,
    until ``count`` are taken or none is live; -1 fills the rest.
    ``-inf`` scores start dead."""
    keep = np.full(count, -1, np.int64)
    alive = scores > -np.inf
    overlap = iou(boxes, boxes) >= np.float32(threshold)
    taken = 0
    for i in np.argsort(-scores, kind="stable"):
        if taken == count:
            break
        if alive[i]:
            keep[taken] = i
            taken += 1
            alive &= ~overlap[i]
    return keep


def _nms_batch(boxes, scores, threshold, counts) -> torch.Tensor:
    """``[P, N, 4]`` and ``[P, N]`` problems on the host; problem p keeps
    ``counts[p % len(counts)]``."""
    b = boxes.detach().cpu().numpy()
    s = scores.detach().cpu().numpy()
    width = max(counts)
    out = np.full((s.shape[0], width), -1, np.int64)
    for p in range(s.shape[0]):
        m = counts[p % len(counts)]
        out[p, :m] = greedy_nms(b[p], s[p], threshold, m)
    return torch.from_numpy(out).to(boxes.device)


def proposals(cfg: Config, rpn, anchor_grids):
    level_boxes, level_scores, counts = [], [], []
    for (obj, deltas), anch in zip(rpn, anchor_grids):
        B, n = obj.shape[0], anch.shape[0]
        obj = obj.reshape(B, -1)
        deltas = deltas.reshape(B, -1, 4)
        k = min(cfg.pre_nms_topk, n)
        scores, idx = _top_k(obj, k)
        boxes = decode(anch[idx.clamp_max(n - 1)], _take(deltas, idx))
        boxes = boxes.clamp(0.0, float(cfg.image_size))
        scores = torch.where(_degenerate(boxes),
                             torch.full_like(scores, float("-inf")), scores)
        level_boxes.append(boxes)
        level_scores.append(scores)
        counts.append(min(k, cfg.post_nms_topk))
    width = max(s.shape[1] for s in level_scores)
    pb = torch.stack([F.pad(b, (0, 0, 0, width - b.shape[1]))
                      for b in level_boxes], 1)
    ps = torch.stack([F.pad(s, (0, width - s.shape[1]),
                            value=float("-inf")) for s in level_scores], 1)
    B, L = ps.shape[:2]
    keep = _nms_batch(pb.view(B * L, width, 4), ps.view(B * L, width),
                      cfg.rpn_nms_threshold, counts).view(B, L, -1)
    all_boxes, all_scores = [], []
    for lvl, m in enumerate(counts):
        kept = keep[:, lvl, :m]
        safe = kept.clamp_min(0)
        all_boxes.append(_take(level_boxes[lvl], safe))
        all_scores.append(torch.where(
            kept >= 0, torch.gather(level_scores[lvl], 1, safe),
            torch.full_like(safe, float("-inf"), dtype=torch.float32)))
    top, idx = _top_k(torch.cat(all_scores, 1), cfg.post_nms_topk)
    return _take(torch.cat(all_boxes, 1), idx), top


def _pool(table, offset, height, width, boxes, size: int, ratio: int):
    """ROIAlign of each box on its own ``height x width`` map of ``table``
    rows from ``offset``: ``size x size`` bins of ``ratio**2`` bilinear
    samples, coordinates clipped to the map."""
    n = boxes.shape[0]
    dev = boxes.device
    bw = (boxes[:, 2] - boxes[:, 0]) / size
    bh = (boxes[:, 3] - boxes[:, 1]) / size
    cell = torch.arange(size, dtype=torch.float32, device=dev)
    sub = (torch.arange(ratio, dtype=torch.float32, device=dev) + 0.5) / ratio
    grid = cell[None, :, None] + sub[None, None, :]
    gx = boxes[:, 0, None, None] + grid * bw[:, None, None]
    gy = boxes[:, 1, None, None] + grid * bh[:, None, None]
    hmax = (height.to(torch.float32) - 1.0)[:, None, None]
    wmax = (width.to(torch.float32) - 1.0)[:, None, None]
    zero = boxes.new_zeros(())
    y = torch.minimum(torch.maximum(gy - 0.5, zero), hmax)
    x = torch.minimum(torch.maximum(gx - 0.5, zero), wmax)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.minimum(y0 + 1, height[:, None, None] - 1)
    x1 = torch.minimum(x0 + 1, width[:, None, None] - 1)
    fy = (y - y0)[:, :, :, None, None, None]
    fx = (x - x0)[:, None, None, :, :, None]
    base = offset[:, None, None, None, None]
    w5 = width[:, None, None, None, None]

    def at(yi, xi):
        idx = base + yi[:, :, :, None, None] * w5 + xi[:, None, None, :, :]
        return table[idx.reshape(-1)].view(n, size, ratio, size, ratio, -1)

    samples = ((1 - fy) * (1 - fx) * at(y0, x0) + (1 - fy) * fx * at(y0, x1)
               + fy * (1 - fx) * at(y1, x0) + fy * fx * at(y1, x1))
    return samples.mean(dim=(2, 4))


def roi_align(levels, boxes, size: int):
    """Each box of ``[B, N, 4]`` pooled on its canonical FPN level of the
    channels-last ``levels`` (P2..P5) -> ``[B, N, S, S, C]``."""
    B, n = boxes.shape[:2]
    zero = boxes.new_zeros(())
    area = (torch.maximum(boxes[..., 2] - boxes[..., 0], zero)
            * torch.maximum(boxes[..., 3] - boxes[..., 1], zero))
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8))
    lvl = lvl.clamp(2, 5).to(torch.int64) - 2
    sizes = [B * f.shape[1] * f.shape[2] for f in levels]
    table = torch.cat([f.reshape(-1, f.shape[-1]) for f in levels])

    def per_box(values, dtype=torch.int64):
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
    pooled = _pool(table, offset.reshape(-1), heights.reshape(-1),
                   widths.reshape(-1),
                   (boxes / strides[..., None]).reshape(-1, 4), size, 2)
    return pooled.view(B, n, *pooled.shape[1:])


def paste(masks, boxes, height: int, width: int):
    """``[B, K, M, M]`` box masks bilinearly into ``[B, K, H, W]``, zero
    outside each box."""
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
    gx = (xs[None] - x0[:, None]) / bw[:, None] * m - 0.5
    gy = (ys[None] - y0[:, None]) / bh[:, None] * m - 0.5
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


# ----------------------------------------------------------- inference

@torch.no_grad()
def detect(sd: Dict[str, torch.Tensor], cfg: Config, rgb: torch.Tensor,
           tf32: bool = False) -> Detections:
    """RGB ``[B, H, W, 3]`` in 0-1 -> the detections and their fused class
    image.  ``tf32`` runs the convolutions and products in TF32 (the
    control)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=tf32):
            return _detect(sd, cfg, rgb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _detect(sd, cfg: Config, rgb) -> Detections:
    B = rgb.shape[0]
    C = cfg.num_classes
    x = (rgb.to(torch.float32) * 255.0).flip(-1)
    mean = torch.tensor(cfg.pixel_mean, device=rgb.device)
    x = (x - mean) / torch.ones(3, device=rgb.device)
    maps = pyramid(sd, x.permute(0, 3, 1, 2).contiguous())
    feats = [f.permute(0, 2, 3, 1).contiguous() for f in maps[:4]]
    rpn = "proposal_generator.rpn_head"
    heads = []
    for f in maps:
        t = F.relu(_conv(sd, f"{rpn}.conv", f, 1))
        heads.append((_conv(sd, f"{rpn}.objectness_logits", t)
                      .permute(0, 2, 3, 1),
                      _conv(sd, f"{rpn}.anchor_deltas", t)
                      .permute(0, 2, 3, 1)))
    boxes, pscores = proposals(cfg, heads, anchors(cfg, rgb.device))
    R = boxes.shape[1]

    rois = roi_align(feats, boxes, 7).reshape(B * R, 7, 7, -1)
    h = rois.permute(0, 3, 1, 2).flatten(1)
    h = F.relu(F.linear(h, sd["roi_heads.box_head.fc1.weight"],
                        sd["roi_heads.box_head.fc1.bias"]))
    h = F.relu(F.linear(h, sd["roi_heads.box_head.fc2.weight"],
                        sd["roi_heads.box_head.fc2.bias"]))
    logits = F.linear(h, sd["roi_heads.box_predictor.cls_score.weight"],
                      sd["roi_heads.box_predictor.cls_score.bias"])
    deltas = F.linear(h, sd["roi_heads.box_predictor.bbox_pred.weight"],
                      sd["roi_heads.box_predictor.bbox_pred.bias"])
    logits = logits.view(B, R, -1)
    deltas = deltas.view(B * R, C, 4).view(B, R, C, 4)

    probs = torch.softmax(logits, dim=-1)[..., :C]       # background last
    probs = torch.where(torch.isfinite(pscores)[..., None], probs,
                        torch.zeros_like(probs))
    boxes_c = decode(boxes[:, :, None, :], deltas, BOX_WEIGHTS).clamp(
        0.0, float(cfg.image_size))
    flat = probs.reshape(B, -1)
    pool = min(cfg.candidate_pool, flat.shape[1])
    top, idx = _top_k(flat, pool)
    cls = (idx % C).to(torch.int32)
    cand = _take(boxes_c.reshape(B, -1, 4), idx)
    ninf = torch.full_like(top, float("-inf"))
    top = torch.where(top >= cfg.score_threshold, top, ninf)
    top = torch.where(_degenerate(cand), ninf, top)

    offset = cls.to(torch.float32)[..., None] * float(cfg.image_size + 2.0)
    keep = _nms_batch(cand + offset, top, cfg.nms_threshold,
                      [cfg.max_detections])
    valid = keep >= 0
    safe = keep.clamp_min(0)
    scores = torch.where(valid, torch.gather(top, 1, safe),
                         torch.full_like(safe, float("-inf"),
                                         dtype=torch.float32))
    scores = torch.where(torch.isfinite(scores), scores,
                         torch.zeros_like(scores))
    det_boxes, det_cls = _take(cand, safe), torch.gather(cls, 1, safe)
    K = det_boxes.shape[1]

    mrois = roi_align(feats, det_boxes, 14).reshape(B * K, 14, 14, -1)
    m = mrois.permute(0, 3, 1, 2).contiguous()
    key = "roi_heads.mask_head"
    for i in range(4):
        m = F.relu(_conv(sd, f"{key}.mask_fcn{i + 1}", m, 1))
    m = F.relu(F.conv_transpose2d(m, sd[f"{key}.deconv.weight"],
                                  sd[f"{key}.deconv.bias"], stride=2))
    m = _conv(sd, f"{key}.predictor", m)
    sel = torch.gather(m, 1, det_cls.reshape(-1, 1, 1, 1).long()
                       .expand(-1, 1, *m.shape[-2:]))[:, 0]
    probs_m = torch.sigmoid(sel).view(B, K, *sel.shape[-2:])
    full = paste(probs_m, det_boxes, cfg.image_size, cfg.image_size)
    binary = (full >= 0.5).to(torch.float32) * (scores > 0)[..., None, None]

    confident = (scores >= cfg.detection_threshold).to(torch.float32)
    onehot = (det_cls[..., None].to(torch.int64) == torch.arange(
        C, device=rgb.device)).to(torch.float32)
    sums = torch.einsum("bkhw,bkc->bhwc", binary * confident[..., None, None],
                        onehot)
    semantic = torch.argmax(sums, dim=-1).to(torch.int32)
    return Detections(scores, det_cls, semantic)


def flops(cfg: Config) -> int:
    """Operations (two per multiply-add) of one frame's convolutions and
    products: trunk, FPN, RPN head, box head over the ``post_nms_topk``
    proposals and mask head over every ``max_detections`` slot."""
    side = cfg.image_size
    sides = [side]
    for _ in range(5):
        sides.append(-(-sides[-1] // 2))
    c_sides = sides[2:6]
    fpn = sum(s * s * (w * 4 * 256 + 9 * 256 * 256)
              for s, w in zip(c_sides, WIDTHS))
    p_sides = c_sides + [-(-c_sides[-1] // 2)]
    rpn = sum(s * s * (9 * 256 * 256 + 256 * len(cfg.anchor_ratios) * 5)
              for s in p_sides)
    box = cfg.post_nms_topk * (256 * 49 * 1024 + 1024 * 1024
                               + 1024 * (cfg.num_classes * 5 + 1))
    mask = cfg.max_detections * (4 * 14 * 14 * 9 * 256 * 256
                                 + 14 * 14 * 256 * 256 * 4
                                 + 28 * 28 * 256 * cfg.num_classes)
    return trunk_flops(side) + 2 * (fpn + rpn + box + mask)


def trunk_flops(side: int) -> int:
    """Operations of the trunk's convolutions on a ``side`` square image
    (norms, ReLUs and the pool left out)."""
    def down(n):
        return -(-n // 2)
    h = down(side)
    macs = h * h * 64 * 3 * 49
    h = down(h)
    cin = 64
    for s, (blocks, w) in enumerate(zip(BLOCKS, WIDTHS)):
        for b in range(blocks):
            if b == 0 and s > 0:
                h = down(h)
            macs += h * h * (cin * w + 9 * w * w + w * w * 4)
            if b == 0:
                macs += h * h * cin * w * 4
            cin = w * 4
    return 2 * macs
