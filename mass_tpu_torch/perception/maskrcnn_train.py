"""Mask R-CNN training (port of ``mass_tpu.perception.maskrcnn_train``).

The reference fine-tunes detectron2's COCO R50-FPN on the generated THOR
dataset (reference: train_maskrcnn.py:50-136).  The JAX package writes
the whole step (backbone, RPN, proposals, matching, sampling and the five
losses) as one jitted program of fixed shapes; this module keeps those
shapes and those numbers, on one device:

  * matching and sampling run without gradient (:func:`sample_targets`):
    the RPN's anchor labels (:func:`rpn_targets`), random-tiebreak top-k
    sampling (:func:`sample_eligible`) on ``jax.random``'s own stream
    (``search/prng``, keys batched as ``vmap`` would), the proposals of
    every frame's five levels in one greedy-NMS launch (``csrc/nms.cu``),
    the gt boxes appended, ROI sampling, box targets and the mask targets
    (each gt mask ROIAligned in its own box, one pooling call);
  * the five losses (:func:`image_losses`) pick rows and classes by
    one-hot products and take the cross-entropies against one-hot
    targets, so their backward holds no scatter; the ROIAlign's gather
    from the FPN maps sums its gradient through PyTorch's ``index_put_``,
    which on the card sorts the rows and adds duplicates in a fixed order;
  * the optimizer is optax's ``chain(clip_by_global_norm(10),
    sgd(piecewise_constant_schedule, momentum=0.9))`` written out
    (:class:`SGD`), and the frozen batch norms' scale and bias train, as
    flax's ``params`` do in JAX (their statistics stay fixed).

Forward and backward run under ``utils/training.exact_convs``
(deterministic cuDNN, no TF32): two runs from one seed on the card save
equal ``.pth`` files bit for bit.  ``{logdir}/maskrcnn.pth`` is
detectron2's ``{"model": state dict}`` with ``"class_offset": 1`` (the
dataset's category ids skip class 0), which ``--detector-checkpoint``
runs; ``{logdir}/maskrcnn-opt.pth`` holds the momentum by parameter name
and the schedule count.  ``train(devices=...)`` splits each batch over
the largest count of those devices that divides it, one replica a
device (``utils/training.Replicas``): each replica takes its frames' keys
of the batch's one-a-frame split, and makes its own NMS launch.  Unlike
the JAX package, which takes every device, one device is the default: a
replica step is not yet shown faster on several cards.

    python -m mass_tpu_torch.perception.maskrcnn_train --dataset d \\
        --epochs 2 --batch-size 4 --logdir /tmp/mrcnn
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mass_tpu_torch import resolve_device, taxonomy
from mass_tpu_torch.ops.detection import _bilinear_pool, box_iou
from mass_tpu_torch.perception import maskrcnn as M
from mass_tpu_torch.perception.resnet import FrozenBatchNorm2d
from mass_tpu_torch.search import prng
from mass_tpu_torch.utils.training import (Replicas, flax_init_,
                                           largest_divisor,
                                           lecun_normal_, truncated_normal_)

# the class offset the trainer's checkpoints record: the dataset's
# category ids are taxonomy classes minus one (tools/detector_dataset.py)
CLASS_OFFSET = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Matching and sampling settings (detectron2's defaults)."""

    max_gt: int = 16
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    rpn_pos_samples: int = 32
    rpn_neg_samples: int = 96
    roi_fg_iou: float = 0.5
    roi_fg_samples: int = 32
    roi_bg_samples: int = 96
    mask_size: int = 28


# ---------------------------------------------------------------------
# the network as JAX initialises it
# ---------------------------------------------------------------------

def train_norm_affines_(model: nn.Module) -> nn.Module:
    """Make every frozen batch norm's ``weight`` and ``bias`` parameters
    (in place, same names): flax keeps a ``BatchNorm``'s scale and bias in
    ``params``, which JAX's step trains, and only its statistics in the
    frozen ``batch_stats``.  Serving keeps them as buffers."""
    for module in model.modules():
        if isinstance(module, FrozenBatchNorm2d):
            for name in ("weight", "bias"):
                if name in module._buffers:
                    value = module._buffers.pop(name)
                    module.register_parameter(name, nn.Parameter(value))
    return model


def init_maskrcnn(generator: torch.Generator,
                  config: M.MaskRCNNConfig = M.MaskRCNNConfig()
                  ) -> M.MaskRCNN:
    """A trainable Mask R-CNN on the CPU drawn from flax's initialisers, as
    ``MaskRCNN.init`` draws the JAX package's: convs ``lecun_normal`` with
    zero biases, the RPN head N(0, 0.01), the box head's FCs
    ``lecun_normal``, the classifier N(0, 0.01) and the box regression
    N(0, 0.001), the deconv ``he_normal`` over flax's fan-in of a
    ``[256, 256, 2, 2]`` kernel (2 * 256 * 256), batch norms at identity."""
    model = flax_init_(M.MaskRCNN(config), generator)
    rpn = model.proposal_generator.rpn_head
    heads = model.roi_heads
    with torch.no_grad():
        for conv in (rpn.conv, rpn.objectness_logits, rpn.anchor_deltas):
            nn.init.normal_(conv.weight, 0.0, 0.01, generator=generator)
        for fc in (heads.box_head.fc1, heads.box_head.fc2):
            lecun_normal_(fc.weight, generator)
        nn.init.normal_(heads.box_predictor.cls_score.weight, 0.0, 0.01,
                        generator=generator)
        nn.init.normal_(heads.box_predictor.bbox_pred.weight, 0.0, 0.001,
                        generator=generator)
        deconv = heads.mask_head.deconv.weight
        fan_in = deconv.shape[-2] * deconv.shape[0] * deconv.shape[1]
        truncated_normal_(deconv, float(np.sqrt(2.0 / fan_in)), generator)
        for layer in (heads.box_head.fc1, heads.box_head.fc2,
                      heads.box_predictor.cls_score,
                      heads.box_predictor.bbox_pred, heads.mask_head.deconv):
            nn.init.zeros_(layer.bias)
    return train_norm_affines_(model)


def load_weights(model: M.MaskRCNN, path: str) -> int:
    """Load a detectron2-named ``.pth`` (the trainer's ``maskrcnn.pth`` or
    a ``model_final.pth``) into ``model``, every entry matched, and return
    the class offset it records; refused when its class count or its
    conventions differ from the model's."""
    sd, cfg, offset = M.load_torch_checkpoint(path, model.config)
    found, want = M.num_classes_of(sd), model.config.num_classes
    if found != want:
        raise ValueError(f"{path} holds a {found}-class detector; this run "
                         f"trains {want} classes")
    if cfg != model.config:
        raise ValueError(f"{path} is a torchvision Mask R-CNN; the trainer "
                         "trains detectron2's conventions")
    model.load_state_dict(sd, strict=True)
    return offset


# ---------------------------------------------------------------------
# matching and sampling
# ---------------------------------------------------------------------

def sample_eligible(eligible: torch.Tensor, k: int, key: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick up to ``k`` random indices where ``eligible [..., n]`` (one
    key ``[..., 2]`` a row), fixed shape: ``jax.random.uniform`` noise, 1
    added where eligible, the ``k`` largest in ``lax.top_k``'s order.
    Returns ``(idx [..., k], weight [..., k])``; a pick that is not
    eligible weighs 0."""
    noise = prng.uniform(key, eligible.shape[-1:])
    score = torch.where(eligible, 1.0 + noise, noise)
    _, idx = M._top_k(score, min(k, eligible.shape[-1]))
    return idx, torch.gather(eligible, -1, idx).to(torch.float32)


def _match(cfg: TrainConfig, anchors: torch.Tensor, gt_boxes: torch.Tensor,
           gt_valid: torch.Tensor):
    """(best IoU, its gt, positive, negative) per anchor."""
    iou = box_iou(anchors, gt_boxes)                        # [..., N, G]
    iou = torch.where(gt_valid[..., None, :], iou, torch.zeros_like(iou))
    best, best_gt = iou.amax(-1), iou.argmax(-1)
    pos = best >= cfg.rpn_pos_iou
    neg = best < cfg.rpn_neg_iou
    # low-quality matches: the highest-IoU anchor of each gt is positive
    anchor_per_gt = iou.argmax(-2)                          # [..., G]
    cells = torch.arange(anchors.shape[0], device=anchors.device)
    force = ((cells[:, None] == anchor_per_gt[..., None, :])
             & gt_valid[..., None, :]).any(-1)
    pos = pos | force
    return best, best_gt, pos, neg & ~pos


def rpn_targets(cfg: TrainConfig, anchors: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """Anchor labels and the matched gt per anchor (detectron2's matcher:
    IoU >= 0.7 positive, < 0.3 negative, the best anchor of each gt
    forced positive): ``(pos, neg, best_gt)``, each ``[..., N]`` for
    ``anchors [N, 4]`` and ``gt_boxes [..., G, 4]``."""
    _, best_gt, pos, neg = _match(cfg, anchors, gt_boxes, gt_valid)
    return pos, neg, best_gt


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    # beta -> 0: pure L1 (detectron2's default for the RPN and the boxes)
    return x.abs()


class Targets(NamedTuple):
    """One batch's sampled targets (no gradient), ``B`` frames:

    ``rpn_index [B, P + Q]`` the sampled anchors (P positives first),
    ``rpn_weight``/``rpn_label [B, P + Q]``, ``rpn_box [B, P, 4]`` the
    encoded boxes of the positives; ``roi_index [B, F + K]`` the sampled
    ROIs of the proposals with the gt boxes appended (F foreground
    first), ``roi_boxes [B, F + K, 4]``, ``roi_weight``, ``roi_label``
    (class, or ``num_classes`` for background), ``fg_class [B, F]``,
    ``box_target [B, F, 4]``, ``mask_crop [B, F, S, S]`` (each gt mask
    pooled in its box; the target is ``>= 0.5``).  The values that decide
    them ride along: ``anchor_iou [B, N]`` with the labels it gave
    ``anchor_label [B, N]`` (1 positive, 0 negative, -1 neither),
    ``proposals [B, R, 4]``, ``proposal_scores [B, R]`` and ``roi_iou
    [B, R + G]``."""

    rpn_index: torch.Tensor
    rpn_weight: torch.Tensor
    rpn_label: torch.Tensor
    rpn_box: torch.Tensor
    roi_index: torch.Tensor
    roi_boxes: torch.Tensor
    roi_weight: torch.Tensor
    roi_label: torch.Tensor
    fg_class: torch.Tensor
    box_target: torch.Tensor
    mask_crop: torch.Tensor
    anchor_iou: torch.Tensor
    anchor_label: torch.Tensor
    proposals: torch.Tensor
    proposal_scores: torch.Tensor
    roi_iou: torch.Tensor


def rpn_samples(tcfg: TrainConfig, anchors: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                key_pos: torch.Tensor, key_neg: torch.Tensor) -> Dict:
    """The RPN's sampled anchors of a batch (``gt_boxes [B, G, 4]``, keys
    ``[B, 2]``): the fields ``rpn_*`` and ``anchor_*`` of
    :class:`Targets`."""
    best, best_gt, pos, neg = _match(tcfg, anchors, gt_boxes, gt_valid)
    pi, pw = sample_eligible(pos, tcfg.rpn_pos_samples, key_pos)
    ni, nw = sample_eligible(neg, tcfg.rpn_neg_samples, key_neg)
    matched = M._take(gt_boxes, torch.gather(best_gt, 1, pi))
    return dict(rpn_index=torch.cat([pi, ni], 1),
                rpn_weight=torch.cat([pw, nw], 1),
                rpn_label=torch.cat([pw, torch.zeros_like(nw)], 1),
                rpn_box=M.encode_boxes(anchors[pi], matched),
                anchor_iou=best,
                anchor_label=pos.to(torch.int8) - (~pos & ~neg).to(
                    torch.int8))


def roi_samples(config: M.MaskRCNNConfig, tcfg: TrainConfig,
                proposals: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_masks: torch.Tensor,
                gt_valid: torch.Tensor, key: torch.Tensor) -> Dict:
    """The sampled ROIs of a batch's ``proposals [B, R, 4]`` with the gt
    boxes appended (detectron2 appends them, so the box head always sees
    true foreground): the fields ``roi_*``, ``fg_class``, ``box_target``
    and ``mask_crop`` of :class:`Targets`."""
    rois = torch.cat([proposals, gt_boxes.to(proposals.dtype)], 1)
    iou = box_iou(rois, gt_boxes)                           # [B, R+G, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
    best, roi_gt = iou.amax(-1), iou.argmax(-1)
    fg = best >= tcfg.roi_fg_iou
    fi, fw = sample_eligible(fg, tcfg.roi_fg_samples, key)
    bi, bw = sample_eligible(~fg, tcfg.roi_bg_samples, prng.fold_in(key, 1))
    fg_gt = torch.gather(roi_gt, 1, fi)                     # [B, F]
    fg_class = torch.gather(gt_classes.to(torch.int64), 1, fg_gt)
    background = torch.full_like(bi, config.num_classes)
    fg_boxes = M._take(rois, fi)
    # each gt mask ROIAligned in its own box: one pooling call over the
    # batch's masks, box i reading the [H, W] map of its own gt
    B, G, H, W = gt_masks.shape
    frame = torch.arange(B, device=fi.device)[:, None]
    n = fi.numel()
    size = torch.full((n,), H, dtype=torch.int64, device=fi.device)
    crop = _bilinear_pool(
        gt_masks.reshape(-1, 1), ((frame * G + fg_gt) * H * W).reshape(-1),
        size, torch.full_like(size, W), fg_boxes.reshape(-1, 4),
        tcfg.mask_size, 2)
    index = torch.cat([fi, bi], 1)
    return dict(
        roi_index=index, roi_boxes=M._take(rois, index),
        roi_weight=torch.cat([fw, bw], 1),
        roi_label=torch.cat([torch.where(fw > 0, fg_class,
                                         torch.full_like(fg_class,
                                                         config.num_classes)),
                             background], 1),
        fg_class=fg_class,
        box_target=M.encode_boxes(fg_boxes, M._take(gt_boxes, fg_gt),
                                  M.BOX_REG_WEIGHTS),
        mask_crop=crop.view(B, -1, tcfg.mask_size, tcfg.mask_size),
        roi_iou=best)


def network(model: M.MaskRCNN, images: torch.Tensor):
    """``[B, H, W, 3]`` RGB in 0-1 -> (``[P2..P6]`` NCHW, the RPN's
    (objectness ``[B, H, W, A]``, deltas ``[B, H, W, 4A]``) per level)."""
    maps = model.feature_maps(images)
    with M._cudnn():
        rpn = [model.proposal_generator.rpn_head(f) for f in maps]
    return maps, rpn


@torch.no_grad()
def sample_targets(config: M.MaskRCNNConfig, tcfg: TrainConfig,
                   anchors: List[torch.Tensor], rpn_out, gt_boxes,
                   gt_classes, gt_masks, gt_valid,
                   keys: torch.Tensor) -> Targets:
    """Every frame's targets (``keys [B, 2]``, one a frame, split in three
    as the JAX package splits each frame's key: anchor positives, anchor
    negatives, ROIs).  The proposals of all frames and levels go to one
    NMS launch."""
    sub = prng.split(keys, 3)
    rpn = rpn_samples(tcfg, torch.cat(anchors), gt_boxes, gt_valid,
                      sub[:, 0], sub[:, 1])
    proposals, scores = M.generate_proposals(
        config, [(o.detach(), d.detach()) for o, d in rpn_out], anchors)
    roi = roi_samples(config, tcfg, proposals, gt_boxes, gt_classes,
                      gt_masks, gt_valid, sub[:, 2])
    return Targets(proposals=proposals, proposal_scores=scores, **rpn,
                   **roi)


# ---------------------------------------------------------------------
# the five losses
# ---------------------------------------------------------------------

def _onehot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (index[..., None] == torch.arange(n, device=index.device)).to(
        dtype)


def _select(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values [B, N, ...]`` at ``index [B, K]`` -> ``[B, K, ...]``, as a
    one-hot product: the value itself forward (the other terms are exact
    zeros), and a backward that sums in a fixed order, no scatter."""
    onehot = _onehot(index, values.shape[1], values.dtype)
    return torch.einsum("bkn,bn...->bk...", onehot, values)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def image_losses(model: M.MaskRCNN, tcfg: TrainConfig, maps, rpn_out,
                 targets: Targets) -> Dict[str, torch.Tensor]:
    """The five losses of each frame (``[B]`` each): the RPN's objectness
    and boxes over the sampled anchors, the classifier, the boxes and the
    masks over the sampled ROIs."""
    c = model.config
    B = maps[0].shape[0]
    t = targets
    P = t.rpn_box.shape[1]

    obj = torch.cat([o.reshape(B, -1) for o, _ in rpn_out], 1)
    deltas = torch.cat([d.reshape(B, -1, 4) for _, d in rpn_out], 1)
    denom = t.rpn_weight.sum(1).clamp_min(1.0)
    bce = _sigmoid_bce(_select(obj, t.rpn_index), t.rpn_label)
    rpn_obj = (bce * t.rpn_weight).sum(1) / denom
    pw = t.rpn_weight[:, :P]
    rpn_box = (smooth_l1(_select(deltas, t.rpn_index[:, :P]) - t.rpn_box)
               .sum(-1) * pw).sum(1) / denom

    feats = [m.permute(0, 2, 3, 1) for m in maps[:4]]
    n = t.roi_boxes.shape[1]
    rois7 = M.multilevel_roi_align(feats, t.roi_boxes, 7)
    logits, box_deltas = model.box(rois7.reshape(B * n, *rois7.shape[2:]))
    logits = logits.view(B, n, -1)
    box_deltas = box_deltas.view(B, n, c.num_classes, 4)
    ce = -(_onehot(t.roi_label, c.num_classes + 1, logits.dtype)
           * torch.log_softmax(logits, -1)).sum(-1)
    n_sampled = t.roi_weight.sum(1).clamp_min(1.0)
    cls = (ce * t.roi_weight).sum(1) / n_sampled

    Fg = t.fg_class.shape[1]
    fw = t.roi_weight[:, :Fg]
    pick = _onehot(t.fg_class, c.num_classes, logits.dtype)     # [B, F, C]
    fg_deltas = (box_deltas[:, :Fg] * pick[..., None]).sum(2)
    box = (smooth_l1(fg_deltas - t.box_target).sum(-1) * fw).sum(1) \
        / n_sampled

    rois14 = M.multilevel_roi_align(feats, t.roi_boxes[:, :Fg], 14)
    mask_logits = model.mask_logits(rois14.reshape(B * Fg,
                                                   *rois14.shape[2:]))
    mask_logits = mask_logits.view(B, Fg, c.num_classes,
                                   *mask_logits.shape[-2:])
    mask_pred = (mask_logits * pick[..., None, None]).sum(2)
    mask_tgt = (t.mask_crop >= 0.5).to(mask_pred.dtype)
    mbce = _sigmoid_bce(mask_pred, mask_tgt).mean((-2, -1))
    mask = (mbce * fw).sum(1) / fw.sum(1).clamp_min(1.0)
    return dict(rpn_obj=rpn_obj, rpn_box=rpn_box, cls=cls, box=box,
                mask=mask)


def batch_loss(model: M.MaskRCNN, tcfg: TrainConfig,
               anchors: List[torch.Tensor], images, gt_boxes, gt_classes,
               gt_masks, gt_valid, key: torch.Tensor):
    """The mean over the batch of each of the five losses, and ``total``
    their sum; ``key`` is split into one key a frame, as the JAX package
    splits it.  Returns ``(losses, targets)``."""
    return frame_losses(model, tcfg, anchors, images, gt_boxes, gt_classes,
                        gt_masks, gt_valid, prng.split(key, images.shape[0]))


def frame_losses(model: M.MaskRCNN, tcfg: TrainConfig,
                 anchors: List[torch.Tensor], images, gt_boxes, gt_classes,
                 gt_masks, gt_valid, keys: torch.Tensor):
    """:func:`batch_loss` given each frame's key (``keys [B, 2]``): a
    data-parallel replica's share of the batch and of its keys."""
    maps, rpn_out = network(model, images)
    targets = sample_targets(model.config, tcfg, anchors, rpn_out, gt_boxes,
                             gt_classes, gt_masks, gt_valid, keys)
    losses = {k: v.mean() for k, v in image_losses(
        model, tcfg, maps, rpn_out, targets).items()}
    losses["total"] = sum(losses.values())
    return losses, targets


# ---------------------------------------------------------------------
# the optimizer and the step
# ---------------------------------------------------------------------

class SGD:
    """optax's ``chain(clip_by_global_norm(max_norm),
    sgd(piecewise_constant_schedule(learning_rate, boundaries),
    momentum))`` over named parameters, written out: the gradients scaled
    by ``max_norm / norm`` where their global norm reaches ``max_norm``
    (optax's ``(g / norm) * max_norm``; ``clip_grad_norm_`` adds 1e-6 to
    the norm), the trace ``g + momentum * trace``, the update ``trace *
    -lr(count)``.  The rate is optax's float32 value at the count before
    the step; the count and the trace are the state it saves."""

    def __init__(self, params, learning_rate: float, boundaries=None,
                 momentum: float = 0.9, max_norm: float = 10.0):
        self.params = dict(params)
        self.learning_rate = learning_rate
        self.boundaries = dict(sorted((boundaries or {}).items()))
        self.momentum = momentum
        self.max_norm = max_norm
        self.trace = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    def rate(self, count: int = None) -> float:
        """``piecewise_constant_schedule``'s value at ``count`` (this
        optimizer's own by default): scaled at every boundary the count
        has reached, in float32 as optax computes it."""
        count = self.count if count is None else count
        value = np.float32(self.learning_rate)
        for threshold, scale in self.boundaries.items():
            if count >= threshold:
                value = np.float32(np.float32(scale) * value)
        return float(value)

    @torch.no_grad()
    def step(self, grads) -> None:
        """One update from ``grads`` (in the order of ``params``)."""
        grads = list(grads)
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        clipped = [torch.where(norm < self.max_norm, g,
                               g / norm * self.max_norm) for g in grads]
        trace = list(self.trace.values())
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, clipped)
        updates = torch._foreach_mul(trace, -self.rate())
        torch._foreach_add_(list(self.params.values()), updates)
        self.count += 1

    def state_dict(self) -> Dict:
        return dict(momentum={k: v.detach().cpu()
                              for k, v in self.trace.items()},
                    count=self.count)

    def load_state_dict(self, state: Dict) -> None:
        if sorted(state["momentum"]) != sorted(self.trace):
            raise ValueError("the optimizer state's parameters are not the "
                             "model's")
        for k, v in state["momentum"].items():
            self.trace[k].copy_(v)
        self.count = int(state["count"])


def schedule_boundaries(epochs: int, steps_per_epoch: int) -> Dict[int, float]:
    """The reference's steps at epochs - 2 and epochs - 1
    (train_maskrcnn.py:96-99), each at least its step 1 or 2."""
    return {max((epochs - 2) * steps_per_epoch, 1): 0.1,
            max((epochs - 1) * steps_per_epoch, 2): 0.1}


def make_train_step(model: M.MaskRCNN, optimizer: SGD,
                    tcfg: TrainConfig = TrainConfig(), devices=None):
    """``step(batch, key) -> losses``: one update (in place) from a host
    batch ``(images, boxes, classes, masks, valid)`` and a key ``[2]``;
    forward and backward under ``utils/training.exact_convs``, the batch
    and its frames' keys split in order over ``devices`` (default: the
    model's device), one replica a device.  The losses stay on the
    device: each the replicas' mean, as the gradients are."""
    device = next(model.parameters()).device
    replicas = Replicas(model, devices or [device], list(optimizer.params))
    anchors = {d: M.device_anchors(model.config, d)
               for d in replicas.devices}

    def losses(replica, images, boxes, classes, masks, valid, keys):
        return frame_losses(replica, tcfg, anchors[images.device], images,
                            boxes, classes, masks, valid, keys)[0]

    def step(batch, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        images, boxes, classes, masks, valid = (
            torch.as_tensor(np.asarray(x)).to(device) for x in batch)
        loss, grads = replicas.grads(
            losses, images.to(torch.float32), boxes.to(torch.float32),
            classes.to(torch.int64), masks.to(torch.float32),
            valid.to(torch.bool),
            prng.split(key.to(device), images.shape[0]))
        optimizer.step(grads)
        return loss

    return step


# ---------------------------------------------------------------------
# dataset: COCO-style records -> fixed-shape instance targets
# ---------------------------------------------------------------------

def rasterize_record(record: Dict, max_gt: int):
    """One record -> (rgb, boxes [G, 4] xyxy, classes [G], masks [G, H, W],
    valid [G]), the polygon masks filled on the host."""
    import cv2
    from mass_tpu_torch.tools.detector_dataset import read_png
    rgb = read_png(record["file_name"]).astype(np.float32) / 255.0
    h, w = record["height"], record["width"]
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.zeros((max_gt,), np.int32)
    masks = np.zeros((max_gt, h, w), np.float32)
    valid = np.zeros((max_gt,), bool)
    for i, ann in enumerate(record["annotations"][:max_gt]):
        x, y, bw, bh = ann["bbox"]                     # XYWH
        boxes[i] = (x, y, x + bw, y + bh)
        classes[i] = ann["category_id"]
        mask = np.zeros((h, w), np.uint8)
        polys = [np.asarray(p, np.float32).reshape(-1, 2).round()
                 .astype(np.int32) for p in ann["segmentation"]]
        cv2.fillPoly(mask, polys, 1)
        masks[i] = mask
        valid[i] = True
    return rgb[..., :3], boxes, classes, masks, valid


def load_instance_split(dataset_dir: str, split: str, max_gt: int):
    with open(os.path.join(dataset_dir, f"{split}.json")) as f:
        records = json.load(f)
    cols = [rasterize_record(r, max_gt) for r in records]
    return tuple(np.stack([c[i] for c in cols]) for i in range(5))


def flip_batch(batch, flip: np.ndarray):
    """Horizontal flips of a host batch (detectron2 trains with RandomFlip
    by default, which the reference inherits: train_maskrcnn.py:108):
    where ``flip [B]``, images and masks mirror along x and the boxes'
    x0, x1 reflect and swap; empty gt slots stay zero."""
    images, boxes, classes, masks, valid = (np.array(x) for x in batch)
    w = images.shape[2]
    f = np.nonzero(flip)[0]
    images[f] = images[f, :, ::-1]
    masks[f] = masks[f, :, :, ::-1]
    x1 = boxes[f, :, 0].copy()
    boxes[f, :, 0] = w - boxes[f, :, 2]
    boxes[f, :, 2] = w - x1
    empty = ~valid[f]
    boxes[f] = np.where(empty[..., None], 0.0, boxes[f])
    return images, boxes, classes, masks, valid


# ---------------------------------------------------------------------
# evaluation, training, entry point
# ---------------------------------------------------------------------

def evaluate_fused(model: M.MaskRCNN, images, targets_sem,
                   detection_threshold: float = 0.5,
                   class_offset: int = CLASS_OFFSET, tta: bool = False):
    """The stand-in for COCOEvaluator: full inference on each frame, the
    masks fused into the per-pixel class image (the only consumer
    downstream, segmentation_config.py:311-337), mean IoU and pixel
    accuracy against the ground-truth classes from one confusion matrix.
    ``tta`` also runs the mirrored frame and pools both passes' confident
    masks before the argmax (the reference's TTA option,
    train_maskrcnn.py:111-113)."""
    from mass_tpu_torch.perception.segmentation import (
        detections_to_semantic, detections_to_semantic_tta)
    run = M.make_detector(model, class_offset=class_offset)
    num_classes = taxonomy.NUM_CLASSES
    cm = np.zeros((num_classes, num_classes), np.int64)
    for rgb, sem in zip(images, targets_sem):
        det = run(rgb)
        if tta:
            det_f = run(np.ascontiguousarray(rgb[:, ::-1]))
            det_f = det_f._replace(masks=det_f.masks.flip(-1))
            pred = detections_to_semantic_tta(
                [det, det_f], detection_threshold, num_classes)[..., 0]
        else:
            pred = detections_to_semantic(det, detection_threshold,
                                          num_classes)[..., 0]
        idx = sem.astype(np.int64) * num_classes + pred.cpu().numpy()
        cm += np.bincount(idx.reshape(-1),
                          minlength=num_classes * num_classes).reshape(
                              num_classes, num_classes)
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - inter
    seen = union > 0
    return dict(
        miou=float((inter[seen] / union[seen]).mean()) if seen.any()
        else 0.0,
        pixel_accuracy=float(inter.sum() / max(cm.sum(), 1)))


def save_checkpoint(logdir: str, model: M.MaskRCNN, optimizer: SGD) -> None:
    """``{logdir}/maskrcnn.pth`` (the detectron2 ``model`` dict and the
    class offset) and ``{logdir}/maskrcnn-opt.pth`` (momentum, count)."""
    os.makedirs(logdir, exist_ok=True)
    torch.save({"model": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()},
                "class_offset": CLASS_OFFSET},
               os.path.join(logdir, "maskrcnn.pth"))
    torch.save(optimizer.state_dict(),
               os.path.join(logdir, "maskrcnn-opt.pth"))


def train(dataset_dir: str, logdir: str, epochs: int = 1,
          batch_size: int = 2, learning_rate: float = 0.005,
          seed: int = 0, image_size: int = 224, num_classes: int = 53,
          config: M.MaskRCNNConfig = None,
          tcfg: TrainConfig = TrainConfig(), resume: bool = False,
          augment: bool = False, eval_every: int = 0,
          init_checkpoint: str = None, device=None, devices=None):
    """Train the detector on the generated dataset from flax's
    initialisation (``seed``); returns ``(model, history)``.

    ``num_classes`` defaults to the dataset's convention (the taxonomy
    without OccupiedSpace: category id = class - 1); the reference trains
    all 54 (train_maskrcnn.py:72-99).  ``augment`` flips frames at random;
    ``eval_every`` > 0 scores the fused masks' validation mIoU every N
    epochs (and at the last) and keeps the best checkpoint rather than
    the last.  Two warm starts:

    - ``init_checkpoint``: another run's weights (a ``.pth`` of the same
      class count), a fresh optimizer and schedule: the fine-tune route
      (the reference's COCO -> THOR fine-tune, another run standing in for
      the COCO zoo);
    - ``resume``: this logdir's run, weights and optimizer (momentum and
      the schedule count) from ``{logdir}/maskrcnn[-opt].pth``, so the
      schedule goes on at the saved step.

    Each batch splits over the first devices of ``devices`` (default:
    ``device`` alone), as many as the largest divisor of the batch
    allows.
    """
    device = resolve_device(device if devices is None else devices[0])
    devices = list(devices or [device])
    devices = devices[:largest_divisor(batch_size, len(devices))]
    if config is None:
        config = M.MaskRCNNConfig(num_classes=num_classes,
                                  image_size=image_size)
    data = load_instance_split(dataset_dir, "training", tcfg.max_gt)
    images = data[0]
    model = init_maskrcnn(torch.Generator().manual_seed(seed), config)
    if init_checkpoint:
        load_weights(model, init_checkpoint)
    weights = os.path.join(logdir, "maskrcnn.pth") if logdir else None
    if resume and weights and os.path.exists(weights):
        load_weights(model, weights)
    model.to(device)

    steps_per_epoch = max(len(images) // batch_size, 1)
    optimizer = SGD(model.named_parameters(), learning_rate,
                    schedule_boundaries(epochs, steps_per_epoch))
    opt_path = os.path.join(logdir, "maskrcnn-opt.pth") if logdir else None
    if resume and opt_path and os.path.exists(opt_path):
        optimizer.load_state_dict(torch.load(opt_path, map_location="cpu",
                                             weights_only=True))
    step = make_train_step(model, optimizer, tcfg, devices)

    try:
        from mass_tpu_torch.perception.train_detector import load_split
        val_images, val_sem = load_split(dataset_dir, "validation")
    except FileNotFoundError:
        val_images = val_sem = None

    rng = np.random.RandomState(seed)
    key = prng.PRNGKey(seed)
    history = []
    best_miou = -1.0
    for epoch in range(epochs):
        t0 = time.time()
        losses = []
        order = rng.permutation(len(images))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            batch = tuple(d[sel] for d in data)
            if augment:
                batch = flip_batch(batch, rng.rand(batch_size) < 0.5)
            key, sub = prng.split(key)
            loss = step(batch, sub)
            losses.append({k: float(v) for k, v in loss.items()})
        mean = {k: float(np.mean([l[k] for l in losses]))
                for k in losses[0]}
        mean.update(epoch=epoch, sec=time.time() - t0)
        if eval_every and val_images is not None and (
                (epoch + 1) % eval_every == 0 or epoch == epochs - 1):
            metrics = evaluate_fused(model, val_images, val_sem)
            mean.update(val_miou=metrics["miou"],
                        val_pixel_accuracy=metrics["pixel_accuracy"])
            if logdir and metrics["miou"] > best_miou:
                best_miou = metrics["miou"]
                save_checkpoint(logdir, model, optimizer)
        history.append(mean)
        print(mean)
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            with open(os.path.join(logdir, "history.json"), "w") as f:
                json.dump(history, f, indent=2)

    # fused-mask pixel metrics on the validation split; with eval_every the
    # last epoch was scored in the loop and the best checkpoint is saved
    if val_images is not None and not eval_every:
        metrics = evaluate_fused(model, val_images, val_sem)
        metrics["epoch"] = "validation"
        history.append(metrics)
        print(metrics)

    if logdir:
        if not (eval_every and best_miou >= 0):
            save_checkpoint(logdir, model, optimizer)
        with open(os.path.join(logdir, "history.json"), "w") as f:
            json.dump(history, f, indent=2)
    return model, history


def main(argv=None):
    from mass_tpu_torch.agent.cli import (add_device_flags,
                                          resolve_device_flags)

    p = argparse.ArgumentParser("mask r-cnn trainer")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--learning-rate", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=53)
    p.add_argument("--resume", action="store_true",
                   help="continue this logdir's run: weights and optimizer "
                        "state (momentum, schedule step) from "
                        "{logdir}/maskrcnn[-opt].pth")
    p.add_argument("--init-checkpoint", type=str, default=None,
                   help="fine-tune route: start from the weights of another "
                        "run's maskrcnn.pth (same class count), with a "
                        "fresh optimizer and schedule")
    p.add_argument("--augment", action="store_true",
                   help="random horizontal flips (detectron2's RandomFlip)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="score validation mIoU every N epochs and keep the "
                        "best checkpoint")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: score {logdir}/maskrcnn.pth on the "
                        "validation split")
    p.add_argument("--tta", action="store_true",
                   help="pool horizontal-flip masks at eval time "
                        "(reference: train_maskrcnn.py:111-113)")
    p.add_argument("--detection-threshold", type=float, default=0.5,
                   help="mask confidence threshold of the fused eval")
    add_device_flags(p)
    args = p.parse_args(argv)
    device = resolve_device_flags(args)
    if args.eval_only:
        from mass_tpu_torch.perception.train_detector import load_split
        config = M.MaskRCNNConfig(num_classes=args.num_classes,
                                  image_size=args.image_size)
        model = M.MaskRCNN(config)
        offset = load_weights(model, os.path.join(args.logdir,
                                                  "maskrcnn.pth"))
        model.to(resolve_device(device))
        val_images, val_sem = load_split(args.dataset, "validation")
        metrics = evaluate_fused(
            model, val_images, val_sem,
            detection_threshold=args.detection_threshold,
            class_offset=offset, tta=args.tta)
        metrics.update(tta=args.tta,
                       detection_threshold=args.detection_threshold)
        print(json.dumps(metrics))
        return metrics
    return train(args.dataset, args.logdir, args.epochs, args.batch_size,
                 args.learning_rate, args.seed, args.image_size,
                 args.num_classes, resume=args.resume, augment=args.augment,
                 eval_every=args.eval_every,
                 init_checkpoint=args.init_checkpoint, device=device)


if __name__ == "__main__":
    main()
