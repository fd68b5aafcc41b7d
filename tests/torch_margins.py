"""The margin rule for holding two runs of the port's detector against each
other (or against the JAX package's): the card against the CPU, the port
against JAX.  No JAX here: ``chip_smoke.py`` uses it too.

Two frameworks, or cuDNN and the CPU, sum the convs in other orders, so a
continuous value within about its tolerance of a threshold or of its
rival can decide the other way.  The rule: every discrete output is
exact wherever the value that decides it is farther than ``tol`` from
its threshold or its rival, and each place where it is not (a flip) is
reported with its margin, which must not exceed ``tol``.  Deciding
values are the reference run's: a detection slot's score against its
neighbours' and against the score and detection thresholds, a mask
pixel's pasted probability against 0.5.
"""

import numpy as np

# the tolerance of scores and pasted mask probabilities (float32 values
# of order 1 that went through about 60 layers summed in another order)
TOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def compare_detections(ref, other, ref_probs, thresholds=(), tol=TOL):
    """Hold ``other`` (Detections) against ``ref`` (Detections with the
    pasted mask probabilities ``ref_probs [..., K, H, W]``) by the margin
    rule.  ``thresholds`` are the score thresholds that decided which
    slots count (the detector's ``score_threshold``, a fusion's
    ``detection_threshold``).  Returns a report: ``ok``, the counts and
    largest margins of slot flips and mask-pixel flips, the largest score
    difference on matching slots, and the count of live slots."""
    s_ref, s_oth = _np(ref.scores), _np(other.scores)
    c_ref, c_oth = _np(ref.classes), _np(other.classes)
    m_ref, m_oth = _np(ref.masks), _np(other.masks)
    probs = _np(ref_probs)
    s_ref = s_ref.reshape(-1, s_ref.shape[-1])
    s_oth = s_oth.reshape(s_ref.shape)
    c_ref = c_ref.reshape(s_ref.shape)
    c_oth = c_oth.reshape(s_ref.shape)
    m_ref = m_ref.reshape(s_ref.shape + m_ref.shape[-2:])
    m_oth = m_oth.reshape(m_ref.shape)
    probs = probs.reshape(m_ref.shape)
    report = dict(slot_flips=0, slot_flip_margin=0.0, pixel_flips=0,
                  pixel_flip_margin=0.0, max_score_diff=0.0,
                  live_slots=int((s_ref > 0).sum()))
    for f in range(s_ref.shape[0]):
        live = s_ref[f]
        for k in range(live.shape[0]):
            same = (c_ref[f, k] == c_oth[f, k]
                    and abs(s_ref[f, k] - s_oth[f, k]) <= tol)
            if same:
                report["max_score_diff"] = max(
                    report["max_score_diff"],
                    float(abs(s_ref[f, k] - s_oth[f, k])))
                flip = m_ref[f, k] != m_oth[f, k]
                if flip.any():
                    report["pixel_flips"] += int(flip.sum())
                    report["pixel_flip_margin"] = max(
                        report["pixel_flip_margin"],
                        float(np.abs(probs[f, k][flip] - 0.5).max()))
                continue
            rivals = [abs(live[k] - live[j]) for j in (k - 1, k + 1)
                      if 0 <= j < live.shape[0]]
            rivals += [abs(live[k] - t) for t in thresholds]
            report["slot_flips"] += 1
            report["slot_flip_margin"] = max(report["slot_flip_margin"],
                                             float(min(rivals)))
    report["ok"] = (report["slot_flip_margin"] <= tol
                    and report["pixel_flip_margin"] <= tol)
    return report


def compare_semantic(ref_sem, other_sem, ref, ref_probs,
                     detection_threshold, tol=TOL):
    """Fused class images by the margin rule: pixels may differ only where
    a confident mask's probability lies within ``tol`` of 0.5 or a
    slot's score within ``tol`` of the detection threshold.  Returns
    ``(differing pixels, unexplained differing pixels)``."""
    a, b = _np(ref_sem)[..., 0], _np(other_sem)[..., 0]
    diff = a != b
    if not diff.any():
        return 0, 0
    scores = _np(ref.scores)
    probs = _np(ref_probs)
    near = np.abs(probs - 0.5) <= tol                    # [..., K, H, W]
    near_thr = np.abs(scores - detection_threshold) <= tol
    covered = near.any(-3) | (near_thr[..., None, None]
                              & (probs > 0.5 - tol)).any(-3)
    return int(diff.sum()), int((diff & ~covered).sum())


def _frame_equal(ref, other, fields, b):
    return all(np.array_equal(_np(getattr(ref, f))[b],
                              _np(getattr(other, f))[b]) for f in fields)


def compare_train_targets(ref, other, anchors, gt_boxes, gt_valid, tcfg,
                          tol=TOL):
    """Hold the Mask R-CNN trainer's sampled targets of ``other`` (its
    ``Targets``, float32, say the card's) against ``ref`` (from the same
    RPN outputs and proposals, say in float64 on the CPU) by the margin
    rule.  The deciding values, all the reference's: an anchor's best IoU
    against the RPN's thresholds, and against the best IoU of the gt it
    may be forced positive for (``anchors [N, 4]``, ``gt_boxes [B, G,
    4]``); a ROI's best IoU against the foreground threshold; a pooled mask
    value against 0.5.  Where a label flips, that frame's samples of its
    stage are not compared (the draws go to other candidates); a flip's
    margin is the smallest of its deciding distances.  Returns a report
    with ``ok``."""
    a = _np(anchors).astype(np.float64)
    boxes = _np(gt_boxes).astype(np.float64)
    valid = _np(gt_valid).astype(bool)
    report = dict(anchor_flips=0, anchor_flip_margin=0.0, roi_flips=0,
                  roi_flip_margin=0.0, mask_flips=0, mask_flip_margin=0.0,
                  max_box_target_diff=0.0, unexplained=[])

    def area(x):
        return np.prod(np.maximum(x[..., 2:] - x[..., :2], 0.0), -1)
    for b in range(boxes.shape[0]):
        # anchors: an anchor's label is decided by its best IoU against
        # the thresholds, and for a forced positive by its IoU against the
        # best of its gt's other anchors (the float64 IoU matrix)
        flips = _np(ref.anchor_label)[b] != _np(other.anchor_label)[b]
        if flips.any():
            lt = np.maximum(a[flips, None, :2], boxes[b][None, :, :2])
            rb = np.minimum(a[flips, None, 2:], boxes[b][None, :, 2:])
            inter = np.prod(np.maximum(rb - lt, 0.0), -1)
            union = area(a[flips])[:, None] + area(boxes[b])[None] - inter
            iou = inter / np.maximum(union, 1e-9)
            best = _np(ref.anchor_iou)[b].astype(np.float64)
            top = np.zeros(boxes.shape[1])
            for g in range(boxes.shape[1]):
                lt = np.maximum(a[:, :2], boxes[b][g, :2])
                rb = np.minimum(a[:, 2:], boxes[b][g, 2:])
                i = np.prod(np.maximum(rb - lt, 0.0), -1)
                top[g] = (i / np.maximum(area(a) + area(boxes[b][g]) - i,
                                         1e-9)).max()
            rival = np.where(valid[b][None], np.abs(iou - top[None]),
                             np.inf).min(1)
            margin = np.minimum(np.minimum(
                np.abs(best[flips] - tcfg.rpn_pos_iou),
                np.abs(best[flips] - tcfg.rpn_neg_iou)), rival)
            report["anchor_flips"] += int(flips.sum())
            report["anchor_flip_margin"] = max(report["anchor_flip_margin"],
                                               float(margin.max()))
        elif not _frame_equal(ref, other, ("rpn_index", "rpn_weight",
                                           "rpn_label"), b):
            report["unexplained"].append(f"frame {b}: anchor samples")
        else:
            # the boxes of the positives that weigh (an ineligible pick's
            # target is unused, and degenerate boxes blow it up)
            live = _np(ref.rpn_label)[b, :_np(ref.rpn_box).shape[1]] > 0
            diff = np.abs(_np(ref.rpn_box)[b] - _np(other.rpn_box)[b])[live]
            report["max_box_target_diff"] = max(
                report["max_box_target_diff"], float(diff.max(initial=0.0)))
        # ROIs (of the same proposals)
        best = _np(ref.roi_iou)[b].astype(np.float64)
        mine = _np(other.roi_iou)[b].astype(np.float64)
        flips = (best >= tcfg.roi_fg_iou) != (mine >= tcfg.roi_fg_iou)
        if flips.any():
            report["roi_flips"] += int(flips.sum())
            report["roi_flip_margin"] = max(
                report["roi_flip_margin"],
                float(np.abs(best - tcfg.roi_fg_iou)[flips].max()))
            continue
        if not _frame_equal(ref, other, ("roi_index", "roi_weight",
                                         "roi_label", "fg_class"), b):
            report["unexplained"].append(f"frame {b}: ROI samples")
            continue
        live = _np(ref.roi_weight)[b, :_np(ref.fg_class).shape[1]] > 0
        diff = np.abs(_np(ref.box_target)[b]
                      - _np(other.box_target)[b])[live]
        report["max_box_target_diff"] = max(report["max_box_target_diff"],
                                            float(diff.max(initial=0.0)))
        crop = _np(ref.mask_crop)[b].astype(np.float64)
        flip = ((crop >= 0.5) != (_np(other.mask_crop)[b] >= 0.5)) \
            & live[:, None, None]
        if flip.any():
            report["mask_flips"] += int(flip.sum())
            report["mask_flip_margin"] = max(
                report["mask_flip_margin"],
                float(np.abs(crop[flip] - 0.5).max()))
    report["ok"] = (not report["unexplained"]
                    and report["anchor_flip_margin"] <= tol
                    and report["roi_flip_margin"] <= tol
                    and report["mask_flip_margin"] <= tol
                    and report["max_box_target_diff"] <= tol)
    return report
