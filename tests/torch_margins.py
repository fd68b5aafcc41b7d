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
