"""Connected-component labelling and per-component extraction (port of
``mass_tpu.ops.components``).

Labels come from iterative 8-connected min-label propagation, exactly
the JAX package's rule, so the same component keeps the same (smallest
seed) label; instances are the K most populous labels in the JAX
package's tie order.  Every function takes leading batch dimensions (one
mask per class), where the JAX package vmapped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mass_tpu_torch.ops.pool import min_pool2d_same


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """Label the 8-connected components of a boolean ``[..., H, W]`` mask.

    Returns int32 labels, 0 for background and the component's smallest
    ``row * W + col + 1`` otherwise.  The propagation checks convergence
    on the host every 4 hops (a fixpoint is unchanged by extra hops).
    """
    h, w = mask.shape[-2:]
    seed = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device=mask.device).view(h, w)
    big = torch.iinfo(torch.int32).max
    labels = torch.where(mask, seed, torch.full_like(seed, big))

    def propagate(lab):
        return torch.where(mask, torch.minimum(lab, min_pool2d_same(lab, 1)),
                           lab)

    labels = propagate(labels)
    while True:
        new = propagate(propagate(propagate(propagate(labels))))
        if not bool((new != labels).any()):
            break
        labels = new
    return torch.where(mask, labels, torch.zeros_like(labels))


class Instances(NamedTuple):
    """Up to ``K`` extracted components per mask, size-ranked.

    ``present [..., K]``; ``boxes [..., K, 4]`` as (x, y, w, h);
    ``masks`` / ``roi [..., K, H, W]`` the component masks and filled
    bounding rectangles; ``truncated [...]`` flags more than K
    components.
    """

    present: torch.Tensor
    boxes: torch.Tensor
    masks: torch.Tensor
    roi: torch.Tensor
    truncated: torch.Tensor


def extract_instances(mask: torch.Tensor, max_instances: int) -> Instances:
    """Split a boolean ``[..., H, W]`` mask into its ``max_instances``
    largest connected components, with boxes and ROI masks.

    Ranking follows ``lax.top_k``: descending size, and among equal sizes
    the smaller label first — a stable descending sort, never
    ``torch.topk``, whose tie order is unspecified.
    """
    h, w = mask.shape[-2:]
    labels = label_components(mask)
    flat = labels.flatten(-2)
    n = flat.shape[-1]
    lab_sorted = torch.sort(flat, dim=-1).values
    head = torch.ones_like(lab_sorted, dtype=torch.bool)
    head[..., 1:] = lab_sorted[..., 1:] != lab_sorted[..., :-1]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    starts = torch.where(head, idx, torch.full_like(idx, n))
    # suffix minimum: the next run's start for every position
    suffix = torch.flip(torch.cummin(torch.flip(starts, [-1]), -1).values,
                        [-1])
    next_start = torch.cat(
        [suffix[..., 1:], torch.full_like(suffix[..., :1], n)], dim=-1)
    run_len = next_start - idx
    real = head & (lab_sorted > 0)
    score = torch.where(real, run_len, torch.full_like(run_len, -1))
    top_counts, top_idx = torch.sort(score, dim=-1, descending=True,
                                     stable=True)
    top_counts = top_counts[..., :max_instances]
    top_idx = top_idx[..., :max_instances]
    present = top_counts > 0
    labs = torch.where(present, torch.gather(lab_sorted, -1, top_idx),
                       torch.zeros_like(top_counts))
    truncated = real.sum(-1) > max_instances

    labs4 = labs[..., None, None]
    masks = (labels[..., None, :, :] == labs4) & (labs4 > 0)
    ys = torch.arange(h, dtype=torch.int32, device=mask.device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=mask.device)[None, :]
    big = 1 << 30
    x0 = torch.where(masks, xs, big).amin(dim=(-2, -1))
    y0 = torch.where(masks, ys, big).amin(dim=(-2, -1))
    x1 = torch.where(masks, xs, -1).amax(dim=(-2, -1))
    y1 = torch.where(masks, ys, -1).amax(dim=(-2, -1))
    boxes = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dim=-1)
    boxes = torch.where(present[..., None], boxes, torch.zeros_like(boxes))

    roi = ((xs >= x0[..., None, None]) & (xs <= x1[..., None, None]) &
           (ys >= y0[..., None, None]) & (ys <= y1[..., None, None]) &
           present[..., None, None])
    return Instances(present=present, boxes=boxes, masks=masks, roi=roi,
                     truncated=truncated)
