"""Detection building blocks: IoU, greedy NMS and ROIAlign (port of
``mass_tpu.ops.detection``).

The semantics are the JAX package's, not detectron2's: NMS is the
fixed-iteration greedy loop of ``mass_tpu/ops/detection.py:31-60`` (each
iteration picks the highest-scoring live box, lowest index on ties, and
kills the live boxes whose IoU with it reaches the threshold), and
ROIAlign samples bilinearly with coordinates clipped to ``[0, h - 1]``.

:func:`nms` takes a batch of independent problems.  On CUDA tensors it
launches the hand-written kernel of ``csrc/nms.cu`` (one block per
problem; built with the splat kernels by ``ops/splat.build``) and counts
the launch in ``LAUNCHES``; on CPU tensors it runs :func:`nms_reference`,
a literal port of the ``fori_loop``.  There is no fallback: a CUDA launch
that fails raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

# kernel launches made by nms (read by chip_smoke.py to show the detector
# went through the kernel)
LAUNCHES = 0


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ``[..., N, 4]`` and ``[..., M, 4]`` boxes (x0, y0,
    x1, y1), in ``box_iou``'s float32 operation order."""
    zero = a.new_zeros(())
    area_a = (torch.maximum(a[..., 2] - a[..., 0], zero)
              * torch.maximum(a[..., 3] - a[..., 1], zero))
    area_b = (torch.maximum(b[..., 2] - b[..., 0], zero)
              * torch.maximum(b[..., 3] - b[..., 1], zero))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.maximum(union, a.new_full((), 1e-9))


def _counts(max_outputs: Union[int, Sequence[int]], problems: int):
    """Per-problem output caps as a list whose length divides
    ``problems`` (problem p takes entry ``p % len``)."""
    counts = ([int(max_outputs)] if isinstance(max_outputs, int)
              else [int(m) for m in max_outputs])
    if not counts or (problems and problems % len(counts)) or \
            min(counts) < 0:
        raise ValueError(f"nms: max_outputs {max_outputs!r} does not fit "
                         f"{problems} problems")
    return counts


def nms_reference(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float = 0.5,
                  max_outputs: Union[int, Sequence[int]] = 100
                  ) -> torch.Tensor:
    """Plain PyTorch version of the NMS kernel: the JAX ``fori_loop``,
    batched.  ``boxes [P, N, 4]``, ``scores [P, N]``; ``max_outputs`` an
    int or a sequence whose length divides P (problem p takes entry
    ``p % len``).  Returns ``keep [P, M]`` int32, ``M = max(max_outputs)``;
    problem p fills ``min(max_outputs_p, N)`` slots and the rest is -1."""
    P, n = scores.shape
    counts = _counts(max_outputs, P)
    width = max(counts)
    keep = torch.full((P, width), -1, dtype=torch.int32,
                      device=scores.device)
    iou = box_iou(boxes, boxes)
    thr = scores.new_full((), iou_threshold)
    neg = scores.new_full((), float("-inf"))
    for p in range(P):
        alive = scores[p] > neg
        for i in range(min(counts[p % len(counts)], n)):
            best = int(torch.argmax(torch.where(alive, scores[p], neg)))
            if not bool(alive[best]):
                continue
            keep[p, i] = best
            alive &= ~(iou[p, best] >= thr)
    return keep


def _library() -> ctypes.CDLL:
    from mass_tpu_torch.ops import splat
    return splat._library("nms")


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5,
        max_outputs: Union[int, Sequence[int]] = 100) -> torch.Tensor:
    """Greedy NMS over ``P`` problems (``boxes [P, N, 4]``, ``scores
    [P, N]`` float32; ``-inf`` scores start dead): the CUDA kernel for
    CUDA tensors, :func:`nms_reference` for CPU tensors.  Same arguments
    and result as :func:`nms_reference`."""
    global LAUNCHES
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return nms_reference(boxes, scores, iou_threshold, max_outputs)
    if boxes.device != scores.device or boxes.device.type != "cuda":
        raise ValueError(f"nms: boxes on {boxes.device}, scores on "
                         f"{scores.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or \
            boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"nms kernel: boxes [P, N, 4] and scores [P, N] "
                         f"float32, got {boxes.dtype} {tuple(boxes.shape)} "
                         f"and {scores.dtype} {tuple(scores.shape)}")
    from mass_tpu_torch.ops import splat
    lib = _library()
    P, n = scores.shape
    counts = _counts(max_outputs, P)
    if n > lib.nms_max_boxes() or len(counts) > lib.nms_max_counts():
        raise ValueError(f"nms kernel: N={n} boxes (at most "
                         f"{lib.nms_max_boxes()}) or {len(counts)} counts "
                         f"(at most {lib.nms_max_counts()})")
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    scores = scores.contiguous()
    width = max(counts)
    keep = torch.empty((P, width), dtype=torch.int32, device=boxes.device)
    splat._raise_on(lib.nms_launch(
        boxes.data_ptr(), scores.data_ptr(), P, n,
        (ctypes.c_int * len(counts))(*counts), len(counts),
        float(iou_threshold), width, keep.data_ptr(),
        splat._stream(boxes.device)), "nms")
    LAUNCHES += 1
    return keep


def _bilinear_pool(table: torch.Tensor, offset: torch.Tensor,
                   height: torch.Tensor, width: torch.Tensor,
                   boxes: torch.Tensor, output_size: int,
                   sampling_ratio: int) -> torch.Tensor:
    """ROIAlign of ``[N, 4]`` boxes, each on its own feature map: box i
    reads the ``height[i] x width[i]`` rows of ``table [L, C]`` starting
    at ``offset[i]`` (row-major).  Returns ``[N, S, S, C]``."""
    n = boxes.shape[0]
    s, r = output_size, sampling_ratio
    dev = boxes.device
    bw = (boxes[:, 2] - boxes[:, 0]) / s
    bh = (boxes[:, 3] - boxes[:, 1]) / s
    cell = torch.arange(s, dtype=torch.float32, device=dev)
    sub = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r
    grid = cell[None, :, None] + sub[None, None, :]             # [1, S, r]
    gx = boxes[:, 0, None, None] + grid * bw[:, None, None]     # [N, S, r]
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
    fy = (y - y0)[:, :, :, None, None, None]                    # [N,S,r,1,1,1]
    fx = (x - x0)[:, None, None, :, :, None]                    # [N,1,1,S,r,1]
    base = offset[:, None, None, None, None]
    w5 = width[:, None, None, None, None]

    def at(yi, xi):
        idx = base + yi[:, :, :, None, None] * w5 + xi[:, None, None, :, :]
        return table[idx.reshape(-1)].view(n, s, r, s, r, -1)

    v00, v01 = at(y0, x0), at(y0, x1)
    v10, v11 = at(y1, x0), at(y1, x1)
    samples = ((1 - fy) * (1 - fx) * v00 + (1 - fy) * fx * v01
               + fy * (1 - fx) * v10 + fy * fx * v11)
    return samples.mean(dim=(2, 4))


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign: bilinear-sample ``[H, W, C]`` features inside ``[N, 4]``
    boxes (x0, y0, x1, y1 in pixel coordinates) to ``[N, S, S, C]``, each
    cell the mean of ``sampling_ratio**2`` samples (detectron2's
    aligned=False grid placement, coordinates clipped to the map)."""
    h, w, c = features.shape
    n = boxes.shape[0]
    dev = boxes.device
    return _bilinear_pool(
        features.reshape(h * w, c), torch.zeros(n, dtype=torch.int64,
                                                device=dev),
        torch.full((n,), h, dtype=torch.int64, device=dev),
        torch.full((n,), w, dtype=torch.int64, device=dev), boxes,
        output_size, sampling_ratio)
