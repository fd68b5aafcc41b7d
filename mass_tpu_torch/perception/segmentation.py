"""Semantic segmentation sources: ground-truth color lookup and detector
mask fusion (port of ``mass_tpu.perception.segmentation``).

Two ways to produce the per-pixel class image the semantic map reads
(reference: mass/thor/segmentation_config.py:273-337):

  * ground truth: the simulator's class ids (the grid world), or a
    colorized segmentation frame matched exactly against the taxonomy's
    colors, unknown colors mapped to OccupiedSpace (class 0);
  * learned: an instance detector's masks are summed per class over a
    confidence threshold and argmaxed per pixel.

The fusion runs on the detections' device with no host sync; a sensor
returns the class image as host numpy, as the JAX package's does.  The
mask sums are sums of 0/1 values, exact in float32, so the fused image is
the same on every device.  The fusion runs in a ``mass.sensor.fuse`` span
and the class image's copy to the host in a ``mass.sensor.to_host`` span
(``utils/profiling.span``).
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from mass_tpu_torch import taxonomy
from mass_tpu_torch.utils.profiling import span


def colors_to_classes(seg_frame) -> torch.Tensor:
    """``[h, w, 3]`` uint8 color frame -> ``[h, w, 1]`` int32 class ids:
    exact match against the class colors (class 0 excluded from matching
    and used as the fallback: the reference's 0.1-pad argmax)."""
    frame = torch.as_tensor(np.asarray(seg_frame)).to(torch.int16)
    colors = torch.from_numpy(taxonomy.class_colors_array(
        normalized=False)).to(torch.int16).to(frame.device)
    match = (frame[:, :, None, :] == colors[None, None, 1:]).all(-1)
    padded = torch.cat([torch.full(match.shape[:2] + (1,), 0.1,
                                   device=frame.device),
                        match.to(torch.float32)], -1)
    return torch.argmax(padded, -1).to(torch.int32)[..., None]


class Detections(NamedTuple):
    """Fixed-capacity instance detections of one frame (or ``[B]``
    frames, a leading batch on every field)."""

    masks: torch.Tensor    # [(B,) K, h, w] float (0-1)
    classes: torch.Tensor  # [(B,) K] int32
    scores: torch.Tensor   # [(B,) K] float


def _class_sums(det: Detections, detection_threshold: float,
                num_classes: int) -> torch.Tensor:
    """``[(B,) h, w, C]``: the masks of the detections scoring at least
    the threshold, summed per class (a class outside ``[0, C)`` adds
    nothing, as ``jax.nn.one_hot`` gives it a zero row)."""
    weights = (det.scores >= detection_threshold).to(torch.float32)
    onehot = (det.classes[..., None].to(torch.int64) == torch.arange(
        num_classes, device=det.classes.device)).to(torch.float32)
    masks = det.masks * weights[..., None, None]
    return torch.einsum("...khw,...kc->...hwc", masks, onehot)


def _argmax_classes(acc: torch.Tensor) -> torch.Tensor:
    return torch.argmax(acc, dim=-1).to(torch.int32)[..., None]


def detections_to_semantic(detections: Detections,
                           detection_threshold: float,
                           num_classes: int = taxonomy.NUM_CLASSES
                           ) -> torch.Tensor:
    """Fuse instance masks into a per-pixel class image ``[(B,) h, w, 1]``
    int32: confident instances' masks summed per class, argmax per pixel
    (the lowest class among equal sums), class 0 where nothing fired."""
    return _argmax_classes(_class_sums(detections, detection_threshold,
                                       num_classes))


def detections_to_semantic_tta(detection_sets, detection_threshold: float,
                               num_classes: int = taxonomy.NUM_CLASSES
                               ) -> torch.Tensor:
    """Test-time-augmented fusion: the confident instances of several
    passes (each already mapped back into the original frame) pooled into
    one sum before the per-pixel argmax (reference: train_maskrcnn.py:
    111-113)."""
    acc = None
    for det in detection_sets:
        sums = _class_sums(det, detection_threshold, num_classes)
        acc = sums if acc is None else acc + sums
    return _argmax_classes(acc)


class SegmentationModel(Protocol):
    """A pluggable detector: RGB frame (or batch) -> Detections."""

    def __call__(self, rgb) -> Detections:
        ...


class GroundTruthSegmentation:
    """Sensor adapter for the simulator's ground truth: the grid world's
    class ids pass through; a THOR color frame is color-matched."""

    def __call__(self, observation) -> np.ndarray:
        if "semantic" in observation:
            return np.asarray(observation["semantic"])
        return colors_to_classes(observation["semantic_colors"]).numpy()


class DetectorSegmentation:
    """Sensor adapter: a detector and mask fusion, on the detector's
    device; the class image comes back as host numpy ``[h, w, 1]``."""

    def __init__(self, model: SegmentationModel,
                 detection_threshold: float = 0.9,
                 num_classes: int = taxonomy.NUM_CLASSES):
        self.model = model
        self.detection_threshold = detection_threshold
        self.num_classes = num_classes

    def semantic(self, rgb) -> torch.Tensor:
        """RGB ``[(B,) h, w, 3]`` -> fused classes ``[(B,) h, w, 1]`` on
        the detector's device."""
        detections = self.model(rgb)
        with span("mass.sensor.fuse"):
            return detections_to_semantic(detections,
                                          self.detection_threshold,
                                          self.num_classes)

    def __call__(self, observation) -> np.ndarray:
        return _to_host(self.semantic(np.asarray(observation["rgb"],
                                                 np.float32)))


def _to_host(classes: torch.Tensor) -> np.ndarray:
    with span("mass.sensor.to_host"):
        return classes.cpu().numpy()


def make_batched_sensor(sensor):
    """Lift a per-frame sensor to a frame batch (``[B, h, w, 3]`` rgb ->
    ``[B, h, w, 1]`` int32 classes).  A :class:`DetectorSegmentation`
    runs the whole batch as one forward (the fleet's tick: B frames,
    one network pass, one RPN and one detection NMS launch); any other
    sensor is called frame by frame."""
    if isinstance(sensor, DetectorSegmentation):
        def batched(rgb_batch) -> np.ndarray:
            return _to_host(sensor.semantic(np.asarray(rgb_batch,
                                                       np.float32)))
        return batched

    def looped(rgb_batch) -> np.ndarray:
        return np.stack([np.asarray(sensor({"rgb": rgb}))
                         for rgb in np.asarray(rgb_batch)])

    return looped


class SegmentationTaskWrapper:
    """Task decorator replacing the ground-truth ``semantic`` with a
    learned sensor's; the ground truth is kept under ``gt_semantic``
    (reference: segmentation_config.py:207-218, 273-337)."""

    def __init__(self, task, sensor):
        self._task = task
        self._sensor = sensor

    def get_observations(self):
        obs = dict(self._task.get_observations())
        if "semantic" in obs:
            obs["gt_semantic"] = obs["semantic"]
        obs["semantic"] = self._sensor(obs)
        return obs

    def __getattr__(self, name):
        return getattr(self._task, name)


class SegmentationSampler:
    """Task-sampler decorator wrapping every task with a learned
    segmentation sensor."""

    def __init__(self, sampler, sensor):
        self._sampler = sampler
        self._sensor = sensor

    def next_task(self):
        return SegmentationTaskWrapper(self._sampler.next_task(),
                                       self._sensor)

    def skip_task(self):
        return self._sampler.skip_task()

    def __getattr__(self, name):
        return getattr(self._sampler, name)
