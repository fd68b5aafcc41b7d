"""Generate a COCO-style instance-segmentation dataset for detector
training, plus the merge/split formatter (a copy of
``mass_tpu.tools.detector_dataset``: host tooling over the port's grid
world, with cv2 for the masks and the PNGs: the GPU machine has no
imageio).

Reference equivalents: generate_maskrcnn_dataset.py (random poses in
walkthrough+unshuffle scenes; GT instance masks -> polygons + records)
and format_maskrcnn_dataset.py (merge per-image JSONs into
training/validation splits).  Here frames come from any Task-protocol
environment; for the grid world GT instance masks derive from per-class
connected components of the semantic frame.

    python -m mass_tpu_torch.tools.detector_dataset generate --logdir d \
        --total-tasks 4 --poses-per-scene 8
    python -m mass_tpu_torch.tools.detector_dataset format --logdir d
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

import numpy as np

from mass_tpu_torch.agent.metrics import NumpyJSONEncoder
from mass_tpu_torch.config import CameraConfig


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit RGB ``[H, W, 3]`` or grey ``[H, W]`` image as a PNG."""
    import cv2
    if image.ndim == 3:
        image = image[..., ::-1]                  # cv2 writes BGR
    if not cv2.imwrite(path, np.ascontiguousarray(image)):
        raise OSError(f"could not write {path}")


def read_png(path: str) -> np.ndarray:
    """A PNG as :func:`write_png` wrote it (RGB or grey, uint8)."""
    import cv2
    image = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise OSError(f"could not read {path}")
    if image.ndim == 3:
        image = image[..., 2::-1]                 # BGR(A) -> RGB
    return image


def _mask_to_polygons(mask: np.ndarray) -> List[List[float]]:
    """Object boundary polygons via cv2 contours (host tooling only —
    the on-device pipeline never uses cv2)."""
    import cv2
    contours, _ = cv2.findContours(mask.astype(np.uint8),
                                   cv2.RETR_LIST,
                                   cv2.CHAIN_APPROX_SIMPLE)
    polys = []
    for contour in contours:
        pts = contour.reshape(-1, 2).astype(float)
        if pts.shape[0] >= 3:
            polys.append(pts.reshape(-1).tolist())
    return polys


def record_from_frame(rgb: np.ndarray, semantic: np.ndarray,
                      image_id: int, logdir: str) -> Dict:
    """One COCO-style record: per class, connected regions become
    instance annotations with bbox (XYWH) + polygon segmentation
    (reference: generate_maskrcnn_dataset.py:60-169)."""
    import cv2
    annotations = []
    sem = semantic[..., 0] if semantic.ndim == 3 else semantic
    for cls in np.unique(sem):
        if cls == 0:
            continue
        class_mask = (sem == cls).astype(np.uint8)
        class_mask = cv2.dilate(class_mask, np.ones((3, 3), np.uint8))
        class_mask = cv2.erode(class_mask, np.ones((3, 3), np.uint8))
        num, labels = cv2.connectedComponents(class_mask)
        for k in range(1, num):
            inst = labels == k
            if inst.sum() < 12:
                continue
            ys, xs = np.nonzero(inst)
            polys = _mask_to_polygons(inst)
            if not polys:
                continue
            annotations.append(dict(
                bbox=[int(xs.min()), int(ys.min()),
                      int(xs.max() - xs.min() + 1),
                      int(ys.max() - ys.min() + 1)],
                bbox_mode=1,  # XYWH
                category_id=int(cls) - 1,  # detector ids skip class 0
                segmentation=polys))

    rgb_path = os.path.join(logdir, "images", f"{image_id}-rgb.png")
    os.makedirs(os.path.dirname(rgb_path), exist_ok=True)
    write_png(rgb_path, (rgb * 255).astype(np.uint8))
    write_png(os.path.join(logdir, "images", f"{image_id}-sem.png"),
              sem.astype(np.uint8))
    h, w = sem.shape
    return dict(file_name=rgb_path, image_id=image_id, height=h,
                width=w, annotations=annotations)


def generate(logdir: str, total_tasks: int, poses_per_scene: int,
             camera_size: int = 224, seed0: int = 0) -> int:
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
    from mass_tpu_torch.env.protocol import AgentPose

    camera = CameraConfig(height=camera_size, width=camera_size)
    sampler = GridWorldTaskSampler(
        list(range(seed0, seed0 + total_tasks)), camera=camera)
    os.makedirs(os.path.join(logdir, "annotations"), exist_ok=True)
    rng = np.random.RandomState(seed0)
    image_id = 0
    for _ in range(total_tasks):
        for phase in (sampler.next_task(), sampler.next_task()):
            ep = phase.episode
            sx, _, sz = ep.world.room_size
            for _ in range(poses_per_scene):
                # random reachable pose x rotation x horizon (reference
                # samples the product grid; generate_maskrcnn_dataset.py
                # :174-186)
                for _ in range(50):
                    x = rng.uniform(0.5, sx - 0.5)
                    z = rng.uniform(0.5, sz - 0.5)
                    if not ep.world.blocked(x, z):
                        break
                ep.pose = AgentPose(
                    x=x, y=0.0, z=z,
                    rotation_degrees=float(rng.choice(
                        [0, 90, 180, 270])),
                    horizon_degrees=float(rng.choice([-30, 0, 30, 60])),
                    standing=bool(rng.randint(2)))
                obs = phase.get_observations()
                record = record_from_frame(
                    np.asarray(obs["rgb"]), np.asarray(obs["semantic"]),
                    image_id, logdir)
                with open(os.path.join(
                        logdir, "annotations",
                        f"{image_id}.json"), "w") as f:
                    json.dump(record, f, cls=NumpyJSONEncoder)
                image_id += 1
    return image_id


def format_dataset(logdir: str, validation_fraction: float = 0.05):
    """Merge per-image records into training/validation splits
    (reference: format_maskrcnn_dataset.py)."""
    records = []
    for path in sorted(glob.glob(
            os.path.join(logdir, "annotations", "*.json"))):
        with open(path) as f:
            records.append(json.load(f))
    rng = np.random.RandomState(0)
    order = rng.permutation(len(records))
    n_val = max(1, int(len(records) * validation_fraction))
    val_ids = set(order[:n_val].tolist())
    train = [r for i, r in enumerate(records) if i not in val_ids]
    val = [r for i, r in enumerate(records) if i in val_ids]
    with open(os.path.join(logdir, "training.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(logdir, "validation.json"), "w") as f:
        json.dump(val, f)
    return len(train), len(val)


def main(argv=None):
    p = argparse.ArgumentParser("detector dataset tooling")
    p.add_argument("command", choices=["generate", "format"])
    p.add_argument("--logdir", type=str, required=True)
    p.add_argument("--total-tasks", type=int, default=4)
    p.add_argument("--poses-per-scene", type=int, default=8)
    p.add_argument("--camera-size", type=int, default=224)
    p.add_argument("--validation-fraction", type=float, default=0.05)
    args = p.parse_args(argv)
    if args.command == "generate":
        n = generate(args.logdir, args.total_tasks,
                     args.poses_per_scene, args.camera_size)
        print(f"wrote {n} images to {args.logdir}")
    else:
        tr, va = format_dataset(args.logdir, args.validation_fraction)
        print(f"training.json: {tr} records, validation.json: {va}")


if __name__ == "__main__":
    main()
