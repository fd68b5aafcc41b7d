"""Training of the per-pixel segmentation UNet (port of
``mass_tpu.perception.train_detector``).

Reads the dataset layout of ``tools/detector_dataset.py`` (RGB PNGs and
their class PNGs, split into ``training.json`` and ``validation.json``),
trains ``perception/detector.SegmenterUNet`` with a class-weighted
per-pixel cross-entropy and AdamW (optax's default decay of 1e-4), and
reports mean IoU and pixel accuracy on the validation split after each
epoch.  ``segmenter.pth`` (the port's state dict) runs in the CLI under
``--detector-arch unet --detector-checkpoint``.  As in the JAX package,
``train(devices=...)`` splits each batch over the largest count of those
devices that divides it (``["cpu"] * 4`` four replicas on the CPU), one
replica of the UNet a device (``utils/training.Replicas``).  Unlike the
JAX package, which takes every device, one device is the default: a
replica step is not yet shown faster on several cards.

    python -m mass_tpu_torch.perception.train_detector --dataset d \\
        --epochs 2 --batch-size 8 --logdir /tmp/det
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mass_tpu_torch import resolve_device, taxonomy
from mass_tpu_torch.perception.detector import SegmenterUNet, init_segmenter
from mass_tpu_torch.tools.detector_dataset import read_png
from mass_tpu_torch.utils.checkpoint import save_state_dict
from mass_tpu_torch.utils.training import (Replicas, exact_convs,
                                           largest_divisor)

# optax.adamw's default weight decay (torch's AdamW defaults to 1e-2)
WEIGHT_DECAY = 1e-4


def load_split(dataset_dir: str, split: str = "training"):
    """Images + per-pixel class targets from the detector-dataset layout
    (tools/detector_dataset.py)."""
    with open(os.path.join(dataset_dir, f"{split}.json")) as f:
        records = json.load(f)
    images, targets = [], []
    for rec in records:
        rgb = read_png(rec["file_name"]).astype(np.float32) / 255.0
        sem_path = rec["file_name"].replace("-rgb.png", "-sem.png")
        sem = read_png(sem_path).astype(np.int32)
        images.append(rgb[..., :3])
        targets.append(sem)
    return np.stack(images), np.stack(targets)


def batches(images, targets, batch_size: int,
            rng: np.random.RandomState) -> Iterator[Tuple]:
    """Shuffled full batches (the partial last batch is dropped)."""
    order = rng.permutation(len(images))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        sel = order[i:i + batch_size]
        yield images[sel], targets[sel]


def class_weights(targets: np.ndarray,
                  num_classes: int = taxonomy.NUM_CLASSES) -> np.ndarray:
    """Inverse-sqrt-frequency class weights, mean-normalised: object
    pixels are under 1% of a frame, so plain CE collapses to the
    background classes."""
    freq = np.bincount(targets.reshape(-1).astype(np.int64),
                       minlength=num_classes) + 1
    w = 1.0 / np.sqrt(freq)
    return (w / w.mean()).astype(np.float32)


def weighted_cross_entropy(model: SegmenterUNet, rgb: torch.Tensor,
                           sem: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Mean over pixels of each pixel's softmax cross-entropy times its
    class's weight.  The label is taken by a one-hot product, so the
    backward pass has no scatter."""
    logp = torch.log_softmax(model(rgb), dim=-1)
    onehot = F.one_hot(sem, logp.shape[-1]).to(logp.dtype)
    ce = -(onehot * logp).sum(dim=-1)
    return (ce * weights[sem]).mean()


def make_train_step(model: SegmenterUNet, optimizer: torch.optim.Optimizer,
                    weights=None, devices=None):
    """``step(rgb, sem) -> loss``: one optimizer step (in place) on a
    host batch, forward and backward under :func:`exact_convs`, the batch
    split in order over ``devices`` (default: the model's device), one
    replica a device."""
    device = next(model.parameters()).device
    replicas = Replicas(model, devices or [device])
    num_classes = model.head.out_channels
    w = (torch.as_tensor(weights) if weights is not None
         else torch.ones(num_classes)).to(torch.float32)
    w_on = {d: w.to(d) for d in replicas.devices}

    def losses(replica, rgb, sem):
        return {"total": weighted_cross_entropy(replica, rgb, sem,
                                                w_on[rgb.device])}

    def step(rgb, sem) -> torch.Tensor:
        rgb = torch.as_tensor(np.asarray(rgb, np.float32)).to(device)
        sem = torch.as_tensor(np.asarray(sem)).to(device, torch.long)
        loss, grads = replicas.grads(losses, rgb, sem)
        replicas.set_grads(grads)
        optimizer.step()
        return loss["total"]

    return step


@torch.no_grad()
def evaluate(model: SegmenterUNet, images, targets, batch_size: int = 8):
    """Mean IoU + pixel accuracy over a split, from one confusion matrix
    of counts (true class x predicted class)."""
    device = next(model.parameters()).device
    num_classes = model.head.out_channels
    total = torch.zeros(num_classes * num_classes, dtype=torch.int64,
                        device=device)
    with exact_convs():
        for i in range(0, len(images), batch_size):
            rgb = torch.from_numpy(
                np.asarray(images[i:i + batch_size], np.float32)).to(device)
            sem = torch.from_numpy(np.asarray(
                targets[i:i + batch_size])).to(device, torch.long)
            pred = torch.argmax(model(rgb), dim=-1)
            idx = (sem * num_classes + pred).reshape(-1)
            total += torch.bincount(
                idx, minlength=num_classes * num_classes
            )[:num_classes * num_classes]
    cm = total.cpu().numpy().reshape(num_classes, num_classes)
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - inter
    seen = union > 0
    miou = float((inter[seen] / union[seen]).mean()) if seen.any() \
        else 0.0
    acc = float(inter.sum() / max(cm.sum(), 1))
    return dict(miou=miou, pixel_accuracy=acc)


def train(dataset_dir: str, logdir: str, epochs: int = 1,
          batch_size: int = 8, learning_rate: float = 3e-4,
          seed: int = 0, class_weighting: bool = True, device=None,
          devices=None):
    """Train a UNet from flax's initialisation (``seed``) for ``epochs``
    passes over the training split; writes ``segmenter.pth`` and
    ``history.json`` under ``logdir`` when one is given.  Returns the
    model and the per-epoch metrics.  Each batch splits over the first
    devices of ``devices`` (default: ``device`` alone), as many as the
    largest divisor of the batch allows."""
    device = resolve_device(device if devices is None else devices[0])
    devices = list(devices or [device])
    devices = devices[:largest_divisor(batch_size, len(devices))]
    images, targets = load_split(dataset_dir, "training")
    val = load_split(dataset_dir, "validation")
    model = init_segmenter(torch.Generator().manual_seed(seed)).to(device)
    optimizer = torch.optim.AdamW(model.parameters(), learning_rate,
                                  weight_decay=WEIGHT_DECAY)
    step = make_train_step(
        model, optimizer,
        class_weights(targets) if class_weighting else None, devices)

    rng = np.random.RandomState(seed)
    history = []
    for epoch in range(epochs):
        t0 = time.time()
        losses = []
        for rgb, sem in batches(images, targets, batch_size, rng):
            losses.append(float(step(rgb, sem)))
        metrics = evaluate(model, *val)
        metrics.update(epoch=epoch, loss=float(np.mean(losses)),
                       sec=time.time() - t0)
        history.append(metrics)
        print(metrics)

    if logdir:
        os.makedirs(logdir, exist_ok=True)
        save_state_dict(os.path.join(logdir, "segmenter.pth"),
                        model.state_dict())
        with open(os.path.join(logdir, "history.json"), "w") as f:
            json.dump(history, f, indent=2)
    return model, history


def main(argv=None):
    from mass_tpu_torch.agent.cli import (add_device_flags,
                                          resolve_device_flags)

    p = argparse.ArgumentParser("detector trainer")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-class-weighting", action="store_true")
    add_device_flags(p)
    args = p.parse_args(argv)
    train(args.dataset, args.logdir, args.epochs, args.batch_size,
          args.learning_rate, args.seed,
          class_weighting=not args.no_class_weighting,
          device=resolve_device_flags(args))


if __name__ == "__main__":
    main()
