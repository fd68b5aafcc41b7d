"""How close the trainers' float32 gradients are to float64, by device.

    python -m mass_tpu_torch.profile_training

For the search policy (4 maps of 24x32x54) and the segmentation UNet (2
frames of 32, 64 and 224 pixels), one loss and its gradients in float64
on the CPU are the reference; each float32 run reports its loss's
relative error and its largest gradient error over the largest gradient,
with the layer where it lies: the CPU, the card under the trainers' flags
(``utils/training.exact_convs``: deterministic cuDNN, TF32 off), the card
with TF32 allowed (the policy) and the card without cuDNN (the UNet).
Then a policy training step at batch 8 on 384x384 maps, with TF32 off
and on (host clock, card synced, median of 5 after 3).  Needs a CUDA
card; the results also go to ``build/profile_training.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from mass_tpu_torch.perception import detector as PD
from mass_tpu_torch.perception import train_detector as TD
from mass_tpu_torch.search import policy as P
from mass_tpu_torch.search import train as ST
from mass_tpu_torch.utils.training import exact_convs


def _tf32():
    return torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                      allow_tf32=True)


def _no_cudnn():
    return torch.backends.cudnn.flags(enabled=False)


def _gradients(model, loss_fn, flags):
    with flags():
        loss = loss_fn()
        loss.backward()
    return loss.item(), {k: p.grad.detach().cpu().double()
                         for k, p in model.named_parameters()}


def _errors(make, loss_of, runs) -> dict:
    """Each run's loss and gradient errors against the float64 CPU."""
    ref = make().double()
    loss64, grads64 = _gradients(
        ref, lambda: loss_of(ref, "cpu", torch.float64),
        contextlib.nullcontext)
    scale = max(float(g.abs().max()) for g in grads64.values())
    out = {}
    for label, device, flags in runs:
        model = make().to(device)
        loss, grads = _gradients(
            model, lambda: loss_of(model, device, torch.float32), flags)
        err = {k: float((grads[k] - grads64[k]).abs().max()) / scale
               for k in grads}
        worst = max(err, key=err.get)
        out[label] = dict(loss_rel_err=abs(loss - loss64) / abs(loss64),
                          grad_err=err[worst], layer=worst)
    return out


def policy_errors() -> dict:
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 24, 32, 54)
                         * (rng.rand(4, 24, 32, 1) < 0.3))
    g = torch.from_numpy(np.stack([rng.randint(0, 32, 4),
                                   rng.randint(0, 24, 4)], -1))
    return _errors(
        lambda: P.init_policy(torch.Generator().manual_seed(0), 54),
        lambda m, dev, dt: ST.goal_cross_entropy(m, x.to(dev, dt),
                                                 g.to(dev), 2.0),
        [("cpu", "cpu", exact_convs), ("cuda", "cuda", exact_convs),
         ("cuda_tf32", "cuda", _tf32)])


def unet_errors(size: int) -> dict:
    rng = np.random.RandomState(1)
    rgb = torch.from_numpy(rng.rand(2, size, size, 3))
    sem = rng.randint(0, 54, (2, size, size))
    sem[:, :size // 2] = 0
    w = torch.from_numpy(TD.class_weights(sem))
    sem = torch.from_numpy(sem)
    return _errors(
        lambda: PD.init_segmenter(torch.Generator().manual_seed(0)),
        lambda m, dev, dt: TD.weighted_cross_entropy(
            m, rgb.to(dev, dt), sem.to(dev), w.to(dev, dt)),
        [("cpu", "cpu", exact_convs), ("cuda", "cuda", exact_convs),
         ("cuda_no_cudnn", "cuda", _no_cudnn)])


def policy_step_ms() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((8, 384, 384, 54), device=dev, generator=gen)
    g = torch.randint(0, 384, (8, 2), device=dev, generator=gen)
    out = {}
    for label, flags in (("exact", exact_convs), ("tf32", _tf32)):
        model = P.init_policy(torch.Generator().manual_seed(0), 54).to(dev)
        times = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with flags():
                ST.goal_cross_entropy(model, x, g, 2.0).backward()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[label] = float(np.median(times[3:]))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA card")
    report = dict(policy=policy_errors(),
                  unet={size: unet_errors(size) for size in (32, 64, 224)},
                  policy_step_ms=policy_step_ms())
    for name, runs in [("policy", report["policy"])] + [
            (f"unet {size}", r) for size, r in report["unet"].items()]:
        for label, r in runs.items():
            print(f"[{name}] {label}: loss {r['loss_rel_err']:.2e} "
                  f"relative, largest gradient error {r['grad_err']:.2e} "
                  f"of the largest gradient ({r['layer']})")
    ms = report["policy_step_ms"]
    print(f"[policy step 384x384 b8] TF32 off {ms['exact']:.2f} ms, "
          f"TF32 on {ms['tf32']:.2f} ms (host clock, card synced)")
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "profile_training.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
