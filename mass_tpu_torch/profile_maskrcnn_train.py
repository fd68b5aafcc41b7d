"""Where a Mask R-CNN training step's time goes on the card, and a longer
grid-world detector run.

    python -m mass_tpu_torch.profile_maskrcnn_train [--epochs 20]

1. The trainer's step at 224x224 (53 classes, the default ``TrainConfig``)
   on grid-world frames at batch 2 and 8, by stage: the network's forward,
   the targets (matching, sampling and the proposals' one NMS launch), the
   five losses (ROIAlign and the heads), the backward, the optimizer.
   CUDA events between the stages and the host's clock around each step
   (card synced), median of 6 steps after 2; then a ``torch.profiler``
   trace of 3 steps: device operations (kernels and copies) a step and
   the card's busy share (their summed device time over the steps'
   wall).
2. With ``--epochs N``: ``tools/detector_dataset`` at camera 224
   (``--tasks`` tasks, 8 poses a phase, a tenth for validation),
   ``maskrcnn_train`` for N epochs at batch 8 with flips, the fused-mask
   validation score at thresholds 0.5 and 0.9, with and without TTA, and
   the trained ``maskrcnn.pth`` through the CLI's full-width learned
   episode at its default threshold (0.9), counting the frames where a
   detection fused.

Needs a CUDA card; the results also go to
``build/profile_maskrcnn_train.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import time

import numpy as np
import torch

from mass_tpu_torch.perception import maskrcnn as M
from mass_tpu_torch.perception import maskrcnn_train as TR
from mass_tpu_torch.search import prng
from mass_tpu_torch.tools import detector_dataset as DD
from mass_tpu_torch.utils.training import exact_convs

ROOT = os.path.join("build", "profile_maskrcnn_train")
STAGES = ("network", "targets", "losses", "backward", "optimizer")
CLASSES = 53


def _dataset(path: str, tasks: int, validation: float) -> str:
    shutil.rmtree(path, ignore_errors=True)
    with contextlib.redirect_stdout(io.StringIO()):
        DD.main(["generate", "--logdir", path, "--total-tasks", str(tasks),
                 "--poses-per-scene", "8", "--camera-size", "224"])
        DD.main(["format", "--logdir", path, "--validation-fraction",
                 str(validation)])
    return path


def step_split(data, batch_size: int, steps: int = 8) -> dict:
    """One training step's stages on the card (see the module's text)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = M.MaskRCNNConfig(num_classes=CLASSES)
    tcfg = TR.TrainConfig()
    model = TR.init_maskrcnn(torch.Generator().manual_seed(0), cfg).to(dev)
    optimizer = TR.SGD(model.named_parameters(), 0.0025)
    params = list(optimizer.params.values())
    anchors = M.device_anchors(cfg, dev)
    images, boxes, classes, masks, valid = (
        torch.as_tensor(x[:batch_size]).to(dev) for x in data)
    classes, valid = classes.long(), valid.bool()

    def step(key):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(len(STAGES) + 1)]
        marks[0].record()
        with exact_convs():
            maps, rpn = TR.network(model, images)
            marks[1].record()
            targets = TR.sample_targets(cfg, tcfg, anchors, rpn, boxes,
                                        classes, masks, valid,
                                        prng.split(key, batch_size))
            marks[2].record()
            total = sum(v.mean() for v in TR.image_losses(
                model, tcfg, maps, rpn, targets).values())
            marks[3].record()
            grads = torch.autograd.grad(total, params)
            marks[4].record()
        optimizer.step(grads)
        marks[5].record()
        return marks

    keys = prng.split(prng.PRNGKey(0).to(dev), steps)
    stage_ms, host_ms = [], []
    for key in keys:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks = step(key)
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        stage_ms.append([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    stage_ms = np.median(np.asarray(stage_ms[2:]), 0)

    traced = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for key in keys[:traced]:
            step(key)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    return dict(batch=batch_size,
                stages_ms=dict(zip(STAGES, map(float, stage_ms))),
                host_ms=float(np.median(host_ms[2:])),
                device_ops_a_step=len(ops) / traced,
                traced_wall_ms=wall_ms, traced_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms)


class FusedCounter:
    """The fused non-zero pixels of every learned-sensor call."""

    def __enter__(self):
        from mass_tpu_torch.perception.segmentation import \
            DetectorSegmentation

        self.fused = []
        self._semantic = DetectorSegmentation.semantic

        def semantic(sensor, rgb):
            out = self._semantic(sensor, rgb)
            self.fused.extend((out > 0).flatten(-3).sum(-1).reshape(-1)
                              .tolist())
            return out
        DetectorSegmentation.semantic = semantic
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.perception.segmentation import \
            DetectorSegmentation

        DetectorSegmentation.semantic = self._semantic


def long_run(epochs: int, tasks: int) -> dict:
    """Train a grid-world detector for ``epochs`` and use it (see the
    module's text)."""
    from mass_tpu_torch.agent import cli

    data = _dataset(os.path.join(ROOT, "data"), tasks, 0.1)
    logdir = os.path.join(ROOT, "run")
    shutil.rmtree(logdir, ignore_errors=True)
    t0 = time.perf_counter()
    _, history = TR.main(["--dataset", data, "--logdir", logdir, "--epochs",
                          str(epochs), "--batch-size", "8", "--augment",
                          "--eval-every", str(max(epochs // 4, 1))])
    torch.cuda.synchronize()
    out = dict(train_s=time.perf_counter() - t0, history=history)
    for threshold in (0.5, 0.9):
        for tta in (False, True):
            with contextlib.redirect_stdout(io.StringIO()):
                metrics = TR.main(["--dataset", data, "--logdir", logdir,
                                   "--eval-only", "--detection-threshold",
                                   str(threshold)]
                                  + (["--tta"] if tta else []))
            out[f"eval_{threshold}{'_tta' if tta else ''}"] = metrics
    episode = os.path.join(ROOT, "episode")
    with FusedCounter() as counter:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([
                "--backend", "gridworld", "--camera-size", "224",
                "--map-height", "384", "--map-width", "384", "--map-depth",
                "96", "--grid-resolution", "0.05", "--step-size", "5",
                "--obstacle-padding", "4", "--map-slice-start", "20",
                "--map-slice-stop", "48", "--ground-truth-disagreement",
                "--start-task", "2", "--total-tasks", "1",
                "--exploration-budget-one", "5", "--exploration-budget-two",
                "5", "--max-goal-steps", "80", "--max-steps", "250",
                "--detector-checkpoint", os.path.join(logdir, "maskrcnn.pth"),
                "--logdir", episode])
        torch.cuda.synchronize()
    with open(os.path.join(episode, "results", "2.json")) as f:
        results = json.load(f)
    fused = counter.fused
    out["episode"] = dict(
        wall_s=time.perf_counter() - t0, frames=len(fused),
        frames_with_fused=int(sum(f > 0 for f in fused)),
        fused_pixels_mean=float(np.mean(fused)),
        metrics={k: v for k, v in results.items()
                 if k.startswith("unshuffle/")})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser("mask r-cnn training profile")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--tasks", type=int, default=16)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_maskrcnn_train needs a CUDA card")
    data = TR.load_instance_split(
        _dataset(os.path.join(ROOT, "steps"), 2, 0.25), "training",
        TR.TrainConfig().max_gt)
    report = dict(steps=[step_split(data, b) for b in (2, 8)])
    for r in report["steps"]:
        stages = ", ".join(f"{k} {v:.2f}" for k, v in r["stages_ms"].items())
        print(f"[step b{r['batch']}] {stages} ms (CUDA events, median); host "
              f"{r['host_ms']:.2f} ms a step (card synced); "
              f"{r['device_ops_a_step']:.0f} device operations a step, card "
              f"busy "
              f"{r['traced_busy_ms']:.1f} of {r['traced_wall_ms']:.1f} ms "
              f"({100 * r['busy_share']:.1f}%) over 3 traced steps")
    if args.epochs:
        run = report["long_run"] = long_run(args.epochs, args.tasks)
        print(f"[long run] {args.epochs} epochs in {run['train_s']:.1f} s: "
              f"{json.dumps(run['history'])}")
        for key, m in run.items():
            if key.startswith("eval_"):
                print(f"[long run] {key}: mIoU {m['miou']:.4f}, pixel "
                      f"accuracy {m['pixel_accuracy']:.4f}")
        ep = run["episode"]
        print(f"[long run] full-width learned episode at threshold 0.9: "
              f"{ep['wall_s']:.1f} s, detections fused in "
              f"{ep['frames_with_fused']} of {ep['frames']} frames (mean "
              f"{ep['fused_pixels_mean']:.0f} pixels); {ep['metrics']}")
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "profile_maskrcnn_train.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
