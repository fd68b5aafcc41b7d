"""Smoke run of mass_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's five kernels from the sources in this checkout, one
``nvcc`` a source, in parallel (the single-map, multi-map and frames
kernels share ``csrc/splat_onehot.cu``; the dense-row splat has
``csrc/splat_dense.cu``, the greedy NMS ``csrc/nms.cu``), holds each
splat kernel against its plain PyTorch
version at the shapes its path gives it (the single-map and multi-map
kernels on one full 224x224 room frame into 384x384x96 maps, and on a
frame 0.3 m from a wall whose runs outgrow a tile, and on a stream of
more tiles than the persistent grid has blocks; the frames kernel on
bench.py's 128-frame stream in groups of 8, and on 8 frames of a wall
0.30-0.37 m ahead whose sub-runs cross tile ends), runs the default and
the ``--reference-compat`` two-phase episodes
on the card at a small geometry (and on the CPU, which must give equal results),
then both episodes at full width (384x384x96 voxels x 54 classes,
224x224 camera) through ``python -m mass_tpu_torch.agent.cli``'s entry
point, with the kernels' launch counts set to 0 before each path and
read after it.  Then the lockstep fleet: ``FleetMaps`` of 8 full-width
episodes (three families in [8V, F] buffers, 49 GB) through an
unmasked and a mixed-mask step, held bit for bit against single-map
kernel updates of two episodes' slabs; B = 2 fleets of the small
episodes on the card and the CPU against the sequential agent; and
``--fleet-size 4`` (default) and ``--fleet-size 2`` (compat) at full
width through the CLI, whose task 2 must equal the sequential full-width
episode, with every group splat accounted for by one kernel launch.
Then the goal heads: one policy goal at full width by part (``[policy]``:
max over depth, the five convs against their bound, the Gumbel-max draw,
the inhibited decode); A (frontier + revisit), B (the conditioned policy
with inhibition) and C (one-phase with the plain policy) small on the
card and the CPU (equal results; C launches twice a step while it
explores) and at full width through the CLI; B = 2 small fleets of each;
and a full-width ``--fleet-size 2`` fleet of B whose task 2 must equal
the sequential B episode.  Then feature matching: the dense-row splat
(``csrc/splat_dense.cu``, a second library) on one room frame's stride-4
records into a 384x384x96x256 map (13.5 GiB), on a wall frame with long
runs and on a stream of many runs, bit-equal to its plain CPU version on
the touched rows; the stage-1 ResNet on one 224x224 frame against its
bound; tasks 0 and 2 of
the frozen feature-matching protocol (``experiments/fm/run_arm.sh``) on
the card and the CPU (equal; task 0 equal to the committed record); the
full-width feature episode (two 13.5 GiB feature maps) with its mapping
split; and B = 2 feature fleets, small (equal to the sequential episodes)
and at full width (task 2 equal to the sequential feature episode).
Then learned segmentation: the greedy-NMS kernel (``csrc/nms.cu``, a
third library) against the plain loop on the CPU, keep indices exact, on
the detector's own problems (the RPN's five levels of one frame and of
eight, the class-aware NMS) and on the chosen streams of
``tests/torch_streams.py``; the full-width Mask R-CNN (224x224, 54
classes, random detectron2-layout weights written from a seed to
``build/chip_smoke/maskrcnn-rand.pth``) on one frame and on two, the card
against the CPU by the margin rule of ``tests/torch_margins.py``, with
ms a frame by stage; a small learned episode on the card and the CPU
(equal); the full-width learned episode through the CLI
(``--detector-checkpoint``), and a ``--fleet-size 2 --seed -2`` learned
fleet whose task 2 must equal it.  Then training: the search-data
collector (``python -m mass_tpu_torch.search.dataset``) over tasks 0-7
at its defaults on the card, task 0 again on the CPU (equal cells and
counts, snapshots within one float16 ulp), every frame one group splat
and one launch (the walkthrough's pair on the multi-map kernel, the
unshuffle's map on the single-map kernel), and one task at full width;
``search.train.fit`` at its defaults, plain and ``--conditioned``, twice
on the card (bit-equal) with its first steps against the CPU, each
``.pth`` through a small ``--policy-checkpoint`` episode; the policy's
training step at batch 8 on the full-width snapshots against its FLOP
bound; the UNet: ``detector_dataset`` at camera 224, two epochs of
``train_detector`` on the card, its ``segmenter.pth`` through a small
``--detector-arch unet`` episode; and the Mask R-CNN trainer at full
width (R50-FPN, 224x224, 53 classes, the default ``TrainConfig``) on
that dataset: one step at batch 2 against float64 on the CPU (targets by
the margin rule, losses and gradients), a fixed batch's loss falling
over 8 steps, ms a step at batch 2 and 8 against the FLOP bound, the
entry point twice on 8 images (byte-equal ``maskrcnn.pth``; the NMS
launches it makes count into the ``nms`` entry), ``--eval-only`` with
and without ``--tta``, and its ``maskrcnn.pth`` through a small
``--detector-checkpoint`` episode.  Then the tooling: the small default
episode with ``--videos --snapshot-maps`` and the compat episode (the
multi-map kernel) with both on the card and on the CPU (equal results,
frames within one level, npz bit-equal, the mp4 decoded back), a
``--fleet-size 2 --snapshot-maps`` run whose npz files equal the
sequential runs' and whose results carry ``task_id``; the full-width
default episode with ``--videos --snapshot-maps`` (the outcome without
them; render and snapshot times, npz size, peak memory); two 40-frame
captures of ``python -m mass_tpu_torch.env.replay`` (``diff``:
IDENTICAL), ``verify`` at 80x80x24 on the card and the CPU (equal
digests) and at full width on the card (two single-map launches a
frame); ``--backend thor`` on a grid-backed fake of the THOR stack
(``tests/torch_fake_thor.py``), sequential and ``--fleet-size 2``,
against ``--backend gridworld``; and ``tools.analyze`` and
``tools.submission`` over the logdirs those phases wrote.  Then more
than one device, with slabs and replicas on distinct cards where the
machine has them and on ``cuda:0`` repeated where it has one: the room
frame into a 384x384x96x54 map cut into 2 and 4 row slabs (one launch a
slab, bit-equal to the unsharded map, the slab launches timed together)
and the dense splat into a 384x384x96x256 map in 2 slabs (bit-equal);
the small default episode in 4 slabs on the card and the CPU (equal to
the unsharded episode); the full-width default episode in 2 slabs (its
outcome that of the unsharded one, two launches a map update); a B = 3
small fleet in 4 slabs against the unsharded fleet; and the
data-parallel trainers on 2 replicas (the policy fit, the UNet step and
the Mask R-CNN step against one device, two runs bit-equal).

Exits non-zero when there is no CUDA card, when a kernel fails to build,
launch or agree, or when any phase fails.  The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details also go to ``build/chip_smoke/report.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS = 67e12              # H100 SXM float32 outside tensor cores
SPLAT_TOL = 1e-5
# the kernels' times before their redesign as one tile-staged body (one
# warp per run or voxel, a shuffle per record; NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md)
BEFORE_MS = {"splat_onehot": 0.0289, "splat_onehot_multi": 0.0496,
             "splat_onehot_frames": 0.668}

# full width: the port's default map (config.MapGeometry) and camera
FULL_MAP = dict(map_height=384, map_width=384, map_depth=96,
                feature_size=54, grid_resolution=0.05)
CAMERA = 224

# full width: the CLI's default geometry and budgets (no depth cut)
FULL_ARGS = [
    "--backend", "gridworld", "--camera-size", "224",
    "--map-height", "384", "--map-width", "384", "--map-depth", "96",
    "--grid-resolution", "0.05", "--step-size", "5",
    "--obstacle-padding", "4", "--map-slice-start", "20",
    "--map-slice-stop", "48", "--ground-truth-segmentation",
    "--ground-truth-disagreement", "--start-task", "2",
    "--total-tasks", "1"]
FULL_BUDGETS = ["--exploration-budget-one", "5",
                "--exploration-budget-two", "5", "--max-goal-steps", "80",
                "--max-steps", "250"]
# bench.py's frame stream: 128 frames folded in groups of 8
BENCH_FRAMES, BENCH_GROUP = 128, 8


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``iters`` calls, each timed with
    CUDA events after writing ``flush`` (larger than L2) so every call
    starts with a cold cache, as it does between frames.  A device-side
    sleep after the flush keeps the card busy while the host enqueues
    ``fn``, so the events bracket the device's work rather than the
    host's launch latency (a ``fn`` that synchronises inside, as the
    plain version does, still includes its host time); the median keeps
    out the calls where a stall of the shared host outlasted the sleep."""
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, iters: int) -> float:
    """Mean host time of ``fn`` up to a card sync, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def profiled_launches(fn, iters: int, flush: torch.Tensor,
                      kernel: str = "splat_onehot_kernel",
                      per_call: int = 1) -> dict:
    """``kernel``'s device time per recorded launch in a torch.profiler
    trace of ``iters`` calls of ``fn`` (cold L2, no launch latency), the
    launches the trace recorded and those made (``per_call`` a call): a
    trace can miss launches, so the time is never divided by the calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in hits)
    total = sum(e.device_time_total for e in hits)
    return dict(device_ms=total / 1e3 / max(count, 1),
                profiled_launches=count, launches_made=iters * per_call)


def recorded(k: dict) -> str:
    """The launches a trace recorded against those made."""
    return (f"profiler: {k['profiled_launches']} of {k['launches_made']} "
            "launches recorded")


def bound(bytes_moved: int, flops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = flops / FP32_FLOPS
    return dict(bound_ms=1e3 * max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=bytes_moved, flops=flops)


def room_frame(camera: int, rng: np.random.RandomState, yaw: float = 0.3):
    """Depth of a 6 m x 6 m walled room with a floor 1.5 m below the
    camera, seen from its centre looking down 30 degrees, plus random
    class ids (the splat treats every pixel alike)."""
    from mass_tpu_torch.core import geometry as G

    f = camera / 2.0      # 90 degree field of view
    elevation = -np.pi / 6
    rays = G.orient_rays(G.camera_rays(camera, camera, f, f), yaw,
                         elevation).numpy().astype(np.float64)
    t = np.full(rays.shape[:2], np.inf)
    for axis, plane in ((0, 3.0), (0, -3.0), (1, 3.0), (1, -3.0),
                        (2, -1.5)):
        with np.errstate(divide="ignore", invalid="ignore"):
            ti = plane / rays[..., axis]
        t = np.where((ti > 0) & (ti < t), ti, t)
    depth = np.minimum(t, 9.0).astype(np.float32)[..., None]
    classes = rng.randint(0, 54, (camera, camera)).astype(np.int32)
    return yaw, elevation, depth, classes


def wall_frame(camera: int, distance: float = 0.3):
    """Depth of a flat wall ``distance`` metres in front of the camera
    (level, yaw 0.3): a frame whose records crowd into a few hundred
    voxels, so runs hold about a thousand records each."""
    from mass_tpu_torch.core import geometry as G

    yaw, elevation = 0.3, 0.0
    rays = G.orient_rays(G.camera_rays(camera, camera, camera / 2,
                                       camera / 2), yaw,
                         elevation).numpy().astype(np.float64)
    normal = rays[camera // 2, camera // 2]
    normal = normal / np.linalg.norm(normal)
    depth = (distance / (rays @ normal)).astype(np.float32)[..., None]
    return yaw, elevation, depth


def run_lengths(records, num_voxels: int):
    """(valid records, touched voxels, longest run) of sorted records."""
    ids, counts = torch.unique_consecutive(records.ids, return_counts=True)
    valid = counts[ids < num_voxels]
    return (int(valid.sum()), int(valid.shape[0]),
            int(valid.max()) if valid.numel() else 0)


def record_prep_ms(ids, weights, classes, flush) -> dict:
    """The two steps of one frame's record prep, timed apart: the stable
    sort (int32 ids) and the gathers of weights and every map's
    classes."""
    from mass_tpu_torch.ops import splat as SP

    ids_s, order = SP.sort_ids(ids)
    return dict(
        sort_ms=cuda_ms(lambda: SP.sort_ids(ids), 20, flush),
        gather_ms=cuda_ms(lambda: SP.gather_records(ids_s, order, weights,
                                                    classes), 20, flush))


def splat_bound(valid_records: int, touched: int, features) -> dict:
    """What the single- or multi-map kernel must read and write: per
    valid record its int32 id, weight and one class per map (8 + 4M B),
    per touched voxel each map's row read and written once; per record
    w*w and 2 + M adds, per row element 2 mul + 1 add."""
    return bound((8 + 4 * len(features)) * valid_records
                 + sum(2 * 4 * f for f in features) * touched,
                 (3 + len(features)) * valid_records
                 + 3 * sum(features) * touched)


def check_splat(name: str, datas, records, iws) -> dict:
    """One kernel (single-map for one map, else multi-map) against its
    plain version on the card (tolerance) and on the CPU (bit for bit),
    and against itself (bit for bit)."""
    from mass_tpu_torch.ops import splat as SP

    if len(datas) == 1:
        def run(maps, recs):
            return [SP.apply_records(maps[0], recs, iws[0])]

        def plain(maps, recs):
            return [SP.splat_onehot_reference(maps[0], recs, iws[0])]
    else:
        def run(maps, recs):
            return SP.apply_records_multi(maps, recs, iws)

        def plain(maps, recs):
            return SP.splat_onehot_multi_reference(maps, recs, iws)
    out1 = run([d.clone() for d in datas], records)
    out2 = run([d.clone() for d in datas], records)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(out1, out2))
    del out2
    ref = plain([d.clone() for d in datas], records)
    torch.cuda.synchronize()
    max_err = max(float((a - b).abs().max()) for a, b in zip(out1, ref))
    del ref
    changed = max(float((a - d).abs().max()) for a, d in zip(out1, datas))
    cpu = plain([d.to("cpu", copy=True) for d in datas],
                SP.Records(*(t.cpu() for t in records)))
    cpu_equal = all(torch.equal(a.cpu(), b) for a, b in zip(out1, cpu))
    del cpu
    check(changed > 0, f"{name}: the kernel changed nothing")
    check(max_err <= SPLAT_TOL,
          f"{name}: kernel vs plain max abs diff {max_err} > {SPLAT_TOL}")
    check(identical, f"{name}: two kernel runs differ")
    check(cpu_equal, f"{name}: kernel differs bitwise from the plain CPU "
          "version")
    return dict(out=out1, max_abs_err=max_err, tolerance=SPLAT_TOL,
                bit_identical_runs=identical, bitwise_equal_cpu_plain=True,
                run=run, plain=plain)


def time_splat(checked: dict, records, flush) -> dict:
    """Kernel and plain version, each on the checked maps, cold L2."""
    scratch = checked.pop("out")
    run, plain = checked.pop("run"), checked.pop("plain")
    for _ in range(3):
        run(scratch, records)
        plain(scratch, records)
    kernel_ms = cuda_ms(lambda: run(scratch, records), 20, flush)
    plain_ms = cuda_ms(lambda: plain(scratch, records), 20, flush)
    del scratch
    return dict(checked, ms=kernel_ms, plain_ms=plain_ms, library_ms=None)


def full_geometry_frame(dev, seed: int, frame=None):
    """One 224x224 frame's corner records at full geometry (the room
    frame unless ``frame`` gives (yaw, elevation, depth)), random
    classes, and a 384x384x96x54 map of random values."""
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core import geometry as G
    from mass_tpu_torch.core.voxelmap import VoxelMap

    geo = MapGeometry(**FULL_MAP)
    rng = np.random.RandomState(seed)
    yaw, elevation, depth, classes = room_frame(CAMERA, rng)
    if frame is not None:
        yaw, elevation, depth = frame
    vm = VoxelMap.create(geo, (0.0, 0.0, 0.0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vm.data.copy_(torch.rand(vm.data.shape, generator=gen, device=dev))
    rays = G.camera_rays(CAMERA, CAMERA, CAMERA / 2, CAMERA / 2, device=dev)
    ids, weights = vm.contributions(
        rays, torch.zeros(3, device=dev), yaw, elevation,
        torch.as_tensor(depth, device=dev))
    return geo, vm, ids, weights, torch.as_tensor(classes, device=dev)


def phase_kernel_full_geometry(dev) -> dict:
    """The single-map kernel against its plain version at full geometry:
    the room frame into a 384x384x96x54 map of random values."""
    from mass_tpu_torch.ops import splat as SP

    geo, vm, ids, weights, classes = full_geometry_frame(dev, 0)
    records = SP.sorted_records(ids, weights, classes)
    valid_records, touched, longest = run_lengths(records, geo.num_voxels)
    check(touched > 1000, f"synthetic frame touched {touched} voxels")
    checked = check_splat("splat", [vm.data], records, (0.5,))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    result = time_splat(checked, records, flush)
    prep = record_prep_ms(ids, weights, [classes.reshape(-1)], flush)
    del flush, vm
    torch.cuda.empty_cache()
    return dict(result, records=int(ids.shape[0]),
                valid_records=valid_records, touched_voxels=touched,
                longest_run=longest, before_ms=BEFORE_MS["splat_onehot"],
                **prep,
                **splat_bound(valid_records, touched, [geo.feature_size]))


def phase_multi_full_geometry(dev) -> dict:
    """The multi-map kernel against its plain version at full geometry:
    occupancy [V, 1] and semantic [V, 54] maps of random values, one
    room frame with random classes, EMA weights 0.5 and 0.25; each map
    also equals the single-map kernel on its own classes."""
    from mass_tpu_torch.ops import splat as SP

    geo, sem, ids, weights, classes = full_geometry_frame(dev, 1)
    gen = torch.Generator(device=dev).manual_seed(2)
    occ = torch.rand((geo.num_voxels, 1), generator=gen, device=dev)
    group = [torch.zeros(CAMERA * CAMERA, dtype=torch.int32, device=dev),
             classes.reshape(-1)]
    iws = (0.5, 0.25)
    records = SP.sorted_records_multi(ids, weights, group)
    valid_records, touched, longest = run_lengths(records, geo.num_voxels)
    datas = [occ, sem.data]
    checked = check_splat("multi splat", datas, records, iws)
    single_equal = True
    for m, data in enumerate(datas):
        single = SP.apply_records(data.clone(), records._replace(
            classes=records.classes[m].contiguous()), iws[m])
        single_equal &= bool(torch.equal(checked["out"][m], single))
        del single
    check(single_equal,
          "multi-map kernel differs bitwise from the single-map kernel")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    result = time_splat(checked, records, flush)
    prep = record_prep_ms(ids, weights, group, flush)
    features = [d.shape[1] for d in datas]
    del flush, sem, occ, datas
    torch.cuda.empty_cache()
    return dict(result, maps=features, interpolation_weights=iws,
                records=int(ids.shape[0]), valid_records=valid_records,
                touched_voxels=touched, longest_run=longest,
                bitwise_equal_single_kernel=single_equal,
                before_ms=BEFORE_MS["splat_onehot_multi"], **prep,
                **splat_bound(valid_records, touched, features))


def phase_skewed_frame(dev) -> dict:
    """Both entries of the single/multi-map kernel on a frame 0.3 m from
    a wall at full geometry, where runs hold about a thousand records and
    most cross a tile's end: bit-equal to the plain CPU version."""
    from mass_tpu_torch.ops import splat as SP

    geo, sem, ids, weights, classes = full_geometry_frame(
        dev, 3, wall_frame(CAMERA))
    gen = torch.Generator(device=dev).manual_seed(4)
    occ = torch.rand((geo.num_voxels, 1), generator=gen, device=dev)
    group = [torch.zeros(CAMERA * CAMERA, dtype=torch.int32, device=dev),
             classes.reshape(-1)]
    single = SP.sorted_records(ids, weights, classes)
    multi = SP.sorted_records_multi(ids, weights, group)
    valid_records, touched, longest = run_lengths(single, geo.num_voxels)
    check(longest > SP.tile_records(),
          f"the wall frame's longest run is {longest} records")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    one = time_splat(check_splat("skewed splat", [sem.data], single,
                                 (0.5,)), single, flush)
    two = time_splat(check_splat("skewed multi splat", [occ, sem.data],
                                 multi, (0.5, 0.25)), multi, flush)
    del flush, sem, occ
    torch.cuda.empty_cache()
    return dict(records=int(ids.shape[0]), valid_records=valid_records,
                touched_voxels=touched, longest_run=longest, single=one,
                multi=two)


def phase_many_tiles(dev) -> dict:
    """Both entries of the single/multi-map kernel on a stream of three
    times as many tiles as the card holds blocks (an SM holds at most 32),
    so every block of the persistent grid sums three or more tiles
    through both stage buffers: random sorted ids over a grid of one
    voxel per ten records (runs cross tile ends all along), bit-equal to
    the plain CPU version."""
    from mass_tpu_torch.ops import splat as SP

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = 3 * sms * 32
    num_records = tiles * SP.tile_records() + 517
    num_voxels = num_records // 10
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, num_voxels + 1, (num_records,), generator=gen,
                        device=dev, dtype=torch.int32).sort().values
    weights = torch.rand(num_records, generator=gen, device=dev)
    classes = torch.randint(-1, 56, (num_records,), generator=gen,
                            device=dev, dtype=torch.int32)
    sem = torch.rand((num_voxels, 54), generator=gen, device=dev)
    occ = torch.rand((num_voxels, 1), generator=gen, device=dev)
    single = SP.Records(ids, weights, classes)
    multi = SP.Records(ids, weights,
                       torch.stack([torch.zeros_like(classes), classes]))
    valid_records, touched, longest = run_lengths(single, num_voxels)
    out = {}
    for key, datas, records, iws in (
            ("single", [sem], single, (0.5,)),
            ("multi", [occ, sem], multi, (0.5, 0.25))):
        checked = check_splat(f"many-tile {key} splat", datas, records, iws)
        out[key] = {k: v for k, v in checked.items()
                    if k not in ("out", "run", "plain")}
        del checked
    del sem, occ, single, multi, ids, weights, classes
    torch.cuda.empty_cache()
    return dict(tiles=tiles, records=num_records,
                valid_records=valid_records, touched_voxels=touched,
                longest_run=longest, **out)


def bench_frames(dev, rng: np.random.RandomState, k: int, camera: int,
                 num_classes: int = 54):
    """``k`` frames drawn as bench.py draws them (positions, yaws,
    elevations, per-pixel depths, per-pixel classes), on the card."""
    def put(a):
        return torch.as_tensor(a, device=dev)
    return (put(rng.uniform(-1, 1, (k, 3)).astype(np.float32)),
            put(rng.uniform(-np.pi, np.pi, k).astype(np.float32)),
            put(rng.uniform(-0.6, 0.0, k).astype(np.float32)),
            put(rng.uniform(0.3, 4.0, (k, camera, camera, 1)).astype(
                np.float32)),
            put(rng.randint(0, num_classes, (k, camera, camera)).astype(
                np.int32)))


def frame_stats(records, num_voxels: int) -> dict:
    """Valid records, touched voxels, valid (voxel, frame) sub-runs,
    longest run and sub-run, and the valid sub-runs that cross a tile's
    end, of sorted frame records."""
    from mass_tpu_torch.ops import splat as SP

    ids = records.ids.long()
    frames = records.frames.long()
    key = ids * (int(frames.max()) + 1) + frames
    runs, run_counts = torch.unique_consecutive(ids, return_counts=True)
    subs, sub_counts = torch.unique_consecutive(key, return_counts=True)
    run_valid = (runs >= 0) & (runs < num_voxels)
    sub_valid = (subs >= 0) & (subs // (int(frames.max()) + 1) < num_voxels)
    first = torch.cumsum(sub_counts, 0) - sub_counts
    tile = SP.tile_records()
    across = (first // tile != (first + sub_counts - 1) // tile) & sub_valid
    return dict(valid_records=int(run_counts[run_valid].sum()),
                touched_voxels=int(run_valid.sum()),
                sub_runs=int(sub_valid.sum()),
                longest_run=int(run_counts[run_valid].max()),
                longest_sub_run=int(sub_counts[sub_valid].max()),
                sub_runs_across_tiles=int(across.sum()))


def frames_bound(stats: dict, num_features: int) -> dict:
    """What the frames kernel must read and write: per valid record its
    int32 id, weight, class and frame (16 B), per touched voxel its row
    read and written once for all frames; per record w*w and three adds,
    per (voxel, frame) sub-run's blend 2 mul + 1 add per class."""
    return bound(16 * stats["valid_records"]
                 + 2 * 4 * num_features * stats["touched_voxels"],
                 4 * stats["valid_records"]
                 + 3 * num_features * stats["sub_runs"])


def check_frames(name: str, data, records) -> dict:
    """The frames kernel against its plain version on the card
    (tolerance) and on the CPU (bit for bit), and against itself (bit
    for bit)."""
    from mass_tpu_torch.ops import splat as SP

    out = SP.apply_frame_records(data.clone(), records, 0.5)
    again = SP.apply_frame_records(data.clone(), records, 0.5)
    torch.cuda.synchronize()
    identical = bool(torch.equal(out, again))
    del again
    ref = SP.splat_onehot_frames_reference(data.clone(), records, 0.5)
    torch.cuda.synchronize()
    max_err = float((out - ref).abs().max())
    del ref
    changed = float((out - data).abs().max())
    cpu = SP.splat_onehot_frames_reference(
        data.to("cpu", copy=True), SP.FrameRecords(
            *(t.cpu() for t in records)), 0.5)
    cpu_equal = bool(torch.equal(out.cpu(), cpu))
    del cpu, out
    check(changed > 0, f"{name}: the frames kernel changed nothing")
    check(max_err <= SPLAT_TOL, f"{name}: frames kernel vs plain max abs "
          f"diff {max_err} > {SPLAT_TOL}")
    check(identical, f"{name}: two frames-kernel runs differ")
    check(cpu_equal, f"{name}: the frames kernel differs bitwise from the "
          "plain CPU version")
    return dict(max_abs_err=max_err, tolerance=SPLAT_TOL,
                bit_identical_runs=identical, bitwise_equal_cpu_plain=True)


def time_frames(data, records, flush) -> dict:
    """The frames kernel (events and profiler device time) and its plain
    version on ``data``, cold L2."""
    from mass_tpu_torch.ops import splat as SP

    scratch = data.clone()
    for _ in range(3):
        SP.apply_frame_records(scratch, records, 0.5)
    result = dict(
        ms=cuda_ms(lambda: SP.apply_frame_records(scratch, records, 0.5),
                   20, flush),
        **profiled_launches(
            lambda: SP.apply_frame_records(scratch, records, 0.5), 20,
            flush),
        plain_ms=cuda_ms(lambda: SP.splat_onehot_frames_reference(
            scratch, records, 0.5), 3, flush),
        library_ms=None)
    del scratch
    return result


def phase_frames(dev) -> dict:
    """The frames path: bench.py's 128 frames (seed 0) folded into a
    384x384x96x54 map through VoxelMap.update_classes_frames in groups
    of 8 (its main path, counted), held bit for bit against 128
    update_classes calls on the single-map kernel; then the kernel on one
    group's records against its plain version, timed, with its prep and
    the group's binning; prep and launch under sync debug mode
    "error"."""
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core import geometry as G
    from mass_tpu_torch.core.voxelmap import VoxelMap
    from mass_tpu_torch.ops import splat as SP

    geo = MapGeometry(**FULL_MAP)
    frames = bench_frames(dev, np.random.RandomState(0), BENCH_FRAMES,
                          CAMERA)
    rays = G.camera_rays(CAMERA, CAMERA, CAMERA / 2, CAMERA / 2, device=dev)

    def fold_frames(vm):
        for g in range(0, BENCH_FRAMES, BENCH_GROUP):
            vm.update_classes_frames(rays, *(x[g:g + BENCH_GROUP]
                                             for x in frames))

    def fold_sequential(vm):
        positions, yaws, elevations, depths, classes = frames
        for t in range(BENCH_FRAMES):
            vm.update_classes(rays, positions[t], float(yaws[t]),
                              float(elevations[t]), depths[t], classes[t])

    # warm both routes (allocator, first launches) on a throwaway map
    warm = VoxelMap.create(geo, (0.0, 0.0, 0.0), device=dev)
    warm.update_classes_frames(rays, *(x[:BENCH_GROUP] for x in frames))
    warm.update_classes(rays, frames[0][0], float(frames[1][0]),
                        float(frames[2][0]), frames[3][0], frames[4][0])
    del warm
    batched = VoxelMap.create(geo, (0.0, 0.0, 0.0), device=dev)
    seq = VoxelMap.create(geo, (0.0, 0.0, 0.0), device=dev)
    torch.cuda.synchronize()
    SP.FRAMES_LAUNCHES = 0                  # frames path starts here
    t0 = time.perf_counter()
    fold_frames(batched)
    torch.cuda.synchronize()
    frames_s = time.perf_counter() - t0
    launches = SP.FRAMES_LAUNCHES           # frames path ends here
    t0 = time.perf_counter()
    fold_sequential(seq)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    equal = bool(torch.equal(batched.data, seq.data))
    check(launches == BENCH_FRAMES // BENCH_GROUP,
          f"{launches} frames-kernel launches for "
          f"{BENCH_FRAMES // BENCH_GROUP} groups")
    check(float(batched.data.abs().max()) > 0, "the frames path changed "
          "nothing")
    check(equal, "the frames route differs bitwise from sequential "
          "single-map updates")
    del seq

    # one group's records, folded onto the filled map
    positions, yaws, elevations, depths, classes = (x[:BENCH_GROUP]
                                                    for x in frames)
    ids, weights = batched.contributions_frames(rays, positions, yaws,
                                                elevations, depths)
    cls = classes.reshape(BENCH_GROUP, -1)
    records = SP.sorted_frame_records(ids, weights, cls)
    stats = frame_stats(records, geo.num_voxels)
    checked = check_frames("frames", batched.data, records)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed = time_frames(batched.data, records, flush)
    # the prep in its two steps, no cut and no host sync
    flat = ids.reshape(-1)
    ids_s, order = SP.sort_ids(flat)
    prep = dict(
        sort_ms=cuda_ms(lambda: SP.sort_ids(flat), 20, flush),
        gather_ms=cuda_ms(lambda: SP.gather_frame_records(
            ids_s, order, weights, cls), 20, flush),
        prep_ms=cuda_ms(lambda: SP.sorted_frame_records(ids, weights, cls),
                        20, flush))
    binning = dict(
        group_binning_ms=host_ms(lambda: batched.contributions_frames(
            rays, positions, yaws, elevations, depths), 10),
        per_frame_binning_ms=host_ms(lambda: [batched.contributions(
            rays, positions[t], float(yaws[t]), float(elevations[t]),
            depths[t]) for t in range(BENCH_GROUP)], 10))
    # prep and launch enqueue with no host sync
    scratch = batched.data.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        SP.splat_onehot_frames(scratch, ids, weights, cls, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del scratch, flush, batched
    torch.cuda.empty_cache()
    return dict(frames=BENCH_FRAMES, group=BENCH_GROUP, launches=launches,
                bitwise_equal_sequential=equal,
                frames_route_s=frames_s, sequential_route_s=seq_s,
                frames_route_fps=BENCH_FRAMES / frames_s,
                sequential_route_fps=BENCH_FRAMES / seq_s,
                group_records=int(ids.numel()), **stats, **checked, **timed,
                **prep, **binning, sync_free_prep_and_launch=True,
                before_ms=BEFORE_MS["splat_onehot_frames"],
                **frames_bound(stats, geo.feature_size))


def phase_wall_frames(dev) -> dict:
    """The frames kernel on 8 frames of a flat wall 0.30-0.37 m ahead at
    full geometry, binned as one group: runs of thousands of records with
    several frames' sub-runs, many across a tile's end; bit-equal to the
    plain CPU version."""
    from mass_tpu_torch.core import geometry as G
    from mass_tpu_torch.ops import splat as SP

    walls = [wall_frame(CAMERA, 0.30 + 0.01 * t) for t in range(BENCH_GROUP)]
    geo, vm, _, _, _ = full_geometry_frame(dev, 6)
    rays = G.camera_rays(CAMERA, CAMERA, CAMERA / 2, CAMERA / 2, device=dev)
    ids, weights = vm.contributions_frames(
        rays, torch.zeros(BENCH_GROUP, 3, device=dev),
        torch.tensor([y for y, _, _ in walls], device=dev),
        torch.tensor([e for _, e, _ in walls], device=dev),
        torch.as_tensor(np.stack([d for _, _, d in walls]), device=dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    cls = torch.randint(0, geo.feature_size, (BENCH_GROUP, CAMERA * CAMERA),
                        generator=gen, device=dev, dtype=torch.int32)
    records = SP.sorted_frame_records(ids, weights, cls)
    stats = frame_stats(records, geo.num_voxels)
    check(stats["sub_runs_across_tiles"] > 0 and
          stats["longest_run"] > SP.tile_records(),
          f"the wall frames' sub-runs cross no tile end: {stats}")
    checked = check_frames("wall frames", vm.data, records)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed = time_frames(vm.data, records, flush)
    del flush, vm
    torch.cuda.empty_cache()
    return dict(records=int(ids.numel()), **stats, **checked, **timed,
                **frames_bound(stats, geo.feature_size))


# the goal heads: A, frontier walkthrough and revisit unshuffle; B, the
# conditioned policy on both phases with inhibition; C, one-phase with the
# plain policy and Gumbel-max sampling (the committed .pth checkpoints)
HEAD_FLAGS = {
    "A": ["--frontier-exploration", "--revisit-exploration"],
    "B": ["--frontier-exploration", "--semantic-search-walkthrough",
          "--semantic-search-unshuffle", "--policy-checkpoint",
          "mass_tpu_torch/checkpoints/policy-conditioned-multiroom.pth",
          "--policy-inhibition-radius", "8"],
    "C": ["--one-phase", "--semantic-search-unshuffle", "--policy-checkpoint",
          "mass_tpu_torch/checkpoints/policy-gridworld.pth"],
}
HEAD_FIELDS = ("frontier_exploration", "revisit_exploration", "one_phase",
               "semantic_search_walkthrough", "semantic_search_unshuffle",
               "policy_inhibition_radius")


def head_fields(head: str):
    """The head's config fields, read from its CLI flags the way
    ``python -m mass_tpu_torch.agent.cli`` reads them."""
    from mass_tpu_torch.agent import cli

    config = cli.config_from_args(cli.build_parser().parse_args(
        HEAD_FLAGS[head]))
    return {f: getattr(config, f) for f in HEAD_FIELDS}


def head_policy(head, device: str):
    """The head's search policy on ``device`` (None without one)."""
    from mass_tpu_torch.agent import cli

    if head is None:
        return None
    args = cli.build_parser().parse_args(HEAD_FLAGS[head])
    return cli.load_policy(args.policy_checkpoint, device)


def small_config(compat: bool, head=None):
    """The JAX test suite's episode geometry (80x80x24 at 0.125 m, camera
    48); with ``compat`` the settings of tests/test_reference_compat.py's
    compat episode; with ``head`` that goal head's fields."""
    from mass_tpu_torch.config import (AgentConfig, CameraConfig,
                                       MatchConfig, NavConfig)

    cam = CameraConfig(height=48, width=48)
    geo = dict(camera=cam, map_height=80, map_width=80, map_depth=24,
               grid_resolution=0.125, start_task=0, total_tasks=1,
               ground_truth_segmentation=True,
               ground_truth_disagreement=True)
    if compat:
        cfg = AgentConfig(
            nav=NavConfig(step_size=2, obstacle_padding=2,
                          map_slice_start=0, map_slice_stop=12,
                          graph_update_interval=5, max_goal_steps=60,
                          reference_compat=True),
            match=MatchConfig(contour_padding=0, confidence_threshold=0.1,
                              distance_threshold=0.2, max_instances=8),
            exploration_budget_one=4, exploration_budget_two=4,
            ground_truth_semantic_search=True, navigate_on_semantic=False,
            **geo)
    else:
        cfg = AgentConfig(
            nav=NavConfig(step_size=2, obstacle_padding=2,
                          map_slice_start=0, map_slice_stop=12,
                          max_goal_steps=80),
            exploration_budget_one=2, exploration_budget_two=2, **geo)
    if head is not None:
        cfg = dataclasses.replace(cfg, **head_fields(head))
    return cfg


def small_sampler(cfg, seed: int, actions: list):
    """A sampler of the one task ``seed`` that appends every action its
    tasks take to ``actions``."""
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    return recording(GridWorldTaskSampler(
        [seed], camera=cfg.camera, max_steps=250, one_phase=cfg.one_phase,
        num_objects=2, num_misplaced=1, num_opened=0), actions)


def recording(sampler, actions: list):
    """``sampler``, its tasks appending every action they take to
    ``actions``."""
    next_task = sampler.next_task

    def recording_next_task():
        task = next_task()
        step = task.step

        def recorded(action):
            actions.append(int(action))
            return step(action)
        task.step = recorded
        return task
    sampler.next_task = recording_next_task
    return sampler


def small_episode(device: str, compat: bool = False, seed: int = 2,
                  rng_seed=None, head=None, mesh=None):
    """One episode of task ``seed`` at :func:`small_config`'s settings
    (with ``head``'s goal head and policy; its maps sharded over
    ``mesh``).  Returns (results, actions)."""
    from mass_tpu_torch.agent.loop import RearrangementAgent

    cfg = small_config(compat, head)
    policy = head_policy(head, device)
    actions = []
    if rng_seed is None:
        rng_seed = 1 if compat else 0
    agent = RearrangementAgent(
        cfg, small_sampler(cfg, seed, actions),
        rng=np.random.RandomState(rng_seed), device=device, policy=policy,
        mesh=mesh)
    return agent.run_task(0), actions


def check_launches(single: int, multi: int, updates: int,
                   compat: bool) -> None:
    """Every map update launched one kernel: the single-map kernel, or
    under --reference-compat the multi-map kernel for phase one."""
    if compat:
        check(multi > 0 and single + multi == updates,
              f"{single} single-map + {multi} multi-map launches for "
              f"{updates} map updates")
    else:
        check(multi == 0 and single == updates > 0,
              f"{single} kernel launches for {updates} map updates")


def phase_small_episodes(compat: bool = False) -> dict:
    from mass_tpu_torch.ops import splat as SP

    SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
    t0 = time.perf_counter()
    gpu, gpu_actions = small_episode("cuda", compat)
    gpu_s = time.perf_counter() - t0
    single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
    t0 = time.perf_counter()
    cpu, cpu_actions = small_episode("cpu", compat)
    cpu_s = time.perf_counter() - t0
    diff = {k: (gpu[k], cpu.get(k)) for k in gpu
            if k != "timing" and gpu[k] != cpu.get(k)}
    updates = gpu["timing"]["mapping"]["count"]
    check(not diff, f"cuda and cpu episodes differ: {diff}")
    check(gpu_actions == cpu_actions, "cuda and cpu action sequences differ")
    check_launches(single, multi, updates, compat)
    return dict(results_equal=True, actions=len(gpu_actions),
                action_list=gpu_actions, launches=single,
                multi_launches=multi, map_updates=updates,
                cuda_s=gpu_s, cpu_s=cpu_s,
                metrics={k: v for k, v in gpu.items() if k != "timing"})


def conv_flops(height: int, width: int, in_channels: int) -> int:
    """Multiply-adds (counted as two operations) of the policy's five 3x3
    convs on one ``height`` x ``width`` map; the norms add under 1%."""
    macs = 9 * (in_channels * 64 + 3 * 64 * 64 + 64)
    return 2 * height * width * macs


def phase_policy_goal(dev) -> dict:
    """One policy goal at full width, by part, for the plain (54-channel)
    and the conditioned (108-channel) checkpoint: the first call in the
    process (cuDNN's set-up included), the max-over-depth read of one
    map, the five convs against their float32 bound, the Gumbel-max draw
    (threefry on the card), the float64 inhibited decode on the host, and
    the whole ``GoalHeads.policy_goal`` as the agent calls it."""
    from mass_tpu_torch.agent.loop import GoalHeads
    from mass_tpu_torch.config import AgentConfig, CameraConfig
    from mass_tpu_torch.maps import SemanticMap
    from mass_tpu_torch.search import policy as P
    from mass_tpu_torch.search import prng
    from mass_tpu_torch.utils.profiling import StageTimer

    cam = CameraConfig(height=CAMERA, width=CAMERA)
    geo_kw = {k: v for k, v in FULL_MAP.items() if k != "feature_size"}
    gen = torch.Generator(device=dev).manual_seed(7)
    maps = {}
    for name in ("semantic0", "semantic1"):
        layer = maps[name] = SemanticMap(cam, 54, device=dev, **geo_kw)
        data = layer.voxel_map.data
        for rows in data.split(1 << 21):      # sparse random class mass
            rows.copy_(torch.rand(rows.shape, device=dev, generator=gen)
                       * (torch.rand(rows.shape[0], 1, device=dev,
                                     generator=gen) < 0.02))
    h, w = FULL_MAP["map_height"], FULL_MAP["map_width"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    vm = maps["semantic1"].voxel_map
    out = dict(max_over_depth_ms=cuda_ms(vm.max_over_depth, 10, flush),
               **{f"max_over_depth_{k}": v for k, v in bound(
                   vm.data.numel() * 4 + h * w * 54 * 4, 0).items()})
    for head, channels in (("C", 54), ("B", 108)):
        fields = head_fields(head)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        policy = head_policy(head, str(dev))
        x = torch.rand((1, h, w, channels), device=dev, generator=gen)
        P.goal_logits(policy, x)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        logits = P.goal_logits(policy, x)
        key = prng.PRNGKey(3, device=dev)
        prior = [np.asarray([40 * k, 30 * k]) for k in range(1, 6)]
        heads = GoalHeads(
            AgentConfig(policy_inhibition_radius=fields[
                "policy_inhibition_radius"]), np.random.RandomState(0),
            policy, dev)
        timer = StageTimer(dev)
        out[head] = dict(
            channels=channels, load_and_first_call_ms=first_ms,
            convs_ms=cuda_ms(lambda: P.goal_logits(policy, x), 10, flush),
            **{f"convs_{k}": v for k, v in bound(
                x.numel() * 4 + h * w * 4,
                conv_flops(h, w, channels)).items()},
            categorical_ms=host_ms(lambda: prng.categorical(key, logits),
                                   10),
            inhibited_decode_ms=host_ms(lambda: P.inhibited_sample_cell(
                logits[0], h, w, prior, 8.0, key), 5),
            policy_goal_ms=host_ms(lambda: heads.policy_goal(
                maps, "semantic1", timer), 5),
            inhibition=fields["policy_inhibition_radius"])
    del maps
    torch.cuda.empty_cache()
    return out


def phase_small_heads(head: str) -> dict:
    """A small episode of the goal head on the card and on the CPU:
    equal results and actions, and one launch per group splat (two a step
    while a one-phase episode explores)."""
    from mass_tpu_torch.ops import splat as SP

    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0         # head path starts here
        t0 = time.perf_counter()
        gpu, gpu_actions = small_episode("cuda", head=head)
        gpu_s = time.perf_counter() - t0
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES  # and ends here
    updates = gpu["timing"]["mapping"]["count"]
    counts = counter.check_sequential(single, multi, updates,
                                      head_fields(head)["one_phase"])
    t0 = time.perf_counter()
    cpu, cpu_actions = small_episode("cpu", head=head)
    cpu_s = time.perf_counter() - t0
    check(outcome(gpu) == outcome(cpu),
          f"head {head}: cuda and cpu episodes differ: "
          f"{outcome(gpu)} against {outcome(cpu)}")
    check(gpu_actions == cpu_actions,
          f"head {head}: cuda and cpu action sequences differ")
    return dict(head=head, flags=HEAD_FLAGS[head], results_equal=True,
                actions=len(gpu_actions), action_list=gpu_actions,
                cuda_s=gpu_s, cpu_s=cpu_s, metrics=outcome(gpu),
                timing=gpu["timing"], **counts)


def phase_full_episode(compat: bool = False, head=None,
                       learned: bool = False) -> dict:
    """A full-width episode through the CLI (``--reference-compat``,
    ``head``'s goal head or, with ``learned``, the random Mask R-CNN
    instead of ground-truth segmentation, the sensor timed by
    :class:`SensorTimer`)."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.ops import splat as SP

    name = f"episode_{head}" if head else \
        "episode_compat" if compat else \
        "episode_learned" if learned else "episode"
    logdir = os.path.join("build", "chip_smoke", name)
    flags = (HEAD_FLAGS[head] if head else
             ["--reference-compat"] if compat else [])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with SplatCounter() as counter, SensorTimer() as sensor:
        # main path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = D.LAUNCHES = 0
        t0 = time.perf_counter()
        metrics = cli.main(full_args(learned) + FULL_BUDGETS + flags
                           + ["--logdir", logdir])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        # main path ends here
        single, multi, nms = SP.LAUNCHES, SP.MULTI_LAUNCHES, D.LAUNCHES
    check(len(metrics) == 1, "the CLI ran no episode")
    with open(os.path.join(logdir, "results", "2.json")) as f:
        results = json.load(f)
    updates = results["timing"]["mapping"]["count"]
    if head:
        counter.check_sequential(single, multi, updates,
                                 head_fields(head)["one_phase"])
    else:
        check_launches(single, multi, updates, compat)
    check(results["walkthrough/observed_cells"] > 0
          and results["unshuffle/observed_cells"] > 0,
          "the full-width maps stayed empty")
    check(0.0 <= results["unshuffle/prop_fixed"] <= 1.0,
          "prop_fixed out of range")
    out = dict(budgets=FULL_BUDGETS + flags, wall_s=wall_s,
               launches=single, multi_launches=multi, map_updates=updates,
               group_splats=len(counter.splats),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               timing=results["timing"],
               metrics={k: v for k, v in results.items()
                        if k != "timing"})
    if learned:
        out.update(sensor.check(nms, batch=1))
    return out


# ----------------------------------------------------------------------
# the lockstep fleet (parallel/fleet.py, parallel/evaluator.py)
# ----------------------------------------------------------------------

FLEET = 8
# the full-width default fleet through the CLI (once 8: cut to 4 to make
# room for the phases of more than one device within the time limit)
FULL_FLEET = 4
FLEET_FAMILIES = {"semantic0": 54, "semantic1": 54, "occupancy": 1}
# the stage times: the sequential agent's and the fleet's
TIMING_KEYS = ("timing", "fleet_timing")


def outcome(results: dict) -> dict:
    return {k: v for k, v in results.items() if k not in TIMING_KEYS}


class SplatCounter:
    """Counts group splats by their number of families (wrappers of the
    fleet's and the map layers' ``apply_onehot_group``, which launches the
    kernels and counts the launches itself), each fleet's frames folded
    per episode, and the sequential agent's ``MapSet.update_group`` calls
    by the maps they name (a one-phase step makes two: the live maps,
    then the goal-fed ones)."""

    def __enter__(self):
        from mass_tpu_torch.maps import layers as L
        from mass_tpu_torch.parallel import evaluator as EV
        from mass_tpu_torch.parallel import fleet as TF

        self.splats, self.map_updates, self.update_groups = [], [], []
        self._apply, self._run = TF.apply_onehot_group, EV.FleetEvaluator.run
        self._update_group = L.MapSet.update_group

        def apply(vms, *args):
            self.splats.append(len(vms))
            return self._apply(vms, *args)

        def run(evaluator):
            results = self._run(evaluator)
            self.map_updates.append([ep.map_updates
                                     for ep in evaluator.episodes])
            return results

        def update_group(maps, names, observation):
            self.update_groups.append(tuple(n for n in names if n in maps))
            return self._update_group(maps, names, observation)
        TF.apply_onehot_group = L.apply_onehot_group = apply
        EV.FleetEvaluator.run = run
        L.MapSet.update_group = update_group
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.maps import layers as L
        from mass_tpu_torch.parallel import evaluator as EV
        from mass_tpu_torch.parallel import fleet as TF

        TF.apply_onehot_group = L.apply_onehot_group = self._apply
        EV.FleetEvaluator.run = self._run
        L.MapSet.update_group = self._update_group

    def check_sequential(self, single: int, multi: int, updates: int,
                         one_phase: bool) -> dict:
        """A sequential episode's launches: one group splat per
        ``update_group`` call, each one launch (single-map for one map);
        one call per map update, and in a one-phase episode one more,
        for the goal-fed map, on every exploration step."""
        one = sum(1 for n in self.splats if n == 1)
        check(single == one and multi == len(self.splats) - one,
              f"{single} single-map + {multi} multi-map launches for "
              f"{len(self.splats)} group splats")
        calls = [names for names in self.update_groups if names]
        check(len(calls) == len(self.splats),
              f"{len(self.splats)} group splats for {len(calls)} "
              "update_group calls")
        goal_fed = sum(1 for names in calls if one_phase
                       and names == ("semantic0",))
        check(len(calls) == updates + goal_fed and (goal_fed > 0) ==
              one_phase, f"{len(calls)} update_group calls for {updates} "
              f"map updates and {goal_fed} goal-fed updates")
        return dict(launches=single, multi_launches=multi,
                    group_splats=len(self.splats), map_updates=updates,
                    goal_fed_updates=goal_fed)

    def check(self, single: int, multi: int, compat: bool) -> dict:
        """Every group splat of the fleet launched one kernel: the
        single-map kernel for one family, the multi-map kernel for two or
        three; under --reference-compat phase one's pair took the latter."""
        one = sum(1 for n in self.splats if n == 1)
        many = len(self.splats) - one
        check(single == one and multi == many,
              f"{single} single-map + {multi} multi-map launches for {one} "
              f"one-family and {many} multi-family fleet splats")
        check((multi > 0) == compat, f"{multi} multi-map launches in a "
              f"{'compat' if compat else 'default'} fleet")
        return dict(launches=single, multi_launches=multi,
                    group_splats=len(self.splats),
                    map_updates=sum(sum(u) for u in self.map_updates),
                    episode_map_updates=self.map_updates)


def fleet_room_frames(seed: int, origins):
    """One room frame per fleet episode, seen from the episode's origin at
    yaws 0.7 rad apart, with random classes for both semantic families."""
    rng = np.random.RandomState(seed)
    frames = [room_frame(CAMERA, rng, yaw=0.3 + 0.7 * e)
              for e in range(len(origins))]
    return dict(positions=np.asarray(origins, np.float32),
                yaws=np.asarray([y for y, _, _, _ in frames], np.float32),
                elevations=np.asarray([e for _, e, _, _ in frames],
                                      np.float32),
                depths=np.stack([d for _, _, d, _ in frames]),
                classes={name: rng.randint(
                    0, 54, (len(origins), CAMERA, CAMERA)).astype(np.int32)
                    for name in ("semantic0", "semantic1")})


def digest(fleet) -> list:
    """Per episode and family, the sum of the slab's float bits as
    integers: equal digests after two runs mean the same bits (barring a
    cancelling change)."""
    V = fleet.episode_voxels
    out = []
    for name, buf in fleet.buffers.items():
        for e in range(fleet.batch):
            slab = buf[e * V:(e + 1) * V].view(torch.int32)
            out.append(sum(int(chunk.to(torch.int64).sum())
                           for chunk in slab.split(1 << 22)))
    return out


def phase_fleet_maps(dev) -> dict:
    """FleetMaps at full width: 8 episodes of 384x384x96 voxels, semantic0
    and semantic1 at 54 classes and occupancy at 1 (one [8V, F] buffer
    each), room frames from 8 origins.  An unmasked step (one multi-map
    launch, M = 3) and a step with the compat fleet's mixed masks (one
    multi-map launch for semantic0 + occupancy, one single-map launch for
    semantic1); episodes 0 and 7 equal single-map kernel updates of
    clones of their slabs bit for bit; a second run from the reset gives
    the same bits; the step's host time beside 8 MapSet.update_group
    calls."""
    from mass_tpu_torch.config import CameraConfig, MapGeometry
    from mass_tpu_torch.core.voxelmap import VoxelMap
    from mass_tpu_torch.maps import MapSet, OccupancyMap, SemanticMap
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.parallel.fleet import FleetMaps

    cam = CameraConfig(height=CAMERA, width=CAMERA)
    geo = MapGeometry(**{k: v for k, v in FULL_MAP.items()
                         if k != "feature_size"})
    origins = [(0.37 * e, -0.21 * e, 0.05 * e) for e in range(FLEET)]
    half = FLEET // 2
    mixed = {"semantic0": np.arange(FLEET) < half,
             "occupancy": np.arange(FLEET) < half,
             "semantic1": np.arange(FLEET) >= half}
    torch.cuda.reset_peak_memory_stats()
    fleet = FleetMaps(FLEET, cam, geo, FLEET_FAMILIES, device=dev)

    def start():
        for e in range(FLEET):
            fleet.reset(e, origins[e])
        fleet.update_batch(**fleet_room_frames(0, origins))   # warm maps

    def single_updates(slabs, e, fr, active):
        """Each family's slab of episode e, as the single-map kernel
        updates it (unchanged where the family is masked out)."""
        for name, data in slabs.items():
            if active is not None and not active[name][e]:
                continue
            vm = VoxelMap(data, fleet.bins_x[e], fleet.bins_y[e],
                          fleet.bins_z[e], fleet.view(name, e).geometry)
            cls = fr["classes"].get(name, np.zeros((FLEET, CAMERA, CAMERA),
                                                   np.int32))[e]
            vm.update_classes(fleet.rays,
                              torch.as_tensor(fr["positions"][e], device=dev),
                              float(fr["yaws"][e]), float(fr["elevations"][e]),
                              torch.as_tensor(fr["depths"][e], device=dev),
                              torch.as_tensor(cls, device=dev))

    start()
    steps, equal = {}, True
    for key, seed, active, want in (("unmasked", 1, None, (0, 1)),
                                    ("mixed", 2, mixed, (1, 1))):
        fr = fleet_room_frames(seed, origins)
        clones = {e: {name: fleet.view(name, e).data.clone()
                      for name in FLEET_FAMILIES} for e in (0, FLEET - 1)}
        torch.cuda.synchronize()
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
        fleet.update_batch(**fr, active=active)
        torch.cuda.synchronize()
        launches = (SP.LAUNCHES, SP.MULTI_LAUNCHES)
        check(launches == want, f"fleet {key} step: {launches} (single, "
              f"multi) launches, want {want}")
        for e, slabs in clones.items():
            single_updates(slabs, e, fr, active)
            for name, data in slabs.items():
                same = bool(torch.equal(fleet.view(name, e).data, data))
                equal &= same
                check(same, f"fleet {key} step: episode {e}'s {name} slab "
                      "differs from single-map kernel updates")
        del clones
        steps[key] = dict(launches=launches[0], multi_launches=launches[1],
                          records=8 * FLEET * CAMERA * CAMERA)
    first = digest(fleet)
    start()
    for seed, active in ((1, None), (2, mixed)):
        fleet.update_batch(**fleet_room_frames(seed, origins), active=active)
    identical = digest(fleet) == first
    check(identical, "two fleet runs differ")
    peak = torch.cuda.max_memory_allocated()

    # the step's host time beside 8 sequential grouped updates of one
    # episode-sized map set (the work of 8 sequential agents' step)
    fr = fleet_room_frames(3, origins)
    step_ms = host_ms(lambda: fleet.update_batch(**fr), 5)
    before = SP.LAUNCHES + SP.MULTI_LAUNCHES
    fleet.update_batch(**fr)
    per_step = SP.LAUNCHES + SP.MULTI_LAUNCHES - before
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernel = profiled_launches(lambda: fleet.update_batch(**fr), 5, flush,
                               per_call=per_step)
    del flush
    geo_kw = {k: v for k, v in FULL_MAP.items() if k != "feature_size"}
    maps = MapSet(semantic0=SemanticMap(cam, 54, device=dev, **geo_kw),
                  semantic1=SemanticMap(cam, 54, device=dev, **geo_kw),
                  occupancy=OccupancyMap(cam, device=dev, **geo_kw))
    observations = [dict(position=fr["positions"][e], yaw=fr["yaws"][e],
                         elevation=fr["elevations"][e],
                         depth=fr["depths"][e],
                         semantic=fr["classes"]["semantic0"][e])
                    for e in range(FLEET)]
    sequential_ms = host_ms(lambda: [
        maps.update_group(list(FLEET_FAMILIES), o) for o in observations], 5)
    del maps, fleet
    torch.cuda.empty_cache()
    return dict(batch=FLEET, families=FLEET_FAMILIES, steps=steps,
                bitwise_equal_single_kernel=equal, runs_identical=identical,
                buffer_bytes=sum(FLEET * geo.num_voxels * 4 * f
                                 for f in FLEET_FAMILIES.values()),
                peak_memory_bytes=peak, step_ms=step_ms,
                step_kernel_device_ms=kernel["device_ms"] * per_step,
                step_kernel_trace=kernel,
                sequential_update_group_ms=sequential_ms)


def small_fleet(device: str, compat: bool, tasks, rng_seeds, head=None,
                mesh=None):
    """A fleet of the small episodes of ``tasks`` (with ``head``'s goal
    head; its buffers sharded over ``mesh``); (results, actions per
    episode)."""
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    cfg = small_config(compat, head)
    policy = head_policy(head, device)
    actions = [[] for _ in tasks]
    evaluator = FleetEvaluator(
        cfg, [small_sampler(cfg, s, a) for s, a in zip(tasks, actions)],
        seeds=list(rng_seeds), device=device, policy=policy, mesh=mesh)
    return evaluator.run(), actions


def phase_small_fleet(compat: bool, small: dict, head=None) -> dict:
    """B = 2 small episodes (tasks 2 and 3, with ``head``'s goal head)
    through the fleet on the card and on the CPU, each equal to the
    sequential port agent: task 2 to the small-episode phase's run (the
    same rng seed), task 3 to a sequential run on the card."""
    from mass_tpu_torch.ops import splat as SP

    tasks = (2, 3)
    base = 1 if compat else 0                      # task 2's rng seed
    rng_seeds = [base + s - tasks[0] for s in tasks]
    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0        # fleet path starts here
        t0 = time.perf_counter()
        gpu, gpu_actions = small_fleet("cuda", compat, tasks, rng_seeds,
                                       head)
        gpu_s = time.perf_counter() - t0
        counts = counter.check(SP.LAUNCHES, SP.MULTI_LAUNCHES, compat)
    t0 = time.perf_counter()
    cpu, cpu_actions = small_fleet("cpu", compat, tasks, rng_seeds, head)
    cpu_s = time.perf_counter() - t0
    seq3, seq3_actions = small_episode("cuda", compat, seed=3,
                                       rng_seed=rng_seeds[1], head=head)
    want = [(small["metrics"], small["action_list"]),
            (outcome(seq3), seq3_actions)]
    for k, (task, (sequential, sequential_actions)) in enumerate(
            zip(tasks, want)):
        check(outcome(gpu[k]) == outcome(cpu[k]) == sequential,
              f"fleet task {task}: cuda, cpu and sequential results differ")
        check(gpu_actions[k] == cpu_actions[k] == sequential_actions,
              f"fleet task {task}: cuda, cpu and sequential actions differ")
    check(counts["episode_map_updates"] == [[
        small["map_updates"], seq3["timing"]["mapping"]["count"]]],
        f"fleet map updates {counts['episode_map_updates']} differ from "
        "the sequential episodes'")
    return dict(tasks=tasks, rng_seeds=rng_seeds, results_equal=True,
                actions=[len(a) for a in gpu_actions], cuda_s=gpu_s,
                cpu_s=cpu_s, fleet_timing=gpu[0]["fleet_timing"], **counts)


def phase_full_fleet(size: int, compat: bool, sequential: dict,
                     head=None, features: bool = False,
                     learned: bool = False) -> dict:
    """``--fleet-size size --total-tasks size`` through the CLI at full
    width (tasks 2 onwards, the full-width flags and budgets, ``head``'s
    goal-head flags or, with ``features``, the full-width feature
    flags), with ``--seed -2`` so task 2 draws the sequential full-width
    episode's rng seed 0: that episode's outcome must come back."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join("build", "chip_smoke", f"fleet{size}"
                          + ("_compat" if compat else "")
                          + (f"_{head}" if head else "")
                          + ("_features" if features else "")
                          + ("_learned" if learned else ""))
    flags = (["--reference-compat"] if compat else []) + (
        HEAD_FLAGS[head] if head else []) + (
        FULL_FEATURE_FLAGS if features else [])
    argv = (full_args(learned) + FULL_BUDGETS + flags
            + ["--fleet-size", str(size), "--total-tasks", str(size),
               "--seed", "-2", "--logdir", logdir])
    gc.collect()                 # the sequential episodes' maps are gone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with SplatCounter() as counter, DenseCounter() as dense, \
            SensorTimer() as sensor:
        # fleet path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = SP.DENSE_LAUNCHES = 0
        D.LAUNCHES = 0
        t0 = time.perf_counter()
        metrics = cli.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = counter.check(SP.LAUNCHES, SP.MULTI_LAUNCHES, compat)
        counts.update(dense.check(SP.DENSE_LAUNCHES, features))
        if learned:
            counts.update(sensor.check(D.LAUNCHES, batch=size))
    check(len(metrics) == size, f"the fleet ran {len(metrics)} episodes")
    written = []
    for k in range(size):
        with open(os.path.join(logdir, "results", f"{2 + k}.json")) as f:
            results = json.load(f)
        written.append(results)
        check(results["task_id"] == 2 + k, "results file mismatch")
        check(results["walkthrough/observed_cells"] > 0
              and results["unshuffle/observed_cells"] > 0,
              f"task {2 + k}: the full-width maps stayed empty")
        check(0.0 <= results["unshuffle/prop_fixed"] <= 1.0,
              "prop_fixed out of range")
    same = outcome(written[0]) == sequential["metrics"]
    check(same, "fleet task 2 differs from the sequential full-width episode")
    check(counts["episode_map_updates"][0][0] == sequential["map_updates"],
          "fleet task 2's map updates differ from the sequential episode's")
    return dict(size=size, argv=argv, wall_s=wall_s,
                episode_s=wall_s / size, sequential_episode_s=
                sequential["wall_s"], task2_equals_sequential=same,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                fleet_timing=written[0]["fleet_timing"],
                prop_fixed=[m["unshuffle/prop_fixed"] for m in written],
                **counts)


# ----------------------------------------------------------------------
# feature matching: the stage-1 ResNet, the dense-row splat, FeatureMap
# ----------------------------------------------------------------------

# the JAX package's init_backbone() (the flax init at PRNGKey(0)), as
# experiments/fm/queue_r5b.sh builds it, exported with torchvision's names
BACKBONE = os.path.join("mass_tpu_torch", "checkpoints", "backbone-rand.pth")
DENSE_FEATURES, STRIDE = 256, 4
BACKBONE_TOL = 2e-4      # cuDNN and the CPU sum each conv in another order
# experiments/fm/run_arm.sh: the frozen feature-matching protocol
FM_ARGS = [
    "--backend", "gridworld", "--camera-size", "48", "--map-height", "80",
    "--map-width", "80", "--map-depth", "24", "--grid-resolution", "0.125",
    "--step-size", "2", "--obstacle-padding", "2", "--map-slice-start", "0",
    "--map-slice-stop", "12", "--room-size", "6", "--num-objects", "1",
    "--num-misplaced", "0", "--num-opened", "0",
    "--duplicate-class-pairs", "1", "--exploration-budget-one", "3",
    "--exploration-budget-two", "2", "--max-goal-steps", "60",
    "--max-steps", "500", "--ground-truth-segmentation",
    "--ground-truth-disagreement", "--ground-truth-semantic-search",
    "--use-feature-matching", "--backbone-checkpoint", BACKBONE]
FM_TASKS = (0, 2)
FM_RECORD = os.path.join("experiments", "fm", "fm-features", "results",
                         "0.json")
# the full-width episode's flags plus the protocol's scene: one
# same-class, same-size pair, one of it misplaced
FULL_FEATURE_FLAGS = ["--use-feature-matching", "--backbone-checkpoint",
                      BACKBONE, "--num-objects", "1", "--num-misplaced", "0",
                      "--num-opened", "0", "--duplicate-class-pairs", "1"]


class DenseCounter:
    """Counts the fleet's dense families updated per ``update_dense`` call
    (each one dense splat launch), by wrapping ``FleetMaps.update_dense``."""

    def __enter__(self):
        from mass_tpu_torch.parallel import fleet as TF

        self.families = 0
        self._update_dense = TF.FleetMaps.update_dense

        def update_dense(fleet, *args, active=None):
            self.families += sum(
                1 for name in fleet.dense_names
                if active is None or np.asarray(active[name]).any())
            return self._update_dense(fleet, *args, active=active)
        TF.FleetMaps.update_dense = update_dense
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.parallel import fleet as TF

        TF.FleetMaps.update_dense = self._update_dense

    def check(self, launches: int, features: bool) -> dict:
        check(launches == self.families and (launches > 0) == features,
              f"{launches} dense launches for {self.families} dense family "
              "updates")
        return dict(dense_launches=launches)


class MappingSplit:
    """Host time, card synced, of the backbone's forward passes and of
    whole ``FeatureMap`` updates (backbone, binning, sort, dense splat)
    during a sequential episode; the rest of ``timing.mapping`` is the
    semantic update."""

    def __enter__(self):
        from mass_tpu_torch.maps import FeatureMap
        from mass_tpu_torch.perception.resnet import ResNet50Stage1

        self.backbone_s = self.feature_s = 0.0
        self.backbone_calls = self.feature_calls = 0
        self._forward = ResNet50Stage1.forward
        self._update = FeatureMap.update_from_observation

        def forward(module, rgb):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._forward(module, rgb)
            torch.cuda.synchronize()
            self.backbone_s += time.perf_counter() - t0
            self.backbone_calls += 1
            return out

        def update(layer, observation):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._update(layer, observation)
            torch.cuda.synchronize()
            self.feature_s += time.perf_counter() - t0
            self.feature_calls += 1
        ResNet50Stage1.forward = forward
        FeatureMap.update_from_observation = update
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.maps import FeatureMap
        from mass_tpu_torch.perception.resnet import ResNet50Stage1

        ResNet50Stage1.forward = self._forward
        FeatureMap.update_from_observation = self._update

    def summary(self, mapping: dict) -> dict:
        return dict(
            backbone_s=self.backbone_s, backbone_calls=self.backbone_calls,
            backbone_mean_ms=1e3 * self.backbone_s / max(
                self.backbone_calls, 1),
            feature_update_s=self.feature_s,
            feature_updates=self.feature_calls,
            feature_update_mean_ms=1e3 * self.feature_s / max(
                self.feature_calls, 1),
            semantic_update_s=mapping["total_s"] - self.feature_s,
            semantic_update_mean_ms=1e3 * (
                mapping["total_s"] - self.feature_s) / max(
                mapping["count"], 1))


def dense_frame(dev, vm, frame):
    """One 224x224 frame's corner records through the stride-4 feature
    camera (56x56 rays, depth at the stride's pixel centres) on ``vm``'s
    grid."""
    from mass_tpu_torch.core import geometry as G

    yaw, elevation, depth = frame
    cam, k = CAMERA // STRIDE, STRIDE
    rays = G.camera_rays(cam, cam, cam / 2, cam / 2, device=dev)
    sub = torch.as_tensor(np.ascontiguousarray(depth[k // 2::k, k // 2::k]),
                          device=dev)
    return vm.contributions(rays, torch.zeros(3, device=dev), yaw,
                            elevation, sub)


def dense_bound(valid_records: int, pixels: int, touched: int,
                features: int) -> dict:
    """What the dense kernel must read and write: per valid record its
    int32 id, weight and pixel (12 B), each pixel's feature row once, each
    touched row read and written once; per record and channel a multiply
    and an add, per touched row element a multiply."""
    return bound(12 * valid_records + 4 * features * pixels
                 + 2 * 4 * features * touched,
                 2 * features * valid_records + features * touched)


def check_dense(name: str, data, records, feats, iw: float = 0.5) -> dict:
    """The dense kernel on a full-width map, checked on the rows it
    touches without a copy of the map: bit-equal to the plain version on
    the CPU (run on a compact copy of those rows and the records), two
    runs bit-identical, within tolerance of the plain version on the card
    (atomics), and every other row untouched (a float64 checksum of the
    whole map).  The touched rows are restored after each run."""
    from mass_tpu_torch.ops import splat as SP

    V = data.shape[0]
    valid = records.ids < V
    touched = torch.unique_consecutive(records.ids[valid])
    rows = touched.long()
    saved = data[rows]
    checksum = data.sum(dtype=torch.float64)

    def run(fn):
        fn(data, records, feats, iw)
        torch.cuda.synchronize()
        out = data[rows]
        data[rows] = saved
        return out

    out1 = run(SP.apply_dense_records)
    restored = bool(data.sum(dtype=torch.float64) == checksum)
    out2 = run(SP.apply_dense_records)
    identical = torch.equal(out1, out2)
    del out2
    plain = run(SP.splat_dense_reference)
    max_err = float((out1 - plain).abs().max())
    del plain
    compact_ids = torch.where(valid, torch.searchsorted(
        touched, records.ids), touched.shape[0]).to(torch.int32)
    cpu = SP.splat_dense_reference(
        saved.to("cpu", copy=True), SP.DenseRecords(compact_ids.cpu(),
                                     records.weights.cpu(),
                                     records.pixels.cpu()),
        feats.cpu(), iw)
    cpu_equal = torch.equal(out1.cpu(), cpu)
    changed = float((out1 - saved).abs().max())
    check(changed > 0, f"{name}: the kernel changed nothing")
    check(restored, f"{name}: the kernel changed rows outside its runs")
    check(max_err <= SPLAT_TOL,
          f"{name}: kernel vs plain max abs diff {max_err} > {SPLAT_TOL}")
    check(identical, f"{name}: two kernel runs differ")
    check(cpu_equal, f"{name}: kernel differs bitwise from the plain CPU "
          "version")
    counts = torch.unique_consecutive(records.ids[valid],
                                      return_counts=True)[1]
    return dict(max_abs_err=max_err, tolerance=SPLAT_TOL,
                bit_identical_runs=identical, bitwise_equal_cpu_plain=True,
                untouched_rows_unchanged=restored,
                records=int(records.ids.shape[0]),
                valid_records=int(valid.sum()),
                touched_voxels=int(touched.shape[0]),
                longest_run=int(counts.max()))


def many_dense_runs(dev, num_voxels: int, pixels: int, records: int,
                    seed: int = 13):
    """Sorted dense records of many runs over the whole map: runs of
    about 8 records on random voxels, every 2,000th run 600 records long
    (it outlasts several of a window's tail loads), random pixels, then 7
    discard records."""
    from mass_tpu_torch.ops import splat as SP

    rng = np.random.RandomState(seed)
    lengths = rng.geometric(1 / 8, records // 4)
    lengths[::2000] = 600
    lengths = lengths[:np.searchsorted(np.cumsum(lengths), records - 7) + 1]
    lengths[-1] -= lengths.sum() - (records - 7)
    gen = torch.Generator(device=dev).manual_seed(seed)
    voxels = torch.randperm(num_voxels, generator=gen, device=dev)[
        :lengths.shape[0]].sort().values.to(torch.int32)
    ids = torch.cat([torch.repeat_interleave(
        voxels, torch.as_tensor(lengths, device=dev)),
        voxels.new_full((7,), num_voxels)])
    return SP.DenseRecords(
        ids, torch.rand(records, generator=gen, device=dev),
        torch.randint(0, pixels, (records,), generator=gen, device=dev,
                      dtype=torch.int32))


def phase_dense_kernel(dev) -> dict:
    """The dense-row splat at full width: one 224x224 room frame's stride-4
    records (3,136 pixels of 256 random features) into a 384x384x96x256
    map of random values (13.5 GiB), then a frame 0.3 m from a wall whose
    runs hold about a hundred records, then a stream of many runs (401,408
    records, a 224x224 frame's count: some 48k runs, twelve times as many
    warps as the card holds at once); each bit-equal to the plain CPU
    version on the touched rows.  Times: the kernel, its plain version
    (which sums with atomics on the card) and the record prep, CUDA events
    after an L2 flush, median of 20; the kernel's device time from
    torch.profiler beside the events, and the kernel on the room frame's
    first 32 records alone (one warp's window: its chain of dependent
    loads from a cold L2); and, as a yardstick, ``index_add_`` of the same
    contributions (the additive half of the update alone).  ``config`` is
    the built kernel's shape (``ops.splat.dense_config``)."""
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core.voxelmap import VoxelMap
    from mass_tpu_torch.ops import splat as SP

    geo = MapGeometry(**dict(FULL_MAP, feature_size=DENSE_FEATURES))
    vm = VoxelMap.create(geo, (0.0, 0.0, 0.0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    vm.data.uniform_(generator=gen)
    pixels = (CAMERA // STRIDE) ** 2
    feats = torch.rand((pixels, DENSE_FEATURES), generator=gen, device=dev)
    yaw, elevation, depth, _ = room_frame(CAMERA, np.random.RandomState(0))
    ids, weights = dense_frame(dev, vm, (yaw, elevation, depth))
    records = SP.sorted_dense_records(ids, weights, pixels)
    out = check_dense("dense", vm.data, records, feats)
    check(out["touched_voxels"] > 1000,
          f"the room frame touched {out['touched_voxels']} voxels")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    iw = 0.5
    out["ms"] = cuda_ms(lambda: SP.apply_dense_records(
        vm.data, records, feats, iw), 20, flush)
    out["device"] = profiled_launches(lambda: SP.apply_dense_records(
        vm.data, records, feats, iw), 20, flush, "splat_dense_kernel")
    window = SP.DenseRecords(*(t[:32].contiguous() for t in records))
    out["one_window_ms"] = cuda_ms(lambda: SP.apply_dense_records(
        vm.data, window, feats, iw), 20, flush)
    out["one_window_device"] = profiled_launches(
        lambda: SP.apply_dense_records(vm.data, window, feats, iw), 20,
        flush, "splat_dense_kernel")
    out["plain_ms"] = cuda_ms(lambda: SP.splat_dense_reference(
        vm.data, records, feats, iw), 20, flush)
    out["prep_ms"] = cuda_ms(lambda: SP.sorted_dense_records(
        ids, weights, pixels), 20, flush)
    valid = records.ids < geo.num_voxels
    index = records.ids[valid].long()
    contrib = records.weights[valid, None] * feats[records.pixels[valid]]
    out["index_add_ms"] = cuda_ms(lambda: vm.data.index_add_(
        0, index, contrib), 20, flush)
    out["library_ms"] = None
    out["pixels"] = pixels
    out.update(dense_bound(out["valid_records"], pixels,
                           out["touched_voxels"], DENSE_FEATURES))
    del contrib, index
    wall = wall_frame(CAMERA)
    ids, weights = dense_frame(dev, vm, wall)
    wall_records = SP.sorted_dense_records(ids, weights, pixels)
    skewed = check_dense("dense wall frame", vm.data, wall_records, feats)
    check(skewed["longest_run"] > 64,
          f"the wall frame's longest run is {skewed['longest_run']}")
    skewed["ms"] = cuda_ms(lambda: SP.apply_dense_records(
        vm.data, wall_records, feats, iw), 20, flush)
    skewed["device"] = profiled_launches(lambda: SP.apply_dense_records(
        vm.data, wall_records, feats, iw), 20, flush, "splat_dense_kernel")
    skewed.update(dense_bound(skewed["valid_records"], pixels,
                              skewed["touched_voxels"], DENSE_FEATURES))
    out["wall"] = skewed
    many_records = many_dense_runs(dev, geo.num_voxels, pixels,
                                   8 * CAMERA * CAMERA)
    many = check_dense("dense many runs", vm.data, many_records, feats)
    many["ms"] = cuda_ms(lambda: SP.apply_dense_records(
        vm.data, many_records, feats, iw), 20, flush)
    many.update(dense_bound(many["valid_records"], pixels,
                            many["touched_voxels"], DENSE_FEATURES))
    out["many"] = many
    del many_records
    out["config"] = SP.dense_config()
    out["map_bytes"] = vm.data.numel() * 4
    del flush, vm, feats
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_backbone(dev) -> dict:
    """The stage-1 ResNet on one 224x224 frame (and on the B = 2 batch a
    fleet tick sends): the first call (cuDNN's set-up), then CUDA events
    after an L2 flush, median of 20, beside its bound (the convs'
    operations at the float32 rate); the card's features within
    BACKBONE_TOL of the CPU's."""
    from mass_tpu_torch.perception.resnet import (feature_flops,
                                                  load_backbone_checkpoint)

    gen = torch.Generator(device=dev).manual_seed(12)
    rgb = torch.rand((2, CAMERA, CAMERA, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backbone, module = load_backbone_checkpoint(BACKBONE, dev)
    out = backbone(rgb[0])
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(out.shape) == (CAMERA // 4, CAMERA // 4, DENSE_FEATURES)
          and bool(torch.isfinite(out).all()), "backbone output")
    cpu_backbone, _ = load_backbone_checkpoint(BACKBONE, "cpu")
    err = float((out.cpu() - cpu_backbone(rgb[0].cpu())).abs().max())
    check(err <= BACKBONE_TOL, f"backbone cuda vs cpu {err}")
    again = backbone(rgb[0])
    check(torch.equal(out, again), "two backbone calls differ")
    batched = backbone(rgb)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    weights = sum(p.numel() for p in module.state_dict().values()
                  if p.dtype == torch.float32) * 4
    result = dict(
        load_and_first_call_ms=first_ms, max_abs_err_cpu=err,
        tolerance=BACKBONE_TOL,
        batch_of_two_max_abs_diff=float((batched[0] - out).abs().max()),
        ms=cuda_ms(lambda: backbone(rgb[0]), 20, flush),
        batch2_ms=cuda_ms(lambda: backbone(rgb), 20, flush),
        **bound(weights + rgb[0].numel() * 4 + out.numel() * 4,
                feature_flops(CAMERA, CAMERA)))
    del flush
    return result


def fm_args(device: str, task: int):
    """The protocol's CLI flags for one task on ``device``, writing
    nothing."""
    from mass_tpu_torch.agent import cli

    return cli.build_parser().parse_args(
        FM_ARGS + ["--start-task", str(task), "--total-tasks", "1",
                   "--device", device, "--logdir", ""])


def fm_episode(device: str, task: int):
    """Task ``task`` of the feature-matching protocol through the agent
    the CLI builds, rng seed 0; (results, actions)."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.agent.loop import RearrangementAgent

    args = fm_args(device, task)
    config = cli.config_from_args(args)
    actions = []
    agent = RearrangementAgent(
        config, recording(cli.make_sampler(args, config), actions),
        rng=np.random.RandomState(args.seed), device=device,
        feature_backbone=cli.load_backbone(args, device))
    return agent.run_task(task), actions


def phase_small_features() -> dict:
    """Tasks 0 and 2 of the frozen feature-matching protocol on the card
    and on the CPU (equal results and actions; task 0 also equal to the
    committed record), each map update one single-map and one dense
    launch (the phase's semantic and feature map)."""
    from mass_tpu_torch.ops import splat as SP

    with open(FM_RECORD) as f:
        record = json.load(f)
    out = {}
    for task in FM_TASKS:
        # the feature path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = SP.DENSE_LAUNCHES = 0
        t0 = time.perf_counter()
        gpu, gpu_actions = fm_episode("cuda", task)
        gpu_s = time.perf_counter() - t0
        single, multi, dense = (SP.LAUNCHES, SP.MULTI_LAUNCHES,
                                SP.DENSE_LAUNCHES)   # and ends here
        updates = gpu["timing"]["mapping"]["count"]
        check(single == dense == updates > 0 and multi == 0,
              f"task {task}: {single} single-map and {dense} dense launches"
              f" for {updates} map updates")
        t0 = time.perf_counter()
        cpu, cpu_actions = fm_episode("cpu", task)
        cpu_s = time.perf_counter() - t0
        check(outcome(gpu) == outcome(cpu),
              f"fm task {task}: cuda and cpu episodes differ: "
              f"{outcome(gpu)} against {outcome(cpu)}")
        check(gpu_actions == cpu_actions,
              f"fm task {task}: cuda and cpu action sequences differ")
        equals_record = None
        if task == 0:
            drift = {k: (record[k], gpu.get(k)) for k in record
                     if k != "timing" and gpu.get(k) != record[k]}
            check(not drift, f"fm task 0 differs from {FM_RECORD}: {drift}")
            equals_record = True
        out[task] = dict(results_equal=True, actions=len(gpu_actions),
                         action_list=gpu_actions, launches=single,
                         dense_launches=dense, map_updates=updates,
                         cuda_s=gpu_s, cpu_s=cpu_s,
                         equals_committed_record=equals_record,
                         metrics=outcome(gpu), timing=gpu["timing"])
    return out


def phase_full_features() -> dict:
    """The full-width episode's CLI flags with the protocol's scene and
    ``--use-feature-matching`` (two 384x384x96x256 feature maps, 13.5 GiB
    each, beside the two semantic maps), task 2; the mapping split into
    backbone, feature update and semantic update."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join("build", "chip_smoke", "episode_features")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with MappingSplit() as split:
        # main path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = SP.DENSE_LAUNCHES = 0
        t0 = time.perf_counter()
        metrics = cli.main(FULL_ARGS + FULL_BUDGETS + FULL_FEATURE_FLAGS
                           + ["--logdir", logdir])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        single, multi, dense = (SP.LAUNCHES, SP.MULTI_LAUNCHES,
                                SP.DENSE_LAUNCHES)   # main path ends here
    check(len(metrics) == 1, "the CLI ran no episode")
    with open(os.path.join(logdir, "results", "2.json")) as f:
        results = json.load(f)
    updates = results["timing"]["mapping"]["count"]
    check(single == dense == updates == split.feature_calls > 0
          and multi == 0, f"{single} single-map and {dense} dense launches "
          f"for {updates} map updates ({split.feature_calls} feature "
          "updates)")
    check(results["walkthrough/observed_cells"] > 0
          and results["unshuffle/observed_cells"] > 0,
          "the full-width maps stayed empty")
    check(0.0 <= results["unshuffle/prop_fixed"] <= 1.0,
          "prop_fixed out of range")
    return dict(budgets=FULL_BUDGETS + FULL_FEATURE_FLAGS, wall_s=wall_s,
                launches=single, multi_launches=multi, dense_launches=dense,
                map_updates=updates, group_splats=updates,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                mapping_split=split.summary(results["timing"]["mapping"]),
                timing=results["timing"],
                metrics=outcome(results))


def phase_small_feature_fleet(small: dict) -> dict:
    """Tasks 0 and 2 of the protocol as one B = 2 fleet (rng seed 0 each,
    as the sequential CLI runs them) on the card and on the CPU: each
    episode equal to the sequential small feature episode; one dense
    launch per dense family updated."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    def fleet(device):
        args = fm_args(device, FM_TASKS[0])
        config = cli.config_from_args(args)
        actions = [[] for _ in FM_TASKS]
        evaluator = FleetEvaluator(
            config, [recording(cli.make_sampler(args, config, [s]), a)
                     for s, a in zip(FM_TASKS, actions)],
            seeds=[args.seed] * len(FM_TASKS), device=device,
            feature_backbone=cli.load_backbone(args, device))
        return evaluator.run(), actions

    with SplatCounter() as counter, DenseCounter() as dense:
        # fleet path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = SP.DENSE_LAUNCHES = 0
        t0 = time.perf_counter()
        gpu, gpu_actions = fleet("cuda")
        gpu_s = time.perf_counter() - t0
        counts = counter.check(SP.LAUNCHES, SP.MULTI_LAUNCHES, False)
        counts.update(dense.check(SP.DENSE_LAUNCHES, True))
    t0 = time.perf_counter()
    cpu, cpu_actions = fleet("cpu")
    cpu_s = time.perf_counter() - t0
    for k, task in enumerate(FM_TASKS):
        want = small[task]
        check(outcome(gpu[k]) == outcome(cpu[k]) == want["metrics"],
              f"feature fleet task {task}: cuda, cpu and sequential results "
              "differ")
        check(gpu_actions[k] == cpu_actions[k] == want["action_list"],
              f"feature fleet task {task}: cuda, cpu and sequential actions "
              "differ")
    return dict(tasks=FM_TASKS, results_equal=True,
                actions=[len(a) for a in gpu_actions], cuda_s=gpu_s,
                cpu_s=cpu_s, fleet_timing=gpu[0]["fleet_timing"], **counts)


# ----------------------------------------------------------------------
# learned segmentation: greedy NMS, the Mask R-CNN, learned episodes
# ----------------------------------------------------------------------

# the random detectron2-layout Mask R-CNN (tests/torch_checkpoints.py:
# numpy draws from seed 0, output layers tempered), written by this run
DETECTOR = os.path.join("build", "chip_smoke", "maskrcnn-rand.pth")
# its best scores on a 224x224 grid-world frame lie near 0.35-0.45: at
# this fusion threshold 15-20 detections of a frame survive
LEARNED_THRESHOLD = 0.3
# the small detector of [learned 80x80x24]: tests/test_maskrcnn.py's caps
# at the 48 px camera, 7 classes offset by 1 into the taxonomy; its
# scores lie near 0.21-0.29
SMALL_DETECTOR = dict(num_classes=7, image_size=48, pre_nms_topk=64,
                      post_nms_topk=32, candidate_pool=64, max_detections=8)
SMALL_THRESHOLD = 0.2
# the NMS kernel's times in its first design (a block per problem, one
# block-wide argmax round per output slot; NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md)
NMS_BEFORE_MS = {"rpn_b1": 0.1638, "detection_b1": 0.0570, "rpn_b8": 0.1659}
# fp32 operations of one IoU test: four min/max, two subtractions and two
# clamps for the overlap's sides, its product, the union's add and
# subtract, its clamp, the division and the compare
NMS_PAIR_FLOPS = 14
NMS_BOX_FLOPS = 5           # a box's area: two subtractions, clamps, product


def full_args(learned: bool):
    """The full-width flags; ``learned`` swaps ground-truth segmentation
    for the random Mask R-CNN at :data:`LEARNED_THRESHOLD`."""
    if not learned:
        return list(FULL_ARGS)
    return ([a for a in FULL_ARGS if a != "--ground-truth-segmentation"]
            + ["--detector-checkpoint", DETECTOR, "--detection-threshold",
               str(LEARNED_THRESHOLD)])


class SensorTimer:
    """Host time, card synced, of every ``DetectorSegmentation`` call
    (one frame, or a fleet's batch): detector, NMS and fusion, the copy
    of the class image to the host included; and the fused non-zero
    pixels of each frame."""

    def __enter__(self):
        from mass_tpu_torch.perception.segmentation import \
            DetectorSegmentation

        self.times, self.frames, self.fused = [], 0, []
        self._semantic = DetectorSegmentation.semantic

        def semantic(sensor, rgb):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._semantic(sensor, rgb)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            self.frames += 1 if out.dim() == 3 else out.shape[0]
            self.fused.extend((out > 0).flatten(-3).sum(-1).reshape(-1)
                              .tolist())
            return out
        DetectorSegmentation.semantic = semantic
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.perception.segmentation import \
            DetectorSegmentation

        DetectorSegmentation.semantic = self._semantic

    def check(self, nms_launches: int, batch: int,
              need_fused: bool = True) -> dict:
        """Two NMS launches a sensor call (the RPN levels of its frames,
        the class-aware NMS); detections fused into some frames, unless
        ``need_fused`` is False."""
        calls = len(self.times)
        check(calls > 0 and nms_launches == 2 * calls,
              f"{nms_launches} NMS launches for {calls} sensor calls")
        check(self.frames == batch * calls, "sensor frames miscounted")
        check(max(self.fused) > 0 or not need_fused,
              "no detection survived the threshold")
        return dict(nms_launches=nms_launches, sensor_calls=calls,
                    sensor_mean_ms=1e3 * float(np.mean(self.times)),
                    sensor_median_ms=1e3 * float(np.median(self.times)),
                    fused_pixels_mean=float(np.mean(self.fused)),
                    fused_pixels_min=int(min(self.fused)),
                    fused_pixels_max=int(max(self.fused)),
                    frames_with_fused=int(sum(f > 0 for f in self.fused)),
                    frames=self.frames)


def grid_frames(count: int, camera: int = CAMERA) -> np.ndarray:
    """``count`` RGB frames of grid-world task 2 along a few steps."""
    from mass_tpu_torch.config import CameraConfig
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    task = GridWorldTaskSampler([2], camera=CameraConfig(camera, camera)
                                ).next_task()
    frames = []
    for k in range(count):
        frames.append(np.asarray(task.get_observations()["rgb"],
                                 np.float32))
        task.step(1 + k % 3)
    return np.stack(frames)


class NMSRecorder:
    """Records the arguments of every NMS call the detector makes (the
    RPN's levels, the class-aware NMS), passing them on."""

    def __enter__(self):
        from mass_tpu_torch.perception import maskrcnn as TM

        self.calls = []
        self._nms = TM.nms

        def nms(boxes, scores, threshold, outputs):
            self.calls.append((boxes.clone(), scores.clone(), threshold,
                               outputs))
            return self._nms(boxes, scores, threshold, outputs)
        TM.nms = nms
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.perception import maskrcnn as TM

        TM.nms = self._nms


def dependent_steps(dev) -> dict:
    """Two dependent chains on the card, one warp each step waiting on the
    last: a shared-memory load (the probe of ``csrc/nms.cu`` walks a cycle
    of 65,536 loads) and a logic operation (65,536 of them), timed by
    the SM's cycle counter and the global nanosecond timer."""
    import ctypes

    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.ops import splat as SP

    probe = D._library().nms_step_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(5, dtype=torch.int64, device=dev)
    steps = 1 << 16
    for _ in range(2):                     # the first call warms up
        SP._raise_on(probe(steps, out.data_ptr(), SP._stream(dev)),
                     "dependent-step probe")
        torch.cuda.synchronize()
    load_cycles, load_ns, op_cycles, op_ns, _ = out.tolist()
    return dict(load_cycles=load_cycles / steps, load_ns=load_ns / steps,
                op_cycles=op_cycles / steps, op_ns=op_ns / steps,
                sm_ghz=load_cycles / load_ns)


def nms_bound(problem: dict, op_ns: float) -> dict:
    """The NMS kernel's least time on these inputs, the largest of three
    terms: the bytes (20 B a box read, 4 B a keep slot written); the fp32
    operations of the live pairs (each problem's L(L+1)/2 IoU tests and L
    areas) at the card's fp32 peak; and the greedy chain, whose picks
    each wait on the last: the longest problem's taken positions times
    one dependent operation (:func:`dependent_steps`)."""
    problems, n = problem["shape"]
    width = max(problem["outputs"]) if isinstance(problem["outputs"], list) \
        else problem["outputs"]
    terms = {
        "bytes": (problems * n * 20 + problems * width * 4)
        / HBM_BYTES_PER_S,
        "fp32 operations": (NMS_PAIR_FLOPS * problem["live_pairs"]
                            + NMS_BOX_FLOPS * problem["live_boxes"])
        / FP32_FLOPS,
        "greedy chain": problem["taken_max"] * op_ns * 1e-9}
    term = max(terms, key=terms.get)
    return dict(bound_ms=1e3 * terms[term],
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term,
                terms_ms={k: 1e3 * v for k, v in terms.items()})


def check_nms(dev, boxes, scores, threshold, outputs) -> dict:
    """The kernel on the card against the plain loop on the CPU: equal
    keep indices, every slot; with what the bound counts (live boxes and
    pairs, the most distinct positions one problem takes)."""
    from mass_tpu_torch.ops import detection as D

    got = D.nms(boxes.to(dev), scores.to(dev), threshold, outputs).cpu()
    want = D.nms_reference(boxes.cpu(), scores.cpu(), threshold, outputs)
    equal = torch.equal(got, want)
    check(equal, f"NMS kernel differs from the plain loop on "
          f"{tuple(boxes.shape)}: {int((got != want).sum())} slots")
    live = (scores.cpu() > float("-inf")).sum(1)
    taken = [len({int(i) for i in row if i >= 0}) for row in want]
    return dict(shape=list(boxes.shape[:2]), outputs=outputs,
                kept=int((want >= 0).sum()), equal=equal,
                live_boxes=int(live.sum()),
                live_pairs=int((live * (live + 1) // 2).sum()),
                taken_max=max(taken, default=0))


def time_nms(dev, problem: dict, boxes, scores, threshold, outputs,
             op_ns: float) -> dict:
    from mass_tpu_torch.ops import detection as D

    boxes, scores = boxes.to(dev), scores.to(dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def launch():
        D.nms(boxes, scores, threshold, outputs)
    launch()
    # 50 launches back to back between two events: the device's time per
    # launch once the host runs ahead of it (no flush between them)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        launch()
    end.record()
    torch.cuda.synchronize()
    back_to_back_ms = start.elapsed_time(end) / 50
    out = dict(ms=cuda_ms(launch, 20, flush),
               back_to_back_ms=back_to_back_ms,
               **profiled_launches(launch, 20, flush, "nms_kernel"),
               plain_ms=host_ms(lambda: D.nms_reference(
                   boxes, scores, threshold, outputs), 2),
               library_ms=None, **nms_bound(problem, op_ns))
    del flush
    return out


def phase_nms(dev) -> dict:
    """The NMS kernel against the plain loop on the CPU, exact keep
    indices: the detector's own NMS problems (the RPN's five levels of one
    frame and of eight, the class-aware NMS of one frame and of eight;
    random weights on grid-world frames) and the chosen streams of
    tests/torch_streams.py, each alone, all in one padded launch and that
    batch twice over with its caps cycled.  Times at the RPN and the
    class-aware shapes: CUDA events after an L2 flush, the profiler's
    device time a recorded launch, the plain loop on the card, the bound
    with its dependent step measured."""
    from tests import torch_streams as TS
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.perception import maskrcnn as TM

    model, _ = load_full_detector(dev)
    frames = torch.from_numpy(grid_frames(8)).to(dev)
    anchors = TM.device_anchors(model.config, dev)
    with NMSRecorder() as one:
        TM.detect(model, frames[0], anchors)
    with NMSRecorder() as eight:
        TM.detect(model, frames, anchors)
    shapes = {"rpn_b1": one.calls[0], "detection_b1": one.calls[1],
              "rpn_b8": eight.calls[0], "detection_b8": eight.calls[1]}
    out = {"problems": {k: check_nms(dev, *v) for k, v in shapes.items()}}
    streams = {}
    for name in sorted(TS.NMS_STREAMS):
        boxes, scores, threshold, outputs = TS.nms_stream(name)
        streams[name] = check_nms(dev, torch.from_numpy(boxes)[None],
                                  torch.from_numpy(scores)[None], threshold,
                                  outputs)
    boxes, scores, _, outputs = TS.nms_batch(sorted(TS.NMS_STREAMS))
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    streams["all_in_one_launch"] = check_nms(dev, boxes, scores, 0.5,
                                             outputs)
    streams["all_twice_caps_cycled"] = check_nms(
        dev, torch.cat([boxes, boxes]), torch.cat([scores, scores]), 0.5,
        outputs)
    out["streams"] = streams
    out["step"] = dependent_steps(dev)
    for key in ("rpn_b1", "detection_b1", "rpn_b8"):
        out[key] = time_nms(dev, out["problems"][key], *shapes[key],
                            out["step"]["op_ns"])
        out[key]["before_ms"] = NMS_BEFORE_MS[key]
    out["config"] = {n: D.nms_config(n) for n in sorted(
        {p["shape"][1] for p in out["problems"].values()})}
    out["max_abs_err"] = 0.0          # keep indices, compared exactly
    del model
    return out


def load_full_detector(dev):
    """The full-width random Mask R-CNN of :data:`DETECTOR` (written on
    first use): ``(model on dev, model on the CPU)``."""
    from mass_tpu_torch.perception import maskrcnn as TM
    from tests.torch_checkpoints import write_random_detector

    if not os.path.exists(DETECTOR):
        write_random_detector(DETECTOR, seed=0, num_classes=54)
    _, model = TM.load_detector(DETECTOR, CAMERA, device=dev)
    _, cpu_model = TM.load_detector(DETECTOR, CAMERA, device="cpu")
    return model, cpu_model


def detect_split(model, rgb, anchors):
    """One detector call with CUDA events at its stage marks: device ms of
    the network, the proposals (RPN NMS included), the heads (box head,
    class-aware NMS, mask head) and the paste, then the fusion."""
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception.segmentation import \
        detections_to_semantic

    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))
    det = TM.detect(model, rgb, anchors, marks=mark)
    detections_to_semantic(det, LEARNED_THRESHOLD)
    mark("fuse")
    torch.cuda.synchronize()
    return {name: events[k][1].elapsed_time(ev)
            for k, (name, ev) in enumerate(events[1:])}


def phase_detector(dev) -> dict:
    """The full-width Mask R-CNN (224x224, 54 classes, the default caps)
    on one grid-world frame and on B = 2: the card against the CPU by the
    margin rule (tests/torch_margins.py), the fused images' non-zero
    pixels at :data:`LEARNED_THRESHOLD`, ms per frame by stage (CUDA
    events; median of 10 calls), and the convs' and linears' operations
    against the fp32 peak (67 TFLOP/s, no tensor cores: TF32 is off)."""
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception.segmentation import \
        detections_to_semantic
    from tests import torch_margins

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, cpu_model = load_full_detector(dev)
    anchors = TM.device_anchors(model.config, dev)
    frames = grid_frames(3)
    TM.detect(model, torch.from_numpy(frames[0]).to(dev), anchors)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    cpu_anchors = TM.device_anchors(model.config, "cpu")
    out = dict(load_and_first_call_ms=first_ms, threshold=LEARNED_THRESHOLD,
               tolerance=torch_margins.TOL)
    for batch in (1, 2):
        rgb = torch.from_numpy(frames[1:1 + batch] if batch > 1
                               else frames[1])
        want, probs = TM.detect(cpu_model, rgb, cpu_anchors,
                                       with_probs=True)
        got = TM.detect(model, rgb.to(dev), anchors)
        report = torch_margins.compare_detections(
            want, got, probs, thresholds=(model.config.score_threshold,
                                          LEARNED_THRESHOLD))
        check(report["ok"], f"detector B={batch}: cuda and cpu differ "
              f"beyond the margin rule: {report}")
        sem = detections_to_semantic(got, LEARNED_THRESHOLD)
        want_sem = detections_to_semantic(want, LEARNED_THRESHOLD)
        differing, unexplained = torch_margins.compare_semantic(
            want_sem, sem, want, probs, LEARNED_THRESHOLD)
        check(unexplained == 0, f"detector B={batch}: {unexplained} fused "
              "pixels differ beyond the margin rule")
        fused = (sem > 0).flatten(-3).sum(-1).reshape(-1).tolist()
        check(min(fused) > 0, f"detector B={batch}: nothing fused")
        splits = [detect_split(model, rgb.to(dev), anchors)
                  for _ in range(11)][1:]
        stages = {k: float(np.median([s[k] for s in splits]))
                  for k in splits[0]}
        flops = TM.model_flops(model.config)
        total = sum(flops.values()) * batch
        out[f"b{batch}"] = dict(
            margin=report, fused_pixels=fused,
            semantic_differing=differing, stages_ms=stages,
            ms=sum(stages.values()),
            ms_per_frame=sum(stages.values()) / batch,
            flops=flops, flops_total=total,
            flops_bound_ms=1e3 * total / FP32_FLOPS)
    del model, cpu_model
    return out


def small_learned_episode(device: str, seed: int = 2, rng_seed: int = 0):
    """One small episode (:func:`small_config`, the default head) whose
    semantic images come from the small random detector; (results,
    actions)."""
    from mass_tpu_torch.agent.loop import RearrangementAgent
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception.segmentation import (
        DetectorSegmentation, SegmentationSampler)
    from tests.torch_checkpoints import random_maskrcnn_state_dict

    cfg = dataclasses.replace(small_config(False),
                              ground_truth_segmentation=False,
                              detection_threshold=SMALL_THRESHOLD)
    model = TM.from_state_dict(
        random_maskrcnn_state_dict(0, SMALL_DETECTOR["num_classes"]),
        TM.MaskRCNNConfig(**SMALL_DETECTOR), device)
    sensor = DetectorSegmentation(TM.make_detector(model, class_offset=1),
                                  SMALL_THRESHOLD)
    actions = []
    agent = RearrangementAgent(
        cfg, SegmentationSampler(small_sampler(cfg, seed, actions), sensor),
        rng=np.random.RandomState(rng_seed), device=device)
    return agent.run_task(0), actions


def phase_small_learned() -> dict:
    """The small learned episode on the card and on the CPU: equal results
    and actions; one single-map launch per map update, two NMS launches
    per sensor call."""
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.ops import splat as SP

    with SensorTimer() as sensor:
        # the learned path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = D.LAUNCHES = 0
        t0 = time.perf_counter()
        gpu, gpu_actions = small_learned_episode("cuda")
        gpu_s = time.perf_counter() - t0
        single, multi, nms = SP.LAUNCHES, SP.MULTI_LAUNCHES, D.LAUNCHES
        counts = sensor.check(nms, batch=1)
    updates = gpu["timing"]["mapping"]["count"]
    check_launches(single, multi, updates, False)
    t0 = time.perf_counter()
    cpu, cpu_actions = small_learned_episode("cpu")
    cpu_s = time.perf_counter() - t0
    check(outcome(gpu) == outcome(cpu),
          f"learned: cuda and cpu episodes differ: {outcome(gpu)} against "
          f"{outcome(cpu)}")
    check(gpu_actions == cpu_actions,
          "learned: cuda and cpu action sequences differ")
    return dict(results_equal=True, actions=len(gpu_actions),
                cuda_s=gpu_s, cpu_s=cpu_s, launches=single,
                multi_launches=multi, map_updates=updates,
                metrics=outcome(gpu), **counts)


# ----------------------------------------------------------------------
# training (search/dataset.py, search/train.py, tools/detector_dataset.py,
# perception/train_detector.py)
# ----------------------------------------------------------------------

SEARCH_TASKS = 8
SEARCH_DIR = os.path.join("build", "chip_smoke", "search-data")
SEARCH_FULL_DIR = os.path.join("build", "chip_smoke", "search-data-full")
# the collector at full width: the CLI's geometry, budgets 5 + 5
SEARCH_FULL_ARGS = [
    "--camera-size", "224", "--map-height", "384", "--map-width", "384",
    "--map-depth", "96", "--grid-resolution", "0.05", "--step-size", "5",
    "--obstacle-padding", "4", "--map-slice-start", "20",
    "--map-slice-stop", "48", "--exploration-goals", "5"]
# the first steps' losses of a fit on the card against the CPU: cuDNN and
# the CPU sum each conv in another order (the CPU tests hold the port to
# JAX at the same rtol)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_CHECK_STEPS = 10
SEGMENTER_DIR = os.path.join("build", "chip_smoke", "segmenter")


class UpdateTimer:
    """Host time, card synced, of every ``MapSet.update_group`` call (one
    frame folded into the named maps)."""

    def __enter__(self):
        from mass_tpu_torch.maps import layers as L

        self.ms = []
        self._update_group = L.MapSet.update_group

        def update_group(maps, names, observation):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._update_group(maps, names, observation)
            torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - t0))
        L.MapSet.update_group = update_group
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.maps import layers as L

        L.MapSet.update_group = self._update_group


def collector_launches(counter: SplatCounter, single: int,
                       multi: int) -> dict:
    """Every collector frame is one group splat and one launch: the
    walkthrough's (occupancy, semantic0) pair on the multi-map kernel,
    the unshuffle's semantic1 on the single-map kernel."""
    pairs = sum(1 for n in counter.splats if n == 2)
    ones = sum(1 for n in counter.splats if n == 1)
    check(pairs + ones == len(counter.splats) > 0,
          f"collector group splats of sizes {sorted(set(counter.splats))}")
    check(single == ones and multi == pairs,
          f"{single} single-map + {multi} multi-map launches for {ones} "
          f"one-map and {pairs} two-map group splats")
    names = set(counter.update_groups)
    check(names == {("occupancy", "semantic0"), ("semantic1",)},
          f"collector update_group calls name {names}")
    return dict(launches=single, multi_launches=multi,
                group_splats=len(counter.splats))


def npz_tasks(logdir: str) -> dict:
    out = {}
    for name in sorted(os.listdir(logdir)):
        with np.load(os.path.join(logdir, name)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


def phase_search_data() -> dict:
    """``python -m mass_tpu_torch.search.dataset`` at its defaults (80x80x24
    at 0.125 m, camera 48, budgets 3 + 2) over tasks 0-7 on the card, and
    task 0 again on the CPU: equal cells and snapshot counts, snapshots
    within one float16 ulp; one launch per group splat."""
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.search import dataset as SD

    gpu_dir, cpu_dir = SEARCH_DIR, SEARCH_DIR + "-cpu"
    for d in (gpu_dir, cpu_dir):
        shutil.rmtree(d, ignore_errors=True)
    per_task = []
    with SplatCounter() as counter:
        # the collector's path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
        t0 = time.perf_counter()
        for task in range(SEARCH_TASKS):
            SD.main(["--logdir", gpu_dir, "--start-task", str(task),
                     "--total-tasks", "1"])
            torch.cuda.synchronize()
            per_task.append(time.perf_counter() - t0 - sum(per_task))
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
        # and ends here
    counts = collector_launches(counter, single, multi)
    t0 = time.perf_counter()
    SD.main(["--logdir", cpu_dir, "--total-tasks", "1", "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    gpu, cpu = npz_tasks(gpu_dir), npz_tasks(cpu_dir)
    check(len(gpu) == SEARCH_TASKS, f"{len(gpu)} task files")
    a, b = gpu["task-0.npz"], cpu["task-0.npz"]
    for key in ("cells0", "cells1"):
        check(np.array_equal(a[key], b[key]), f"task 0 {key}: cuda "
              f"{a[key].tolist()} against cpu {b[key].tolist()}")
    worst = 0.0
    for key in ("tops0", "tops1"):
        check(a[key].shape == b[key].shape, f"task 0 {key} shapes "
              f"{a[key].shape} against {b[key].shape}")
        ulp = np.spacing(np.maximum(np.abs(a[key]), np.abs(b[key])))
        diff = np.abs(a[key].astype(np.float32) - b[key].astype(np.float32))
        check((diff <= ulp.astype(np.float32)).all(),
              f"task 0 {key}: cuda and cpu differ by {diff.max()}")
        worst = max(worst, float(diff.max()))
    snapshots = sum(len(t["tops0"]) + len(t["tops1"]) for t in gpu.values())
    labels = sum(len(t["cells0"]) for t in gpu.values())
    return dict(tasks=SEARCH_TASKS, wall_s_per_task=per_task,
                cpu_task0_s=cpu_s, snapshots=snapshots, labels=labels,
                max_abs_diff_cpu=worst,
                map_updates=len(counter.update_groups), **counts)


def phase_search_data_full() -> dict:
    """One collector task at full width (384x384x96x54, camera 224, budgets
    5 + 5): wall, host time per map update (card synced), launches by
    kernel, snapshots, peak memory."""
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.search import dataset as SD

    shutil.rmtree(SEARCH_FULL_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with SplatCounter() as counter, UpdateTimer() as timer:
        # the collector's path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
        t0 = time.perf_counter()
        SD.main(["--logdir", SEARCH_FULL_DIR, "--total-tasks", "1"]
                + SEARCH_FULL_ARGS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
        # and ends here
    counts = collector_launches(counter, single, multi)
    data = npz_tasks(SEARCH_FULL_DIR)["task-0.npz"]
    args = SD.build_parser().parse_args(["--logdir", SEARCH_FULL_DIR]
                                        + SEARCH_FULL_ARGS)
    shape = (args.map_height, args.map_width, 54)
    check(data["tops0"].shape[1:] == data["tops1"].shape[1:] == shape
          and len(data["tops0"]) > 0 and len(data["tops1"]) > 1,
          f"full-width snapshots {data['tops0'].shape} and "
          f"{data['tops1'].shape}")
    check(bool(data["tops0"][-1].any()), "the full-width walkthrough map "
          "stayed empty")
    return dict(wall_s=wall_s, map_updates=len(timer.ms),
                update_ms_mean=float(np.mean(timer.ms)),
                update_ms_median=float(np.median(timer.ms)),
                snapshots=len(data["tops0"]) + len(data["tops1"]),
                labels=len(data["cells0"]),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                **counts)


class LossRecorder:
    """The loss of every ``search.train.train_step`` call in a fit, and
    the step's host time up to the loss's copy (which syncs the card)."""

    def __enter__(self):
        from mass_tpu_torch.search import train as ST

        self.losses, self.times = [], []
        self._step = ST.train_step

        def step(*args):
            t0 = time.perf_counter()
            loss = self._step(*args)
            self.losses.append(loss.item())
            self.times.append(1e3 * (time.perf_counter() - t0))
            return loss
        ST.train_step = step
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.search import train as ST

        ST.train_step = self._step


def small_policy_episode(path: str, conditioned: bool) -> dict:
    """A small policy-head episode through the CLI on the card (80x80x24,
    camera 48, task 2): the plain .pth on both phases' goals, the
    conditioned one with inhibition; one launch per group splat."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join("build", "chip_smoke",
                          f"policy-episode-{int(conditioned)}")
    flags = ["--ground-truth-segmentation", "--semantic-search-walkthrough",
             "--semantic-search-unshuffle", "--policy-checkpoint", path]
    if conditioned:
        flags += ["--policy-inhibition-radius", "8"]
    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
        t0 = time.perf_counter()
        metrics = cli.main(SMALL_CLI_ARGS + flags + ["--logdir", logdir])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
    check(len(metrics) == 1, "the CLI ran no policy episode")
    with open(os.path.join(logdir, "results", "2.json")) as f:
        results = json.load(f)
    updates = results["timing"]["mapping"]["count"]
    counts = counter.check_sequential(single, multi, updates, False)
    check(results["timing"]["search_policy"]["count"] > 0,
          "the policy chose no goal")
    return dict(wall_s=wall_s, prop_fixed=results["unshuffle/prop_fixed"],
                policy_goals=results["timing"]["search_policy"]["count"],
                **counts)


# the small episode geometry (small_config) as CLI flags
SMALL_CLI_ARGS = [
    "--backend", "gridworld", "--camera-size", "48", "--map-height", "80",
    "--map-width", "80", "--map-depth", "24", "--grid-resolution", "0.125",
    "--step-size", "2", "--obstacle-padding", "2", "--map-slice-start", "0",
    "--map-slice-stop", "12", "--ground-truth-disagreement",
    "--exploration-budget-one", "2", "--exploration-budget-two", "2",
    "--num-objects", "2", "--num-misplaced", "1", "--num-opened", "0",
    "--start-task", "2", "--total-tasks", "1"]


def phase_search_train() -> dict:
    """``search.train.fit`` at its defaults (600 steps, batch 8, sigma 2,
    decay 1e-4, augmentation) on the collected 80x80 data, plain (the host
    path) and ``--conditioned`` (the device path): wall per step, the best
    validation NLL against uniform; the first steps' losses on the card
    against a CPU fit; a second card fit bit-equal; each .pth through a
    small policy-head episode on the card."""
    from mass_tpu_torch.search import train as ST

    out = {}
    for conditioned in (False, True):
        tag = "conditioned" if conditioned else "plain"
        paths = [os.path.join("build", "chip_smoke", f"policy-{tag}-{k}.pth")
                 for k in range(2)]
        runs = []
        for path in paths:
            log = io.StringIO()
            with LossRecorder() as rec, contextlib.redirect_stdout(log):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nll, dist = ST.fit(SEARCH_DIR, path, conditioned=conditioned)
                torch.cuda.synchronize()
                runs.append(dict(wall_s=time.perf_counter() - t0, nll=nll,
                                 dist=dist, losses=rec.losses,
                                 log=log.getvalue().splitlines()))
        a, b = (torch.load(p, map_location="cpu", weights_only=True)
                for p in paths)
        equal = sorted(a) == sorted(b) and all(
            torch.equal(a[k], b[k]) for k in a)
        check(equal, f"{tag}: two card fits from one seed differ")
        check(runs[0]["losses"] == runs[1]["losses"],
              f"{tag}: two card fits' losses differ")
        with LossRecorder() as rec, contextlib.redirect_stdout(io.StringIO()):
            ST.fit(SEARCH_DIR, os.path.join("build", "chip_smoke",
                                            f"policy-{tag}-cpu.pth"),
                   steps=TRAIN_CHECK_STEPS, conditioned=conditioned,
                   device="cpu")
        card = np.asarray(runs[0]["losses"][:TRAIN_CHECK_STEPS])
        cpu = np.asarray(rec.losses)
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        check(rel <= TRAIN_LOSS_RTOL, f"{tag}: the first "
              f"{TRAIN_CHECK_STEPS} losses differ card against cpu by "
              f"{rel:.3g} (rtol {TRAIN_LOSS_RTOL})")
        h = w = 80
        channels = int(a["0.weight"].shape[1])
        check(channels == (108 if conditioned else 54),
              f"{tag}: the .pth's first conv takes {channels} channels")
        check(np.isfinite(runs[0]["nll"]) and runs[0]["nll"] < np.log(h * w),
              f"{tag}: best val NLL {runs[0]['nll']} not below uniform")
        out[tag] = dict(
            steps=len(runs[0]["losses"]), channels=channels,
            wall_s=runs[0]["wall_s"],
            ms_per_step=1e3 * runs[0]["wall_s"] / len(runs[0]["losses"]),
            best_val_nll=runs[0]["nll"], val_argmax_dist=runs[0]["dist"],
            uniform_nll=float(np.log(h * w)), first_loss=card[0],
            last_loss=runs[0]["losses"][-1], card_cpu_loss_rel_diff=rel,
            runs_bit_equal=equal, log=runs[0]["log"],
            best_line=next(line for line in runs[0]["log"]
                           if line.startswith("best:")),
            episode=small_policy_episode(paths[0], conditioned))
    return out


def policy_train_flops(batch: int, h: int, w: int, channels: int) -> int:
    """Forward, input-gradient and weight-gradient passes of the five
    convs: three times the forward's multiply-adds, two operations each."""
    return 3 * batch * conv_flops(h, w, channels)


def phase_search_train_full(dev) -> dict:
    """``train_step`` at batch 8 on the full-width snapshots (384x384, 54
    channels, and 108 with the walkthrough context): median of 20 steps
    after warm-up (CUDA events), peak memory, the FLOP bound."""
    from mass_tpu_torch.search import train as ST

    data = npz_tasks(SEARCH_FULL_DIR)["task-0.npz"]
    tops = np.concatenate([data["tops0"], data["tops1"]])
    cells = np.concatenate([data["cells0"], data["cells1"]])
    batch = 8
    pick = np.arange(batch) % len(tops)
    x54 = torch.from_numpy(tops[pick].astype(np.float32)).to(dev)
    goals = torch.from_numpy(cells[np.arange(batch) % len(cells)]).to(dev)
    ctx = torch.from_numpy(data["tops0"][-1].astype(np.float32)).to(dev)
    out = {}
    for channels in (54, 108):
        x = x54 if channels == 54 else torch.cat(
            [x54, ctx.expand_as(x54)], dim=-1)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = ST.create_train_state(torch.Generator().manual_seed(0),
                                      channels, 3e-4, 1e-4, dev)
        for _ in range(3):
            ST.train_step(state, x, goals, 2.0)
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = ST.train_step(state, x, goals, 2.0)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        check(np.isfinite(loss.item()), f"{channels} channels: loss {loss}")
        h, w = x.shape[1:3]
        flops = policy_train_flops(batch, h, w, channels)
        out[channels] = dict(
            batch=batch, ms=float(np.median(times)),
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            **bound(0, flops))
        del state, x
    return out


def unet_forward_flops(size: int, num_classes: int = 54,
                       widths=(32, 64, 128, 256)) -> int:
    """Multiply-adds (two operations each) of the UNet's convs on one
    ``size`` x ``size`` image; norms, pools and upsampling add under 2%."""
    macs, cin, s = 0, 3, size
    for w in widths[:-1]:
        macs += 9 * s * s * (cin * w + w * w)
        cin, s = w, s // 2
    macs += 9 * s * s * (cin * widths[-1] + widths[-1] ** 2)
    cin = widths[-1]
    for w in reversed(widths[:-1]):
        s *= 2
        macs += 9 * s * s * ((cin + w) * w + w * w)
        cin = w
    macs += s * s * cin * num_classes
    return 2 * macs


def phase_segmenter_train(dev) -> dict:
    """``detector_dataset generate`` at camera 224 (2 tasks x 8 poses) and
    ``format`` (a quarter for validation), ``train_detector.train`` for two
    epochs at batch 8 on the card: the loss falls and pixel accuracy rises
    over the untrained network; ms per step against the FLOP bound;
    ``segmenter.pth`` through a small ``--detector-arch unet`` episode on
    the card."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.perception import detector as PD
    from mass_tpu_torch.perception import train_detector as TD
    from mass_tpu_torch.tools import detector_dataset as DD

    data, logdir = SEGMENTER_DIR + "-data", SEGMENTER_DIR
    for d in (data, logdir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    DD.main(["generate", "--logdir", data, "--total-tasks", "2",
             "--poses-per-scene", "8", "--camera-size", "224"])
    DD.main(["format", "--logdir", data, "--validation-fraction", "0.25"])
    dataset_s = time.perf_counter() - t0
    val = TD.load_split(data, "validation")
    before = TD.evaluate(PD.init_segmenter(
        torch.Generator().manual_seed(0)).to(dev), *val)
    steps = []
    make_step = TD.make_train_step

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(rgb, sem):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(rgb, sem)
            end.record()
            torch.cuda.synchronize()
            steps.append(start.elapsed_time(end))
            return loss
        return timed
    TD.make_train_step = timed_make_step
    try:
        t0 = time.perf_counter()
        _, history = TD.train(data, logdir, epochs=2, batch_size=8)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        TD.make_train_step = make_step
    after = history[-1]
    check(history[-1]["loss"] < history[0]["loss"],
          f"segmenter loss {[h['loss'] for h in history]} did not fall")
    check(after["pixel_accuracy"] > before["pixel_accuracy"],
          f"pixel accuracy {after['pixel_accuracy']} not above the "
          f"untrained {before['pixel_accuracy']}")
    path = os.path.join(logdir, "segmenter.pth")
    episode_dir = os.path.join("build", "chip_smoke", "unet-episode")
    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
        t0 = time.perf_counter()
        metrics = cli.main(SMALL_CLI_ARGS + [
            "--detector-arch", "unet", "--detector-checkpoint", path,
            "--logdir", episode_dir])
        torch.cuda.synchronize()
        episode_s = time.perf_counter() - t0
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
    check(len(metrics) == 1, "the CLI ran no UNet episode")
    with open(os.path.join(episode_dir, "results", "2.json")) as f:
        results = json.load(f)
    counts = counter.check_sequential(
        single, multi, results["timing"]["mapping"]["count"], False)
    with open(os.path.join(data, "training.json")) as f:
        train_images = len(json.load(f))
    flops = 3 * 8 * unet_forward_flops(224)
    return dict(train_images=train_images, val_images=len(val[0]),
                dataset_s=dataset_s, train_s=train_s,
                steps=len(steps), ms=float(np.median(steps)),
                **bound(0, flops), before=before, history=history,
                episode=dict(wall_s=episode_s, **counts))


# the Mask R-CNN trainer at the detector's full width: R50-FPN at 224 px,
# 53 classes (the dataset skips class 0), the default TrainConfig
MASKRCNN_DIR = os.path.join("build", "chip_smoke", "maskrcnn-train")
MASKRCNN_CLASSES = 53
# one step on the card against float64 on the CPU: the losses within
# rtol 1e-4, every gradient within 1e-4 of the largest (float32 convs
# summed in cuDNN's order)
MASKRCNN_TOL = 1e-4
# steps of the loss-falls check (tests/test_maskrcnn_train.py's 8, its
# learning rate) and of each run that must repeat bit for bit
MASKRCNN_FALL_STEPS, MASKRCNN_FALL_LR = 8, 0.0025
MASKRCNN_RUN_IMAGES = 8


def maskrcnn_card_against_float64(model, batch, key, tcfg, dev) -> dict:
    """One training step of ``model`` (a trainable CPU model, copied to the
    card in float32 and kept on the CPU in float64) on a host ``batch``
    with ``key``: the card's sampled targets against float64's by the
    margin rule (``tests/torch_margins.compare_train_targets``; the
    anchors' samples, and the ROIs' on the card's own proposals), then the
    five losses and every gradient in float64 on the card's targets
    against the card's; and the card's labels and samples equal to the
    CPU's in float32."""
    import copy

    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception import maskrcnn_train as TR
    from mass_tpu_torch.search import prng
    from mass_tpu_torch.utils.training import exact_convs
    from tests import torch_margins

    cfg = model.config
    card, ref = copy.deepcopy(model).to(dev), copy.deepcopy(model).double()
    images, boxes, classes, masks, valid = (
        torch.as_tensor(np.asarray(x)) for x in batch)
    classes, valid = classes.long(), valid.bool()
    B = images.shape[0]
    with exact_convs():
        losses, targets = TR.batch_loss(
            card, tcfg, TM.device_anchors(cfg, dev), images.to(dev),
            boxes.to(dev), classes.to(dev), masks.to(dev), valid.to(dev),
            key.to(dev))
        grads = torch.autograd.grad(losses["total"], list(card.parameters()))
    targets = TR.Targets(*(t.cpu() for t in targets))

    anchors = torch.cat(TM.device_anchors(cfg, "cpu")).double()
    boxes64, masks64 = boxes.double(), masks.double()
    maps, rpn_out = TR.network(ref, images.double())
    sub = prng.split(prng.split(key.cpu(), B), 3)
    with torch.no_grad():
        ref_targets = targets._replace(
            **TR.rpn_samples(tcfg, anchors, boxes64, valid, sub[:, 0],
                             sub[:, 1]),
            **TR.roi_samples(cfg, tcfg, targets.proposals.double(), boxes64,
                             classes, masks64, valid, sub[:, 2]))
    margin = torch_margins.compare_train_targets(
        ref_targets, targets, anchors, boxes64, valid, tcfg)
    check(margin["ok"], f"maskrcnn train: card targets differ from float64 "
          f"beyond the margin rule: {margin}")
    # in float32 the CPU's matching and sampling decide as the card's
    with torch.no_grad():
        cpu = targets._replace(
            **TR.rpn_samples(tcfg, anchors.float(), boxes, valid, sub[:, 0],
                             sub[:, 1]),
            **TR.roi_samples(cfg, tcfg, targets.proposals, boxes, classes,
                             masks, valid, sub[:, 2]))
    for name in ("anchor_label", "rpn_index", "rpn_weight", "rpn_label",
                 "roi_index", "roi_weight", "roi_label", "fg_class"):
        check(torch.equal(getattr(cpu, name), getattr(targets, name)),
              f"maskrcnn train: the card's {name} differ from the CPU's "
              "float32 sampling")
    per_image = TR.image_losses(ref, tcfg, maps, rpn_out, TR.Targets(*(
        t.double() if t.is_floating_point() else t for t in targets)))
    losses64 = {k: v.mean() for k, v in per_image.items()}
    losses64["total"] = sum(losses64.values())
    grads64 = torch.autograd.grad(losses64["total"], list(ref.parameters()))
    loss_rel = {k: abs(float(losses[k].detach()) - float(v.detach()))
                / abs(float(v.detach())) for k, v in losses64.items()}
    check(max(loss_rel.values()) <= MASKRCNN_TOL, f"maskrcnn train: losses "
          f"card against float64 {loss_rel} (rtol {MASKRCNN_TOL})")
    scale = max(float(g.abs().max()) for g in grads64)
    names = [k for k, _ in ref.named_parameters()]
    errs = {k: float((g.cpu().double() - g64).abs().max()) / scale
            for k, g, g64 in zip(names, grads, grads64)}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= MASKRCNN_TOL, f"maskrcnn train: gradient {worst} "
          f"off float64 by {errs[worst]:.3g} of the largest gradient "
          f"(tol {MASKRCNN_TOL})")
    return dict(margin=margin, loss_rel_diff=loss_rel,
                grad_err=errs[worst], grad_err_leaf=worst,
                largest_grad=scale, parameters=len(names),
                losses={k: float(v.detach()) for k, v in losses.items()},
                rpn_positives=float(targets.rpn_label.sum()),
                roi_foreground=float(
                    targets.roi_weight[:, :tcfg.roi_fg_samples].sum()))


def timed_steps(step, batch, keys) -> tuple:
    """``step(batch, key)`` for each key: CUDA events around each step;
    (ms per step, totals)."""
    times, totals = [], []
    for key in keys:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = step(batch, key)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        totals.append(float(losses["total"]))
    return times, totals


def phase_maskrcnn_train(dev) -> dict:
    """``perception/maskrcnn_train`` at full width on the dataset of
    ``[segmenter train]`` (camera 224): one step at batch 2 on the card
    against float64 (:func:`maskrcnn_card_against_float64`); the loss of a
    fixed batch falls over 8 steps; ms a step at batch 2 and 8 (CUDA
    events, median after the first) against the FLOP bound, peak memory;
    ``python -m mass_tpu_torch.perception.maskrcnn_train`` twice on 8
    images (4 steps and the validation split's fused-mask score), the two
    ``maskrcnn.pth`` equal byte for byte, the trainer's NMS launches one a
    step and two a scored frame; ``--eval-only`` with and without
    ``--tta``; the ``maskrcnn.pth`` through a small learned episode on the
    card (``--detector-checkpoint``, the CLI's default threshold)."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception import maskrcnn_train as TR
    from mass_tpu_torch.search import prng

    t_phase = time.perf_counter()
    data = SEGMENTER_DIR + "-data"
    tcfg = TR.TrainConfig()
    cfg = TM.MaskRCNNConfig(num_classes=MASKRCNN_CLASSES, image_size=CAMERA)
    train = TR.load_instance_split(data, "training", tcfg.max_gt)
    with open(os.path.join(data, "validation.json")) as f:
        val_frames = len(json.load(f))
    model = TR.init_maskrcnn(torch.Generator().manual_seed(0), cfg)
    pair = tuple(x[:2] for x in train)
    t0 = time.perf_counter()
    out = dict(check=maskrcnn_card_against_float64(
        model, pair, prng.PRNGKey(1), tcfg, dev))
    out["check_s"] = time.perf_counter() - t0

    # a fixed batch: the loss falls; the step's time at batch 2 and 8
    flops = TM.model_flops(cfg, tcfg.roi_fg_samples + tcfg.roi_bg_samples,
                           tcfg.roi_fg_samples)
    for batch_size in (2, 8):
        model = TR.init_maskrcnn(torch.Generator().manual_seed(0),
                                 cfg).to(dev)
        optimizer = TR.SGD(model.named_parameters(), MASKRCNN_FALL_LR)
        step = TR.make_train_step(model, optimizer, tcfg)
        keys = prng.split(prng.PRNGKey(2), MASKRCNN_FALL_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, totals = timed_steps(step, tuple(x[:batch_size] for x in train),
                                    keys)
        check(all(np.isfinite(totals)), f"batch {batch_size}: losses {totals}")
        if batch_size == 2:
            check(totals[-1] < totals[0], f"the loss of a fixed batch did not "
                  f"fall over {MASKRCNN_FALL_STEPS} steps: {totals}")
        out[f"b{batch_size}"] = dict(
            ms=float(np.median(times[1:])), first_ms=times[0], totals=totals,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            **bound(0, 3 * batch_size * sum(flops.values())))
        del model, optimizer, step
    gc.collect()
    torch.cuda.empty_cache()

    # the entry point on 8 images, twice from one seed
    sub = MASKRCNN_DIR + "-data"
    os.makedirs(sub, exist_ok=True)
    with open(os.path.join(data, "training.json")) as f:
        records = json.load(f)[:MASKRCNN_RUN_IMAGES]
    with open(os.path.join(sub, "training.json"), "w") as f:
        json.dump(records, f)
    shutil.copy(os.path.join(data, "validation.json"), sub)
    runs = [f"{MASKRCNN_DIR}-run{k}" for k in range(2)]
    walls = []
    for k, logdir in enumerate(runs):
        shutil.rmtree(logdir, ignore_errors=True)
        # the trainer's path starts here
        D.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, history = TR.main(["--dataset", sub, "--logdir", logdir])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if k == 0:
            nms_launches = D.LAUNCHES
        # and ends here
    steps = MASKRCNN_RUN_IMAGES // 2
    check(nms_launches == steps + 2 * val_frames, f"the trainer made "
          f"{nms_launches} NMS launches for {steps} steps and {val_frames} "
          "scored frames")
    paths = [os.path.join(d, "maskrcnn.pth") for d in runs]
    blobs = []
    for path in paths:
        with open(path, "rb") as f:
            blobs.append(f.read())
    a, b = (torch.load(p, map_location="cpu", weights_only=True)
            for p in paths)
    check(sorted(a["model"]) == sorted(b["model"]) and all(
        torch.equal(a["model"][k], b["model"][k]) for k in a["model"]),
        "two trainer runs from one seed saved different weights")
    check(blobs[0] == blobs[1], "two trainer runs from one seed saved "
          "different maskrcnn.pth files")
    check(a["class_offset"] == 1 and TM.num_classes_of(a["model"]) ==
          MASKRCNN_CLASSES, "maskrcnn.pth: class offset or count")
    opt = torch.load(os.path.join(runs[0], "maskrcnn-opt.pth"),
                     weights_only=True)
    check(opt["count"] == steps, f"schedule count {opt['count']}")
    out.update(runs_bit_equal=True, run_wall_s=walls, run_steps=steps,
               run_history=history, nms_launches=nms_launches,
               val_frames=val_frames)

    evals = {}
    for tta in (False, True):
        D.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = TR.main(["--dataset", sub, "--logdir", runs[0],
                               "--eval-only"] + (["--tta"] if tta else []))
        torch.cuda.synchronize()
        check(D.LAUNCHES == (4 if tta else 2) * val_frames,
              f"--eval-only{' --tta' if tta else ''}: {D.LAUNCHES} NMS "
              f"launches for {val_frames} frames")
        evals["tta" if tta else "plain"] = dict(
            metrics, wall_s=time.perf_counter() - t0)
    out["eval"] = evals

    episode_dir = os.path.join("build", "chip_smoke", "maskrcnn-episode")
    with SensorTimer() as sensor:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = D.LAUNCHES = 0
        t0 = time.perf_counter()
        metrics = cli.main(SMALL_CLI_ARGS + [
            "--detector-checkpoint", paths[0], "--logdir", episode_dir])
        torch.cuda.synchronize()
        episode_s = time.perf_counter() - t0
        single, multi, nms = SP.LAUNCHES, SP.MULTI_LAUNCHES, D.LAUNCHES
        counts = sensor.check(nms, batch=1, need_fused=False)
    check(len(metrics) == 1, "the CLI ran no episode on the trained .pth")
    with open(os.path.join(episode_dir, "results", "2.json")) as f:
        results = json.load(f)
    check_launches(single, multi, results["timing"]["mapping"]["count"],
                   False)
    out["episode"] = dict(wall_s=episode_s, launches=single,
                          prop_fixed=results["unshuffle/prop_fixed"],
                          **counts)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# tooling: episode videos, map snapshots, trajectory replay, the THOR
# gateway and the results tools
# ----------------------------------------------------------------------

TOOLING_DIR = os.path.join("build", "chip_smoke", "tooling")
# the small episode through the CLI: 80x80x24 at 0.125 m, camera 48,
# budgets 2 + 2, task 2 (the small-episode phases' geometry)
TOOL_ARGS = [
    "--backend", "gridworld", "--camera-size", "48", "--map-height", "80",
    "--map-width", "80", "--map-depth", "24", "--grid-resolution", "0.125",
    "--map-slice-start", "0", "--map-slice-stop", "12", "--step-size", "2",
    "--obstacle-padding", "2", "--max-goal-steps", "80",
    "--exploration-budget-one", "2", "--exploration-budget-two", "2",
    "--ground-truth-segmentation", "--ground-truth-disagreement",
    "--num-objects", "2", "--num-misplaced", "1", "--num-opened", "0"]
REPLAY_FRAMES = 40          # a capture of 39 scripted actions
# uint8 frames, card against CPU: the density's norm sums in another
# order on the card, and the cast to uint8 truncates
FRAME_LEVELS = 1


class VideoRecorder:
    """Wraps the CLI's ``VideoWriter.write`` (the mp4 is still written):
    every frame handed to a writer, by the writer's path, and the host
    time, card synced, of every video callback of the agent (the three
    panels rendered, the frame composed and written) and of its parts:
    the density panel, the two class panels, the composed frame and the
    mp4 write (cv2's encode)."""

    PARTS = ("render_occupancy", "render_semantic", "episode_frame")

    def __init__(self, keep: bool):
        self.keep = keep

    def __enter__(self):
        from mass_tpu_torch.agent import cli
        from mass_tpu_torch.agent.loop import RearrangementAgent
        from mass_tpu_torch.utils import visualization as V

        self.frames, self.times = {}, []
        self.parts = {name: [] for name in self.PARTS + ("write",)}
        self._write = cli.VideoWriter.write
        self._make = RearrangementAgent._make_callback
        self._parts = {name: getattr(V, name) for name in self.PARTS}

        def timed_part(name):
            def part(*args, **kwargs):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = self._parts[name](*args, **kwargs)
                self.parts[name].append(time.perf_counter() - t0)
                return out
            return part
        for name in self.PARTS:
            setattr(V, name, timed_part(name))

        def write(writer, frame):
            kept = self.frames.setdefault(writer.path, [])
            kept.append(np.array(frame) if self.keep else None)
            t0 = time.perf_counter()
            out = self._write(writer, frame)
            self.parts["write"].append(time.perf_counter() - t0)
            return out

        def make(agent, writer):
            callback = self._make(agent, writer)

            def timed(obs):
                if agent.device.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                callback(obs)
                if agent.device.type == "cuda":
                    torch.cuda.synchronize()
                self.times.append(time.perf_counter() - t0)
            return timed
        cli.VideoWriter.write = write
        RearrangementAgent._make_callback = make
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.agent import cli
        from mass_tpu_torch.agent.loop import RearrangementAgent
        from mass_tpu_torch.utils import visualization as V

        cli.VideoWriter.write = self._write
        RearrangementAgent._make_callback = self._make
        for name, fn in self._parts.items():
            setattr(V, name, fn)

    def split_ms(self) -> dict:
        """Mean ms a frame of each part (the class panels: both maps)."""
        frames = max(len(self.times), 1)
        return {name: 1e3 * sum(t) / frames
                for name, t in self.parts.items()}


class SnapshotTimer:
    """Host time, card synced, of every ``write_map_snapshots`` call (the
    float16 cast on the maps' device, the copy to the host and
    ``np.savez_compressed``) and the files written."""

    def __enter__(self):
        from mass_tpu_torch.agent import metrics as M

        self.times, self.paths = [], []
        self._write = M.write_map_snapshots

        def write(logdir, task_id, maps):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = self._write(logdir, task_id, maps)
            self.times.append(time.perf_counter() - t0)
            self.paths.append(path)
            return path
        M.write_map_snapshots = write
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.agent import metrics as M

        M.write_map_snapshots = self._write


def mp4_frames(path: str) -> int:
    """The frames ``cv2.VideoCapture`` decodes from an mp4."""
    import cv2

    video = cv2.VideoCapture(path)
    check(video.isOpened(), f"cv2.VideoCapture cannot open {path}")
    frames = 0
    while video.read()[0]:
        frames += 1
    video.release()
    return frames


def npz_equal(path_a: str, path_b: str) -> list:
    """The arrays of two npz files equal bit for bit (same names and
    dtypes); returns the names."""
    with np.load(path_a) as a, np.load(path_b) as b:
        check(sorted(a.files) == sorted(b.files),
              f"{path_a} and {path_b} hold other arrays")
        for key in a.files:
            check(a[key].dtype == b[key].dtype
                  and np.array_equal(a[key], b[key]),
                  f"{key} of {path_a} differs from {path_b}")
        return sorted(a.files)


def npz_shapes(path: str) -> dict:
    """The shapes of an npz's arrays, from their headers alone (a
    full-width snapshot inflates to 3 GB)."""
    import zipfile

    shapes = {}
    with zipfile.ZipFile(path) as archive:
        for name in archive.namelist():
            with archive.open(name) as f:
                version = np.lib.format.read_magic(f)
                header = (np.lib.format.read_array_header_1_0 if version
                          == (1, 0) else np.lib.format.read_array_header_2_0)
                shapes[name[:-len(".npy")]] = list(header(f)[0])
    return shapes


def tool_run(device: str, flags: list, logdir: str) -> dict:
    """``python -m mass_tpu_torch.agent.cli`` on ``device`` with the
    small flags, writing into a fresh ``logdir``; results of the first
    task."""
    from mass_tpu_torch.agent import cli

    shutil.rmtree(logdir, ignore_errors=True)
    cli.main(TOOL_ARGS + flags + ["--device", device, "--logdir", logdir])
    task = flags[flags.index("--start-task") + 1]
    with open(os.path.join(logdir, "results", f"{task}.json")) as f:
        return json.load(f)


def phase_tooling_small() -> dict:
    """``--videos --snapshot-maps`` on the small default episode (task 2)
    and ``--snapshot-maps`` on the compat episode (the multi-map kernel),
    each on the card and on the CPU: equal results, the frames handed to
    the writer within one level (counted), the npz files bit-equal, a
    frame an observation in the mp4; and a ``--fleet-size 2`` run of
    tasks 2-3 with snapshots whose npz files equal the sequential runs'
    (task 3 with its fleet rng seed) and whose results carry
    ``task_id``."""
    from mass_tpu_torch.ops import splat as SP

    out, launches = {}, {"single": 0, "multi": 0}
    for name, flags in (("default", ["--videos", "--snapshot-maps"]),
                        ("compat", ["--reference-compat",
                                    "--snapshot-maps"])):
        videos = "--videos" in flags
        flags = flags + ["--start-task", "2", "--total-tasks", "1"]
        runs = {}
        for device in ("cuda", "cpu"):
            logdir = os.path.join(TOOLING_DIR, f"{name}-{device}")
            with VideoRecorder(keep=True) as video:
                # the tooling path starts here
                SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
                t0 = time.perf_counter()
                results = tool_run(device, flags, logdir)
                wall = time.perf_counter() - t0
                single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
            mp4 = os.path.join(logdir, "videos", "2.mp4")
            frames = video.frames.get(mp4, [])
            check(len(frames) == len(video.times) == (
                mp4_frames(mp4) if videos else 0) == (
                results["timing"]["mapping"]["count"] if videos else 0),
                f"{name} on {device}: {len(frames)} frames written for "
                f"{len(video.times)} callbacks")
            runs[device] = dict(results=results, frames=frames, wall_s=wall,
                                single=single, multi=multi,
                                npz=os.path.join(logdir, "results",
                                                 "maps-2.npz"))
        gpu, cpu = runs["cuda"], runs["cpu"]
        check(outcome(gpu["results"]) == outcome(cpu["results"]),
              f"tooling {name}: cuda and cpu results differ")
        check(len(gpu["frames"]) == len(cpu["frames"]),
              f"tooling {name}: {len(gpu['frames'])} frames on the card, "
              f"{len(cpu['frames'])} on the CPU")
        diff = [np.abs(a.astype(int) - b.astype(int))
                for a, b in zip(gpu["frames"], cpu["frames"])]
        levels = max((int(d.max()) for d in diff), default=0)
        check(levels <= FRAME_LEVELS, f"tooling {name}: frames differ by "
              f"{levels} levels")
        arrays = npz_equal(gpu["npz"], cpu["npz"])
        updates = gpu["results"]["timing"]["mapping"]["count"]
        check_launches(gpu["single"], gpu["multi"], updates,
                       name == "compat")
        launches["single"] += gpu["single"]
        launches["multi"] += gpu["multi"]
        out[name] = dict(cuda_s=gpu["wall_s"], cpu_s=cpu["wall_s"],
                         frames=len(gpu["frames"]), frame_levels=levels,
                         differing_pixels=int(sum((d > 0).sum()
                                                  for d in diff)),
                         npz_arrays=arrays, launches=gpu["single"],
                         multi_launches=gpu["multi"], map_updates=updates,
                         metrics=outcome(gpu["results"]))

    fleet_dir = os.path.join(TOOLING_DIR, "fleet")
    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0     # fleet path starts here
        t0 = time.perf_counter()
        tool_run("cuda", ["--snapshot-maps", "--fleet-size", "2",
                          "--start-task", "2", "--total-tasks", "2",
                          "--seed", "-2"], fleet_dir)
        fleet_s = time.perf_counter() - t0
        counts = counter.check(SP.LAUNCHES, SP.MULTI_LAUNCHES, False)
    launches["single"] += counts["launches"]
    seq3 = os.path.join(TOOLING_DIR, "default-cuda-3")
    SP.LAUNCHES = 0
    tool_run("cuda", ["--snapshot-maps", "--start-task", "3",
                      "--total-tasks", "1", "--seed", "1"], seq3)
    launches["single"] += SP.LAUNCHES
    for task, sequential in ((2, os.path.join(TOOLING_DIR, "default-cuda")),
                             (3, seq3)):
        npz_equal(os.path.join(fleet_dir, "results", f"maps-{task}.npz"),
                  os.path.join(sequential, "results", f"maps-{task}.npz"))
        with open(os.path.join(fleet_dir, "results", f"{task}.json")) as f:
            check(json.load(f)["task_id"] == task,
                  f"fleet results of task {task} lack task_id")
    out["fleet"] = dict(wall_s=fleet_s, **counts)
    out["launches"] = launches
    return out


def phase_tooling_full(full: dict) -> dict:
    """The full-width default episode (the ``[episode 384x384x96x54]``
    flags) through the CLI with ``--videos --snapshot-maps`` on the card:
    the outcome of the run without them, a frame written an observation
    and decoded back from the mp4, the render and snapshot times, the npz
    size, peak memory and the launches."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join(TOOLING_DIR, "full")
    shutil.rmtree(logdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with VideoRecorder(keep=False) as video, SnapshotTimer() as snap:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0     # main path starts here
        t0 = time.perf_counter()
        cli.main(FULL_ARGS + FULL_BUDGETS + ["--videos", "--snapshot-maps",
                                             "--logdir", logdir])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES   # and ends here
    with open(os.path.join(logdir, "results", "2.json")) as f:
        results = json.load(f)
    updates = results["timing"]["mapping"]["count"]
    check_launches(single, multi, updates, False)
    check(outcome(results) == full["metrics"],
          "--videos --snapshot-maps changed the full-width episode")
    mp4 = os.path.join(logdir, "videos", "2.mp4")
    written = len(video.frames.get(mp4, []))
    decoded = mp4_frames(mp4)
    check(written == len(video.times) == decoded > 0,
          f"{written} frames written, {len(video.times)} callbacks, "
          f"{decoded} decoded")
    check(len(snap.paths) == 1, "one snapshot a task")
    shapes = npz_shapes(snap.paths[0])
    args = cli.build_parser().parse_args(FULL_ARGS)
    check(shapes["semantic0"] == [args.map_height, args.map_width,
                                  args.map_depth, 54],
          f"snapshot shape {shapes['semantic0']}")
    render = 1e3 * np.asarray(video.times)
    return dict(wall_s=wall_s, wall_without_s=full["wall_s"],
                callbacks=len(video.times), frames_written=written,
                mp4_frames=decoded, mp4_bytes=os.path.getsize(mp4),
                render_ms_mean=float(render.mean()),
                render_ms_median=float(np.median(render)),
                render_split_ms=video.split_ms(),
                render_s=float(render.sum() / 1e3),
                snapshot_s=snap.times[0],
                npz_bytes=os.path.getsize(snap.paths[0]), npz_shapes=shapes,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                launches=single, multi_launches=multi, map_updates=updates,
                timing=results["timing"], metrics=outcome(results))


def phase_replay() -> dict:
    """``python -m mass_tpu_torch.env.replay``: two captures of the grid
    world's task 2 at camera 224 (``REPLAY_FRAMES`` frames each) diff as
    ``IDENTICAL``; ``verify`` at 80x80x24 on the card equals the CPU's
    digest; ``verify`` at the CLI's full geometry on the card makes two
    single-map launches a frame, timed apart from the digest's host
    statistics."""
    from mass_tpu_torch.env import replay as R
    from mass_tpu_torch.ops import splat as SP

    folder = os.path.join(TOOLING_DIR, "replay")
    os.makedirs(folder, exist_ok=True)
    capture = ["--camera-size", str(CAMERA), "--ground-truth-segmentation",
               "--start-task", "2"]
    paths = [os.path.join(folder, f"{name}.npz") for name in "ab"]
    t0 = time.perf_counter()
    for path in paths:
        with contextlib.redirect_stdout(io.StringIO()):
            R.main(["capture", "--out", path, "--frames",
                    str(REPLAY_FRAMES - 1)] + capture)
    capture_s = (time.perf_counter() - t0) / 2
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        R.main(["diff"] + paths)
    check(text.getvalue().strip() == "IDENTICAL",
          f"two captures differ: {text.getvalue()}")

    small = capture + ["--map-height", "80", "--map-width", "80",
                       "--map-depth", "24", "--grid-resolution", "0.125"]
    SP.LAUNCHES = 0
    card = R.replay_digest(paths[0], small + ["--device", "cuda"])
    small_launches = SP.LAUNCHES
    cpu = R.replay_digest(paths[0], small + ["--device", "cpu"])
    check(card == cpu, "the card's digest differs from the CPU's")
    check(card["frames"] == REPLAY_FRAMES
          and small_launches == 2 * REPLAY_FRAMES,
          f"{small_launches} launches for {card['frames']} frames")

    stats = []
    statistics = R.map_statistics

    def timed(data, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = statistics(data, *args)
        stats.append(time.perf_counter() - t0)
        return out
    R.map_statistics = timed
    try:
        gc.collect()
        torch.cuda.empty_cache()
        SP.LAUNCHES = 0                       # replay path starts here
        t0 = time.perf_counter()
        full = R.replay_digest(paths[0], capture + ["--device", "cuda"])
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        full_launches = SP.LAUNCHES           # and ends here
    finally:
        R.map_statistics = statistics
    check(full_launches == 2 * REPLAY_FRAMES,
          f"full-width verify: {full_launches} launches for "
          f"{full['frames']} frames")
    check(full["map_semantic"]["nonzero"] > 0
          and np.isfinite(full["map_semantic"]["sum"]),
          "the full-width replay map is empty or not finite")
    return dict(frames=REPLAY_FRAMES, capture_s=capture_s,
                capture_bytes=os.path.getsize(paths[0]),
                small_launches=small_launches, digests_equal=True,
                launches=full_launches, verify_s=verify_s,
                statistics_s=float(sum(stats)),
                ms_per_frame=1e3 * (verify_s - sum(stats)) / REPLAY_FRAMES,
                map_semantic=full["map_semantic"],
                map_occupancy=full["map_occupancy"])


def phase_thor_fake() -> dict:
    """``--backend thor`` on the grid-backed fake of the THOR stack
    (``tests/torch_fake_thor.py``), on the card at 80x80x24: sequentially
    (THOR's first task spec, the grid world's task 0) equal to
    ``--backend gridworld``'s task 0, and a ``--fleet-size 2
    --snapshot-maps`` fleet of tasks 2-3 (slot 1 skipping ahead) equal to
    ``[tooling 80x80x24]``'s grid-world fleet of the same tasks: results,
    ``task_id`` included, and npz files bit for bit."""
    from mass_tpu_torch.ops import splat as SP
    from tests import torch_fake_thor as F

    runs, launches = {}, 0
    for name, device_flags in (
            ("thor-seq", ["--backend", "thor", "--start-task", "0",
                          "--total-tasks", "1"]),
            ("thor-fleet", ["--backend", "thor", "--snapshot-maps",
                            "--fleet-size", "2", "--start-task", "2",
                            "--total-tasks", "2", "--seed", "-2"]),
            ("grid-0", ["--start-task", "0", "--total-tasks", "1"])):
        logdir = os.path.join(TOOLING_DIR, name)
        with F.installed(F.GridBackedSampler):
            SP.LAUNCHES = 0
            t0 = time.perf_counter()
            tool_run("cuda", device_flags, logdir)
            runs[name] = time.perf_counter() - t0
        launches += SP.LAUNCHES if name.startswith("thor") else 0

    def results(name, task):
        with open(os.path.join(TOOLING_DIR, name, "results",
                               f"{task}.json")) as f:
            return json.load(f)
    check(outcome(results("thor-seq", 0)) == outcome(results("grid-0", 0)),
          "the THOR gateway's episode differs from the grid world's")
    for task in (2, 3):
        got, want = results("thor-fleet", task), results("fleet", task)
        check(outcome(got) == outcome(want) and got["task_id"] == task,
              f"THOR fleet task {task} differs from the grid-world fleet's")
        npz_equal(os.path.join(TOOLING_DIR, "thor-fleet", "results",
                               f"maps-{task}.npz"),
                  os.path.join(TOOLING_DIR, "fleet", "results",
                               f"maps-{task}.npz"))
    return dict(launches=launches, **{f"{n}_s": t for n, t in runs.items()},
                prop_fixed=[results("thor-fleet", t)["unshuffle/prop_fixed"]
                            for t in (2, 3)])


def phase_tools() -> dict:
    """``python -m mass_tpu_torch.tools.analyze metrics|failures|pr`` and
    ``tools.submission`` over the logdirs the tooling phases wrote; the
    plots too where matplotlib is installed."""
    from mass_tpu_torch.tools import analyze, submission

    logdirs = [os.path.join(TOOLING_DIR, n)
               for n in ("default-cuda", "full", "fleet", "thor-seq")]
    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    tables = {}
    for command in ("metrics", "failures", "pr"):
        out = os.path.join(TOOLING_DIR, f"{command}.png")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            analyze.main([command] + logdirs
                         + (["--out", out] if plots else []))
        tables[command] = text.getvalue()
        check(text.getvalue().strip(), f"analyze {command} printed nothing")
        check(not plots or os.path.getsize(out) > 0, f"no {out}")
    packed = os.path.join(TOOLING_DIR, "submission.json.gz")
    with contextlib.redirect_stdout(io.StringIO()):
        submission.main(["--logdirs"] + logdirs + ["--output", packed])
    with gzip.open(packed, "rt") as f:
        records = json.load(f)
    check(len(records) >= 3, f"submission packed {len(records)} records")
    return dict(plots=plots, tables=tables, submission_records=len(records))


def tooling_phases(report: dict, full: dict) -> tuple:
    """The five tooling phases, printed and kept in ``report``; returns
    their single-map and multi-map launches."""
    tooling_start = time.perf_counter()
    ts = report["tooling_small"] = phase_tooling_small()
    tag = "tooling 80x80x24"
    for name in ("default", "compat"):
        t = ts[name]
        print(f"[{tag}] {name} task 2 "
              f"{'--videos ' if t['frames'] else ''}--snapshot-maps: cuda "
              f"{t['cuda_s']:.1f} s, cpu {t['cpu_s']:.1f} s, results equal; "
              f"{t['frames']} frames each, the card's within "
              f"{t['frame_levels']} level of the CPU's "
              f"({t['differing_pixels']} pixels differ); npz "
              f"{'/'.join(a for a in t['npz_arrays'] if '_bins_' not in a)}"
              f" bit-equal; launches splat_onehot {t['launches']}, "
              f"splat_onehot_multi {t['multi_launches']} for "
              f"{t['map_updates']} map updates")
    fl = ts["fleet"]
    print(f"[{tag}] --fleet-size 2 --snapshot-maps, tasks 2-3: npz equal "
          f"to the sequential runs' bit for bit, results carry task_id; "
          f"{fl['wall_s']:.1f} s, launches splat_onehot {fl['launches']} "
          f"for {fl['group_splats']} group splats")
    tf = report["tooling_full"] = phase_tooling_full(full)
    tag = "tooling 384x384x96"
    print(f"[{tag}] default task 2 --videos --snapshot-maps: outcome equal "
          f"to [episode 384x384x96x54]; wall {tf['wall_s']:.1f} s against "
          f"{tf['wall_without_s']:.1f} s without the flags; peak memory "
          f"{tf['peak_memory_bytes'] / 2**30:.2f} GiB; launches "
          f"splat_onehot {tf['launches']} for {tf['map_updates']} map "
          f"updates")
    print(f"[{tag}] render {tf['render_ms_mean']:.2f} ms a frame (median "
          f"{tf['render_ms_median']:.2f}; host clock, card synced; "
          f"{tf['render_s']:.1f} s in all); {tf['frames_written']} frames "
          f"written for {tf['callbacks']} callbacks, {tf['mp4_frames']} "
          f"decoded by cv2.VideoCapture ({tf['mp4_bytes'] / 2**20:.1f} MiB "
          f"mp4)")
    print(f"[{tag}] render by part, ms a frame: " + ", ".join(
        f"{k} {v:.2f}" for k, v in tf["render_split_ms"].items())
        + " (the rest: cells of the pose and path, uint8 cast)")
    print(f"[{tag}] snapshot {tf['snapshot_s']:.1f} s (float16 cast on the "
          f"card, copy, np.savez_compressed), npz "
          f"{tf['npz_bytes'] / 2**20:.1f} MiB")
    rp = report["replay"] = phase_replay()
    print(f"[replay] {rp['frames']} frames at camera {CAMERA} "
          f"({rp['capture_bytes'] / 2**20:.1f} MiB, {rp['capture_s']:.1f} s "
          f"a capture): two captures IDENTICAL; verify 80x80x24 cuda == cpu "
          f"digest ({rp['small_launches']} launches); verify 384x384x96 on "
          f"cuda: {rp['ms_per_frame']:.2f} ms a frame (host clock, card "
          f"synced), {rp['launches']} single-map launches, digest "
          f"statistics {rp['statistics_s']:.1f} s; semantic nonzero "
          f"{rp['map_semantic']['nonzero']}")
    th = report["thor_fake"] = phase_thor_fake()
    print(f"[thor fake] --backend thor on the grid-backed fake on cuda: task "
          f"0 sequentially in {th['thor-seq_s']:.1f} s, equal to --backend "
          f"gridworld ({th['grid-0_s']:.1f} s); --fleet-size 2 "
          f"--snapshot-maps, tasks 2-3, in {th['thor-fleet_s']:.1f} s, results"
          f" (task_id included) and npz equal to the grid-world fleet's; "
          f"prop_fixed {th['prop_fixed']}; launches splat_onehot "
          f"{th['launches']}")
    tools = report["tools"] = phase_tools()
    print(f"[tools] analyze metrics, failures and pr over 4 logdirs, "
          f"submission of {tools['submission_records']} records: "
          + ("tables and plots (matplotlib present)" if tools["plots"]
             else "tables only (no matplotlib)"))
    print(tools["tables"]["failures"].rstrip())
    report["tooling_s"] = time.perf_counter() - tooling_start
    print(f"[tooling] the five tooling phases took {report['tooling_s']:.1f}"
          f" s")
    return (ts["launches"]["single"] + tf["launches"] + rp["small_launches"]
            + rp["launches"] + th["launches"], ts["launches"]["multi"])



# ----------------------------------------------------------------------
# more than one device (parallel/mesh.py, sharding.py, the fleet's mesh,
# utils/training.Replicas): slabs of cuda:0 repeated on a one-card machine
# ----------------------------------------------------------------------

SHARD_TOL_UNET = 2e-3     # the UNet's float32 gradients (tests/test_torch_gpu)
DP_STEPS = 12             # the policy fit's steps, as in the CPU test
DP_LR = 1e-4              # (tests/test_torch_data_parallel.py says why)


def slab_devices(n: int) -> list:
    """Where n slabs or replicas go: distinct cards, cycled, on a machine
    with more than one; ``cuda:0`` n times on a one-card machine."""
    count = torch.cuda.device_count()
    return [f"cuda:{k % count}" if count > 1 else "cuda:0"
            for k in range(n)]


def slab_mesh(n: int):
    from mass_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((n,), ("map",), slab_devices(n))


def slabs_equal(sharded, data) -> bool:
    """Each slab of ``sharded`` bit for bit the rows of ``data [V, F]``
    it holds (no gathered copy of the map)."""
    return all(torch.equal(slab, data[first:first + slab.shape[0]].to(
        slab.device)) for first, slab in sharded.slabs())


def phase_shard_kernels(dev) -> dict:
    """The room frame into a 384x384x96x54 map of random values cut into 2
    and 4 slabs: each slab bit for bit the unsharded kernel's rows, one
    single-map launch a slab; the update's slab launches timed together
    (CUDA events on the first card, cold L2, median of 20) beside the
    unsharded launch in this run, and the whole update (sort, gathers,
    re-base, launches).  Then the dense splat at 384x384x96x256 in 2 slabs
    (room frame, stride-4 records): bit-equal, 2 launches."""
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core.voxelmap import VoxelMap, apply_dense_records
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.parallel.sharding import shard_voxelmap

    geo, vm, ids, weights, classes = full_geometry_frame(dev, 0)
    records = SP.sorted_records(ids, weights, classes)
    valid, touched, _ = run_lengths(records, geo.num_voxels)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    want = vm.data.clone()
    SP.apply_records(want, records, 0.5)
    plain = VoxelMap(want.clone(), *vm.bins, geometry=geo)
    out = dict(devices={}, unsharded_ms=cuda_ms(
        lambda: SP.apply_records(plain.data, records, 0.5), 20, flush),
        unsharded_update_ms=cuda_ms(
            lambda: plain.apply_onehot(ids, weights, classes), 20, flush),
        **splat_bound(valid, touched, [geo.feature_size]))
    del plain
    for n in (2, 4):
        sharded = shard_voxelmap(vm, slab_mesh(n))
        before = SP.LAUNCHES
        sharded.apply_onehot(ids, weights, classes)
        torch.cuda.synchronize()
        launches = SP.LAUNCHES - before
        equal = slabs_equal(sharded, want)
        check(launches == n, f"{n} slabs: {launches} launches an update")
        check(equal, f"{n} slabs differ from the unsharded map")
        slab_records = [SP.rebase_records(records, first, slab.device)
                        for first, slab in sharded.slabs()]

        def slab_launches():
            for (_, slab), rec in zip(sharded.slabs(), slab_records):
                SP.apply_records(slab, rec, 0.5)
        out[f"slabs{n}"] = dict(
            launches=launches, bitwise_equal_unsharded=equal,
            ms=cuda_ms(slab_launches, 20, flush),
            update_ms=cuda_ms(lambda: sharded.apply_onehot(
                ids, weights, classes), 20, flush))
        out["devices"][n] = [str(d) for d in sharded.devices]
        del sharded, slab_records
    del vm, want
    torch.cuda.empty_cache()

    geo = MapGeometry(**dict(FULL_MAP, feature_size=DENSE_FEATURES))
    vm = VoxelMap.create(geo, (0.0, 0.0, 0.0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    vm.data.uniform_(generator=gen)
    pixels = (CAMERA // STRIDE) ** 2
    feats = torch.rand((pixels, DENSE_FEATURES), generator=gen, device=dev)
    yaw, elevation, depth, _ = room_frame(CAMERA, np.random.RandomState(0))
    ids, weights = dense_frame(dev, vm, (yaw, elevation, depth))
    records = SP.sorted_dense_records(ids, weights, pixels)
    sharded = shard_voxelmap(vm, slab_mesh(2))
    SP.apply_dense_records(vm.data, records, feats, 0.5)
    before = SP.DENSE_LAUNCHES
    apply_dense_records(sharded, records, feats)
    torch.cuda.synchronize()
    launches = SP.DENSE_LAUNCHES - before
    equal = slabs_equal(sharded, vm.data)
    check(launches == 2, f"dense, 2 slabs: {launches} launches")
    check(equal, "dense, 2 slabs differ from the unsharded map")
    out["dense_slabs2"] = dict(launches=launches,
                               bitwise_equal_unsharded=equal)
    del sharded, vm, flush
    torch.cuda.empty_cache()
    return out


def sharded_small_episode(device: str, slabs: int):
    """The small default episode (task 2, rng seed 0) with its maps in
    ``slabs`` slabs: on the CPU, or on the card's ``slab_mesh``."""
    from mass_tpu_torch.parallel.mesh import make_mesh

    mesh = (make_mesh((slabs,), ("map",), ["cpu"] * slabs)
            if device == "cpu" else slab_mesh(slabs))
    return small_episode(device, mesh=mesh)


def phase_shard_small_episode(small: dict, slabs: int = 4) -> dict:
    """The small default episode in 4 slabs on the card and on the CPU:
    equal to each other and to the unsharded episode of
    ``[episode 80x80x24]`` (results and actions); one single-map launch a
    slab a map update."""
    from mass_tpu_torch.ops import splat as SP

    SP.LAUNCHES = SP.MULTI_LAUNCHES = 0          # main path starts here
    t0 = time.perf_counter()
    gpu, gpu_actions = sharded_small_episode("cuda", slabs)
    gpu_s = time.perf_counter() - t0
    single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES   # and ends here
    t0 = time.perf_counter()
    cpu, cpu_actions = sharded_small_episode("cpu", slabs)
    cpu_s = time.perf_counter() - t0
    updates = gpu["timing"]["mapping"]["count"]
    check(outcome(gpu) == outcome(cpu) == small["metrics"],
          "sharded small episodes: cuda, cpu and unsharded results differ")
    check(gpu_actions == cpu_actions == small["action_list"],
          "sharded small episodes: cuda, cpu and unsharded actions differ")
    check(multi == 0 and single == slabs * updates,
          f"{single} launches for {updates} map updates in {slabs} slabs")
    return dict(slabs=slabs, devices=slab_devices(slabs), cuda_s=gpu_s,
                cpu_s=cpu_s, launches=single, map_updates=updates,
                actions=len(gpu_actions))


def phase_shard_full_episode(full: dict, slabs: int = 2) -> dict:
    """The full-width default episode with its maps in 2 slabs: through
    ``--shard-map 2`` on a machine with two cards, else through the CLI's
    configuration and sampler with a prebuilt mesh of ``cuda:0`` twice
    (the CLI has no flag for slabs on one card).  Its outcome equals
    ``[episode 384x384x96x54]``'s; launches 2 a map update."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.agent.loop import RearrangementAgent
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join("build", "chip_smoke", f"episode_slabs{slabs}")
    argv = full_args(False) + FULL_BUDGETS + ["--logdir", logdir]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with SplatCounter() as counter:
        # main path starts here
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
        t0 = time.perf_counter()
        if torch.cuda.device_count() >= slabs:
            route = f"--shard-map {slabs}"
            metrics = cli.main(argv + ["--shard-map", str(slabs)])
        else:
            route = f"a mesh of cuda:0 x {slabs}"
            args = cli.build_parser().parse_args(argv)
            config = cli.config_from_args(args)
            os.makedirs(logdir, exist_ok=True)
            metrics = RearrangementAgent(
                config, cli.make_sampler(args, config),
                rng=np.random.RandomState(args.seed), device="cuda",
                mesh=slab_mesh(slabs)).run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        # main path ends here
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
    check(len(metrics) == 1, "the sharded full-width run ran no episode")
    with open(os.path.join(logdir, "results", "2.json")) as f:
        results = json.load(f)
    updates = results["timing"]["mapping"]["count"]
    same = outcome(results) == full["metrics"]
    check(same, "the sharded full-width episode differs from "
          "[episode 384x384x96x54]")
    check(multi == 0 and single == slabs * updates == slabs *
          full["launches"] and len(counter.splats) == updates,
          f"{single} launches for {updates} map updates in {slabs} slabs")
    return dict(slabs=slabs, route=route, devices=slab_devices(slabs),
                wall_s=wall_s, unsharded_wall_s=full["wall_s"],
                launches=single, multi_launches=multi, map_updates=updates,
                group_splats=len(counter.splats),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                unsharded_peak_memory_bytes=full["peak_memory_bytes"],
                outcome_equal=same, timing=results["timing"])


def phase_shard_fleet(slabs: int = 4) -> dict:
    """A B = 3 small default fleet (tasks 2-4) with every family's buffer
    in 4 slabs (episodes cross slabs: their views are gathered copies)
    against the unsharded fleet on the card: equal results and actions;
    each group splat one launch a slab."""
    from mass_tpu_torch.ops import splat as SP

    tasks, seeds = (2, 3, 4), (0, 1, 2)
    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0          # fleet path starts here
        t0 = time.perf_counter()
        sharded, sharded_actions = small_fleet(
            "cuda", False, tasks, seeds, mesh=slab_mesh(slabs))
        wall_s = time.perf_counter() - t0
        single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES   # and ends here
        splats = len(counter.splats)
    plain, plain_actions = small_fleet("cuda", False, tasks, seeds)
    for k, task in enumerate(tasks):
        check(outcome(sharded[k]) == outcome(plain[k]),
              f"sharded fleet task {task} differs from the unsharded fleet")
        check(sharded_actions[k] == plain_actions[k],
              f"sharded fleet task {task}: actions differ")
    check(single + multi == slabs * splats,
          f"{single} + {multi} launches for {splats} group splats in "
          f"{slabs} slabs")
    return dict(slabs=slabs, tasks=tasks, wall_s=wall_s, launches=single,
                multi_launches=multi, group_splats=splats,
                actions=[len(a) for a in sharded_actions])


def max_rel_grad_diff(a: dict, b: dict) -> float:
    """The largest gradient difference over the largest gradient."""
    scale = max(float(g.abs().max()) for g in b.values())
    return max(float((a[k] - b[k]).abs().max()) for k in b) / scale


def phase_data_parallel(dev) -> dict:
    """The data-parallel trainers with 2 replicas (``cuda:0`` twice on a
    one-card machine): the policy fit (12 steps at lr 1e-4 on the
    collected 80x80 data) against the one-device fit, per-step losses
    and validation NLL within rtol 1e-4, ms a step; the UNet step (batch 2 of the
    segmenter's 224 px frames) and the Mask R-CNN step (batch 2, 224 px, 53
    classes) against the one-device step from the same parameters: losses
    within rtol 1e-4, gradients within the card's tolerances of the
    largest (UNet 2e-3, Mask R-CNN 1e-4); two runs of each bit-equal; ms
    a step (CUDA events, median after the first) beside one device's."""
    import copy

    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.perception import detector as PD
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception import maskrcnn_train as TR
    from mass_tpu_torch.perception import train_detector as TD
    from mass_tpu_torch.search import prng
    from mass_tpu_torch.search import train as ST

    devices = slab_devices(2)
    out = dict(devices=devices)

    # the policy fit
    fits = {}
    for name, devs in (("dp", devices), ("dp_again", devices),
                       ("one", None)):
        path = os.path.join("build", "chip_smoke", f"policy-{name}.pth")
        with LossRecorder() as rec, contextlib.redirect_stdout(io.StringIO()):
            nll, _ = ST.fit(SEARCH_DIR, path, steps=DP_STEPS,
                            learning_rate=DP_LR, data_parallel=bool(devs),
                            devices=devs, log_every=DP_STEPS)
        fits[name] = dict(nll=nll, losses=rec.losses,
                          step_ms=float(np.median(rec.times[1:])),
                          state=torch.load(path, map_location="cpu",
                                           weights_only=True))
    dp, one = fits["dp"], fits["one"]
    rel = float(np.max(np.abs(np.asarray(dp["losses"]) - one["losses"])
                       / np.abs(one["losses"])))
    equal = all(torch.equal(dp["state"][k], fits["dp_again"]["state"][k])
                for k in dp["state"])
    check(rel <= TRAIN_LOSS_RTOL and abs(dp["nll"] - one["nll"])
          <= TRAIN_LOSS_RTOL * abs(one["nll"]),
          f"policy fit, 2 replicas against one device: losses {rel:.3g}, "
          f"val NLL {dp['nll']} against {one['nll']}")
    check(equal, "two data-parallel policy fits differ")
    out["fit"] = dict(steps=DP_STEPS, loss_rel_diff=rel, nll=dp["nll"],
                      one_device_nll=one["nll"], runs_bit_equal=equal,
                      ms=dp["step_ms"], one_device_ms=one["step_ms"])

    # the UNet step: gradients read off one SGD step of rate 1
    rgb, sem = (x[:2] for x in TD.load_split(SEGMENTER_DIR + "-data",
                                             "training"))
    base = PD.init_segmenter(torch.Generator().manual_seed(0)).to(dev)

    def unet(devs, runs=5):
        model = copy.deepcopy(base)
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        step = TD.make_train_step(model, torch.optim.SGD(
            model.parameters(), 1.0), TD.class_weights(sem), devs)
        loss = float(step(rgb, sem))
        grads = {k: before[k] - v.detach()
                 for k, v in model.named_parameters()}
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(rgb, sem)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return loss, grads, float(np.median(times))
    loss, grads, ms = unet(devices)
    loss_again, grads_again, _ = unet(devices)
    one_loss, one_grads, one_ms = unet(None)
    grad_err = max_rel_grad_diff(grads, one_grads)
    equal = loss == loss_again and all(
        torch.equal(grads[k], grads_again[k]) for k in grads)
    check(abs(loss - one_loss) <= TRAIN_LOSS_RTOL * abs(one_loss)
          and grad_err <= SHARD_TOL_UNET,
          f"UNet, 2 replicas against one device: loss {loss} against "
          f"{one_loss}, gradients {grad_err:.3g} of the largest")
    check(equal, "two data-parallel UNet steps differ")
    out["unet"] = dict(loss=loss, one_device_loss=one_loss,
                       grad_err=grad_err, runs_bit_equal=equal, ms=ms,
                       one_device_ms=one_ms)

    # the Mask R-CNN step
    tcfg = TR.TrainConfig()
    cfg = TM.MaskRCNNConfig(num_classes=MASKRCNN_CLASSES, image_size=CAMERA)
    batch = tuple(x[:2] for x in TR.load_instance_split(
        SEGMENTER_DIR + "-data", "training", tcfg.max_gt))
    base = TR.init_maskrcnn(torch.Generator().manual_seed(0), cfg).to(dev)

    def maskrcnn(devs, runs=5):
        model = copy.deepcopy(base)
        opt = TR.SGD(model.named_parameters(), MASKRCNN_FALL_LR)
        seen, inner = {}, opt.step

        def keep(g):
            g = list(g)
            seen.update(zip(opt.params, (x.clone() for x in g)))
            inner(g)
        opt.step = keep
        step = TR.make_train_step(model, opt, tcfg, devs)
        D.LAUNCHES = 0
        losses = {k: float(v) for k, v in step(batch, prng.PRNGKey(1))
                  .items()}
        nms = D.LAUNCHES
        opt.step = inner
        times, _ = timed_steps(step, batch, prng.split(prng.PRNGKey(2),
                                                       runs))
        return losses, seen, nms, float(np.median(times[1:]))
    losses, grads, nms, ms = maskrcnn(devices)
    losses_again, grads_again, _, _ = maskrcnn(devices)
    one_losses, one_grads, one_nms, one_ms = maskrcnn(None)
    loss_rel = max(abs(losses[k] - one_losses[k]) / abs(one_losses[k])
                   for k in one_losses)
    grad_err = max_rel_grad_diff(grads, one_grads)
    equal = losses == losses_again and all(
        torch.equal(grads[k], grads_again[k]) for k in grads)
    check(loss_rel <= TRAIN_LOSS_RTOL and grad_err <= MASKRCNN_TOL,
          f"Mask R-CNN, 2 replicas against one device: losses "
          f"{loss_rel:.3g}, gradients {grad_err:.3g} of the largest")
    check(equal, "two data-parallel Mask R-CNN steps differ")
    check(nms == 2 and one_nms == 1, f"{nms} NMS launches a 2-replica step "
          f"({one_nms} on one device)")
    out["maskrcnn"] = dict(loss_rel_diff=loss_rel, grad_err=grad_err,
                           runs_bit_equal=equal, nms_launches=nms, ms=ms,
                           one_device_ms=one_ms, total=losses["total"])
    del base
    torch.cuda.empty_cache()
    return out


def kernel_line(name: str, replaces: str, launches: int,
                phase: dict) -> dict:
    from mass_tpu_torch.ops import splat as SP

    library = SP._ENTRIES[name][0]
    return dict(name=name, route="cuda",
                source=f"mass_tpu_torch/csrc/{library}.cu", replaces=replaces,
                launches=launches, max_abs_err=phase["max_abs_err"],
                ms=phase["ms"], plain_ms=phase["plain_ms"],
                bound_ms=phase["bound_ms"], bound_by=phase["bound_by"],
                library_ms=phase["library_ms"])


def print_splat(tag: str, k: dict) -> None:
    print(f"[{tag}] full geometry, maps F={k.get('maps', [54])}: touched "
          f"voxels U={k['touched_voxels']}, records={k['valid_records']} "
          f"valid of {k['records']}, longest run {k['longest_run']}; max "
          f"abs diff vs plain {k['max_abs_err']:.3g} (tol {SPLAT_TOL}); two "
          f"runs bit-identical: {k['bit_identical_runs']}; equal to the "
          f"plain CPU version: {k['bitwise_equal_cpu_plain']}")
    print(f"[{tag}] kernel {k['ms']:.4f} ms (before the redesign: "
          f"{k['before_ms']:.4f} ms), "
          f"bound {k['bound_ms']:.4f} ms ({k['bytes']} B: id, weight and "
          f"class per valid record, each touched row read and written, at "
          f"3.35 TB/s), {k['ms'] / k['bound_ms']:.2f}x the bound; plain "
          f"{k['plain_ms']:.4f} ms; library call: none")
    print(f"[{tag}] record prep: sort {k['sort_ms']:.4f} ms, gathers "
          f"{k['gather_ms']:.4f} ms, no cut (the kernel finds the runs)")


def print_frames(tag: str, what: str, k: dict) -> None:
    before = (f" (before the redesign: {k['before_ms']:.3f} ms)"
              if "before_ms" in k else "")
    print(f"[{tag}] {what}: U={k['touched_voxels']}, {k['sub_runs']} "
          f"(voxel, frame) sub-runs, {k['valid_records']} valid records; "
          f"max abs diff vs plain {k['max_abs_err']:.3g} (tol {SPLAT_TOL});"
          f" two runs bit-identical: {k['bit_identical_runs']}; equal to "
          f"the plain CPU version: {k['bitwise_equal_cpu_plain']}")
    print(f"[{tag}] kernel {k['ms']:.4f} ms per launch{before}, device "
          f"time {k['device_ms']:.4f} ms a recorded launch ({recorded(k)}); "
          "bound "
          f"{k['bound_ms']:.4f} ms ({k['bytes']} B: id, weight, class and "
          f"frame per valid record, each touched row read and written "
          f"once, at 3.35 TB/s), {k['ms'] / k['bound_ms']:.2f}x the bound;"
          f" plain {k['plain_ms']:.3f} ms; library call: none")


def print_nms(nms: dict) -> None:
    st = nms["step"]
    for key, what in (("rpn_b1", "RPN, one frame"),
                      ("detection_b1", "class-aware, one frame"),
                      ("rpn_b8", "RPN, eight frames")):
        k, prob = nms[key], nms["problems"][key]
        terms = ", ".join(f"{t} {v:.5f} ms" for t, v in
                          k["terms_ms"].items())
        print(f"[nms] {what} {prob['shape']} (caps {prob['outputs']}; "
              f"{prob['live_boxes']} live boxes, {prob['live_pairs']} live "
              f"pairs, at most {prob['taken_max']} positions taken): kernel "
              f"{k['ms']:.4f} ms (before: {k['before_ms']:.4f} ms), "
              f"{k['back_to_back_ms']:.4f} ms a launch back to back, device "
              f"time {k['device_ms']:.4f} ms a recorded launch "
              f"({recorded(k)}); bound {k['bound_ms']:.5f} ms by the "
              f"{k['bound_term']} ({terms}), {k['ms'] / k['bound_ms']:.1f}x "
              f"the bound; plain loop on the card {k['plain_ms']:.2f} ms; "
              "library call: none")
    print(f"[nms] dependent steps: a shared-memory load "
          f"{st['load_cycles']:.1f} cycles ({st['load_ns']:.2f} ns), a logic "
          f"operation {st['op_cycles']:.1f} cycles ({st['op_ns']:.2f} ns); SM "
          f"at {st['sm_ghz']:.2f} GHz")
    for n, c in nms["config"].items():
        print(f"[nms] N={n}: {c['threads']} threads a block, "
              f"{c['cluster_blocks']} blocks a cluster (one a problem), "
              f"{c['registers']} registers and {c['spill_bytes']} B spilled "
              f"a thread, {c['shared_bytes']} B of dynamic shared memory a "
              f"block, {c['resident_clusters']} clusters resident at once")
    print(f"[nms] keep indices equal to the plain loop on the CPU: the "
          f"detector's problems {sorted(nms['problems'])}, the streams "
          f"{sorted(nms['streams'])}")


def print_episode(tag: str, full: dict) -> None:
    print(f"[{tag}] budgets {' '.join(full['budgets'])}")
    print(f"[{tag}] wall {full['wall_s']:.1f} s, peak memory "
          f"{full['peak_memory_bytes'] / 2**30:.2f} GiB, launches: "
          f"splat_onehot {full['launches']}, splat_onehot_multi "
          f"{full['multi_launches']}, for {full['map_updates']} map updates "
          f"({full['group_splats']} group splats)")
    policy = full["timing"].get("search_policy")
    if policy:
        print(f"[{tag}] search_policy {policy['mean_ms']:.2f} ms per goal "
              f"({policy['count']} goals)")
    print(f"[{tag}] timing {json.dumps(full['timing'])}")
    print(f"[{tag}] metrics {json.dumps(full['metrics'])}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mass_tpu_torch.ops import splat as SP

    dev = torch.device("cuda")
    report = {}

    start = t0 = time.perf_counter()
    report["build_s"] = SP.build()
    built = ", ".join(f"{k}.cu {v:.2f} s"
                      for k, v in report["build_s"].items())
    print(f"[build] {built} (one nvcc each, in parallel: "
          f"{time.perf_counter() - t0:.2f} s)")

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["card"] = {"name": name, "nvidia_smi": smi,
                      "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"[card] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)

    for tag, key, phase in (("splat", "splat_full_geometry",
                             phase_kernel_full_geometry),
                            ("multi", "multi_full_geometry",
                             phase_multi_full_geometry)):
        result = report[key] = phase(dev)
        print_splat(tag, result)
    kernel = report["splat_full_geometry"]
    multi = report["multi_full_geometry"]
    print(f"[multi] equal to the single-map kernel per map: "
          f"{multi['bitwise_equal_single_kernel']}")

    skewed = report["skewed_frame"] = phase_skewed_frame(dev)
    print(f"[skewed] wall 0.3 m ahead: U={skewed['touched_voxels']}, "
          f"records={skewed['valid_records']} valid of {skewed['records']},"
          f" longest run {skewed['longest_run']} records (tile "
          f"{SP.tile_records()}); equal to the plain CPU version: single "
          f"{skewed['single']['bitwise_equal_cpu_plain']}, multi "
          f"{skewed['multi']['bitwise_equal_cpu_plain']}; two runs "
          f"bit-identical: {skewed['single']['bit_identical_runs']}, "
          f"{skewed['multi']['bit_identical_runs']}; kernel "
          f"{skewed['single']['ms']:.4f} ms single, "
          f"{skewed['multi']['ms']:.4f} ms multi")

    many = report["many_tiles"] = phase_many_tiles(dev)
    print(f"[tiles] {many['tiles']} tiles + 517 records "
          f"({many['records']} records, U={many['touched_voxels']}, longest "
          f"run {many['longest_run']}), three or more per block of the "
          f"persistent grid: equal to the plain CPU version: single "
          f"{many['single']['bitwise_equal_cpu_plain']}, multi "
          f"{many['multi']['bitwise_equal_cpu_plain']}; two runs "
          f"bit-identical: {many['single']['bit_identical_runs']}, "
          f"{many['multi']['bit_identical_runs']}")

    frames = report["frames"] = phase_frames(dev)
    print(f"[frames] {frames['frames']} bench.py frames in groups of "
          f"{frames['group']}: {frames['launches']} launches, equal to "
          f"{frames['frames']} single-map updates bit for bit: "
          f"{frames['bitwise_equal_sequential']}; frames route "
          f"{frames['frames_route_fps']:.1f} frames/s, sequential route "
          f"{frames['sequential_route_fps']:.1f} frames/s (card synced)")
    print_frames("frames", "one bench.py group", frames)
    print(f"[frames] record prep (sorted_frame_records) "
          f"{frames['prep_ms']:.4f} ms: sort {frames['sort_ms']:.4f} ms, "
          f"gathers {frames['gather_ms']:.4f} ms, no cut; prep and launch "
          f"clean under sync debug mode 'error': "
          f"{frames['sync_free_prep_and_launch']}")
    print(f"[frames] binning of one group of {frames['group']} "
          f"{frames['group_binning_ms']:.3f} ms as one batch, "
          f"{frames['per_frame_binning_ms']:.3f} ms frame by frame "
          f"(host clock, card synced)")
    wall = report["wall_frames"] = phase_wall_frames(dev)
    print_frames("wall frames", f"8 frames of a wall 0.30-0.37 m ahead "
                 f"(longest run {wall['longest_run']}, longest sub-run "
                 f"{wall['longest_sub_run']}, {wall['sub_runs_across_tiles']}"
                 f" sub-runs across a tile's end)", wall)

    dense = report["dense_kernel"] = phase_dense_kernel(dev)
    tag = "dense kernel 384x384x96x256"
    for what, k in (("room frame", dense), ("wall frame 0.3 m", dense["wall"]),
                    ("many runs", dense["many"])):
        print(f"[{tag}] {what}"
              + (" through the 56x56 feature camera" if "frame" in what
                 else "") + ": "
              f"U={k['touched_voxels']}, records={k['valid_records']} valid "
              f"of {k['records']}, longest run {k['longest_run']}; max abs "
              f"diff vs plain {k['max_abs_err']:.3g} (tol {SPLAT_TOL}); two "
              f"runs bit-identical: {k['bit_identical_runs']}; equal to the "
              f"plain CPU version on the touched rows: "
              f"{k['bitwise_equal_cpu_plain']}; other rows untouched: "
              f"{k['untouched_rows_unchanged']}; kernel {k['ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bytes']} B), "
              f"{k['ms'] / k['bound_ms']:.2f}x the bound")
    for what, k in (("room frame", dense["device"]),
                    ("wall frame", dense["wall"]["device"]),
                    ("the room frame's first 32 records alone (one window)",
                     dense["one_window_device"])):
        print(f"[{tag}] device time (torch.profiler), {what}: "
              f"{k['device_ms']:.4f} ms a recorded launch ({recorded(k)})")
    print(f"[{tag}] one window: {dense['one_window_ms']:.4f} ms (events)")
    print(f"[{tag}] room frame: kernel {dense['ms']:.4f} ms beside its "
          f"record prep (sort, gathers) {dense['prep_ms']:.4f} ms; map "
          f"{dense['map_bytes'] / 2**30:.2f} GiB; plain "
          f"{dense['plain_ms']:.4f} ms; index_add_ of the same contributions "
          f"(the additive half alone, float atomics) "
          f"{dense['index_add_ms']:.4f} ms; library call: none")
    config = dense["config"]
    print(f"[{tag}] kernel as built: {config['threads']} threads a block, a "
          f"warp per {config['window_records']} records x "
          f"{config['slice_channels']} channels, the lines of "
          f"{config['step_records']} window records or "
          f"{config['tail_step_records']} tail records a load, tail ids "
          f"{config['tail_load_records']} a load; {config['registers']} "
          f"registers and {config['spill_bytes']} spilled bytes a thread, "
          f"{config['blocks_per_sm']} blocks an SM")
    bb = report["backbone"] = phase_backbone(dev)
    print(f"[backbone] one 224x224 frame: {bb['ms']:.3f} ms (bound "
          f"{bb['bound_ms']:.4f} ms by {bb['bound_by']}: "
          f"{bb['flops'] / 1e9:.2f} GFLOP at 67 TFLOP/s fp32), B = 2 "
          f"{bb['batch2_ms']:.3f} ms; load and first call "
          f"{bb['load_and_first_call_ms']:.1f} ms; max abs diff vs the CPU "
          f"{bb['max_abs_err_cpu']:.3g} (tol {BACKBONE_TOL}); batch of two "
          f"vs one {bb['batch_of_two_max_abs_diff']:.3g}")

    for compat in (False, True):
        small = phase_small_episodes(compat)
        tag = "compat 80x80x24" if compat else "episode 80x80x24"
        report["small_compat_episodes" if compat else "small_episodes"] = \
            small
        print(f"[{tag}] cuda {small['cuda_s']:.1f} s, cpu "
              f"{small['cpu_s']:.1f} s, {small['actions']} actions, results"
              f" equal; launches splat_onehot {small['launches']}, "
              f"splat_onehot_multi {small['multi_launches']}, for "
              f"{small['map_updates']} map updates")

    full = phase_full_episode()
    report["full_episode"] = full
    print_episode("episode 384x384x96x54", full)
    compat = phase_full_episode(compat=True)
    report["full_compat_episode"] = compat
    print_episode("compat 384x384x96x54", compat)

    maps = report["fleet_maps"] = phase_fleet_maps(dev)
    print(f"[fleet maps] B={maps['batch']} at 384x384x96, families "
          f"{maps['families']} ({maps['buffer_bytes'] / 1e9:.1f} GB of "
          f"buffers, peak {maps['peak_memory_bytes'] / 2**30:.2f} GiB), room "
          f"frames, {maps['steps']['unmasked']['records']} records a step")
    print(f"[fleet maps] unmasked step: {maps['steps']['unmasked']} "
          f"launches; mixed-mask step: {maps['steps']['mixed']} launches; "
          f"episodes 0 and {FLEET - 1} equal single-map kernel updates of "
          f"clones of their slabs bit for bit: "
          f"{maps['bitwise_equal_single_kernel']}; two runs identical: "
          f"{maps['runs_identical']}")
    print(f"[fleet maps] unmasked step {maps['step_ms']:.2f} ms (host clock, "
          f"card synced; splat kernel device time "
          f"{maps['step_kernel_device_ms']:.3f} ms: a recorded launch's "
          f"times the step's launches, "
          f"{recorded(maps['step_kernel_trace'])}) against "
          f"{maps['sequential_update_group_ms']:.2f} ms for {FLEET} "
          f"MapSet.update_group calls of the same frames")
    for flag, key in ((False, "small_episodes"),
                      (True, "small_compat_episodes")):
        small = phase_small_fleet(flag, report[key])
        report[f"fleet_{key}"] = small
        print(f"[fleet 80x80x24] {'compat' if flag else 'default'}, B=2 "
              f"(tasks {small['tasks']}, rng seeds {small['rng_seeds']}): "
              f"cuda {small['cuda_s']:.1f} s, cpu {small['cpu_s']:.1f} s, "
              f"{small['actions']} actions; cuda == cpu == the sequential "
              f"agent per episode; launches splat_onehot {small['launches']}"
              f", splat_onehot_multi {small['multi_launches']} for "
              f"{small['group_splats']} group splats, "
              f"{small['map_updates']} episode map updates")
    for size, flag, sequential in ((FULL_FLEET, False, full),
                                   (2, True, compat)):
        fleet = phase_full_fleet(size, flag, sequential)
        tag = f"fleet 384x384x96x54{' compat' if flag else ''}"
        report[f"full_fleet{'_compat' if flag else ''}"] = fleet
        print(f"[{tag}] {' '.join(fleet['argv'])}")
        print(f"[{tag}] {size} episodes in {fleet['wall_s']:.1f} s: "
              f"{fleet['episode_s']:.2f} s per episode against "
              f"{fleet['sequential_episode_s']:.1f} s for the sequential "
              f"episode; peak memory "
              f"{fleet['peak_memory_bytes'] / 2**30:.2f} GiB; task 2 equals "
              f"the sequential episode: {fleet['task2_equals_sequential']}; "
              f"prop_fixed {fleet['prop_fixed']}")
        print(f"[{tag}] launches: splat_onehot {fleet['launches']}, "
              f"splat_onehot_multi {fleet['multi_launches']}, for "
              f"{fleet['group_splats']} group splats and "
              f"{fleet['map_updates']} episode map updates "
              f"{fleet['episode_map_updates']}")
        print(f"[{tag}] fleet_timing {json.dumps(fleet['fleet_timing'])}")

    goal = report["policy_goal"] = phase_policy_goal(dev)
    print(f"[policy] full width: max over depth of one map "
          f"{goal['max_over_depth_ms']:.3f} ms (bound "
          f"{goal['max_over_depth_bound_ms']:.3f} ms by bytes)")
    for head in ("C", "B"):
        g = goal[head]
        print(f"[policy] {head}, {g['channels']} channels: load and first "
              f"call {g['load_and_first_call_ms']:.1f} ms; five convs "
              f"{g['convs_ms']:.3f} ms (bound {g['convs_bound_ms']:.3f} ms "
              f"by {g['convs_bound_by']}: {g['convs_flops'] / 1e9:.1f} "
              f"GFLOP at 67 TFLOP/s fp32); Gumbel-max draw "
              f"{g['categorical_ms']:.3f} ms, inhibited decode "
              f"{g['inhibited_decode_ms']:.3f} ms (host clock, card "
              f"synced); whole policy goal (inhibition "
              f"{g['inhibition']}) {g['policy_goal_ms']:.3f} ms")
    heads = {}
    for head in HEAD_FLAGS:
        small = heads[head] = phase_small_heads(head)
        report[f"small_heads_{head}"] = small
        print(f"[heads 80x80x24] {head} ({' '.join(HEAD_FLAGS[head])}): cuda"
              f" {small['cuda_s']:.1f} s, cpu {small['cpu_s']:.1f} s, "
              f"{small['actions']} actions, results equal; launches "
              f"splat_onehot {small['launches']}, splat_onehot_multi "
              f"{small['multi_launches']} for {small['group_splats']} group "
              f"splats: {small['map_updates']} map updates + "
              f"{small['goal_fed_updates']} goal-fed; prop_fixed "
              f"{small['metrics']['unshuffle/prop_fixed']}")
    full_heads = {}
    for head in HEAD_FLAGS:
        full_head = full_heads[head] = phase_full_episode(head=head)
        report[f"full_heads_{head}"] = full_head
        print_episode(f"heads 384x384x96x54 {head}", full_head)
    for head in HEAD_FLAGS:
        small = phase_small_fleet(False, heads[head], head)
        report[f"fleet_small_heads_{head}"] = small
        print(f"[fleet heads] {head}, B=2 (tasks {small['tasks']}): cuda "
              f"{small['cuda_s']:.1f} s, cpu {small['cpu_s']:.1f} s, "
              f"{small['actions']} actions; cuda == cpu == the sequential "
              f"agent per episode; launches splat_onehot "
              f"{small['launches']}, splat_onehot_multi "
              f"{small['multi_launches']} for {small['group_splats']} group "
              f"splats, {small['map_updates']} episode map updates")
    fleet = report["full_fleet_heads_B"] = phase_full_fleet(
        2, False, full_heads["B"], head="B")
    tag = "fleet heads 384x384x96x54 B"
    print(f"[{tag}] {' '.join(fleet['argv'])}")
    print(f"[{tag}] 2 episodes in {fleet['wall_s']:.1f} s: "
          f"{fleet['episode_s']:.2f} s per episode against "
          f"{fleet['sequential_episode_s']:.1f} s for the sequential "
          f"episode; peak memory {fleet['peak_memory_bytes'] / 2**30:.2f} "
          f"GiB; task 2 equals the sequential episode: "
          f"{fleet['task2_equals_sequential']}; prop_fixed "
          f"{fleet['prop_fixed']}; launches splat_onehot {fleet['launches']}"
          f" for {fleet['group_splats']} group splats and "
          f"{fleet['map_updates']} episode map updates")
    print(f"[{tag}] fleet_timing {json.dumps(fleet['fleet_timing'])}")

    small_features = report["small_features"] = phase_small_features()
    for task, small in small_features.items():
        print(f"[features 80x80x24] fm protocol task {task}: cuda "
              f"{small['cuda_s']:.1f} s, cpu {small['cpu_s']:.1f} s, "
              f"{small['actions']} actions, results equal"
              + (", equal to the committed record"
                 if small["equals_committed_record"] else "")
              + f"; launches splat_onehot {small['launches']}, splat_dense "
              f"{small['dense_launches']} for {small['map_updates']} map "
              f"updates; success {small['metrics']['unshuffle/success']}, "
              f"ep_length {small['metrics']['unshuffle/ep_length']}, moved "
              f"{small['metrics']['unshuffle/objects_moved']}")
    full_features = report["full_features"] = phase_full_features()
    tag = "features 384x384x96"
    print_episode(tag, full_features)
    ms = full_features["mapping_split"]
    print(f"[{tag}] launches splat_dense {full_features['dense_launches']}; "
          f"mapping split: backbone {ms['backbone_mean_ms']:.2f} ms "
          f"({ms['backbone_calls']} calls), feature update "
          f"{ms['feature_update_mean_ms']:.2f} ms ({ms['feature_updates']}, "
          f"backbone included), semantic update "
          f"{ms['semantic_update_mean_ms']:.2f} ms a step (host clock, card "
          f"synced)")
    small = report["fleet_small_features"] = phase_small_feature_fleet(
        small_features)
    print(f"[fleet features] fm protocol tasks {small['tasks']}, B=2: cuda "
          f"{small['cuda_s']:.1f} s, cpu {small['cpu_s']:.1f} s, "
          f"{small['actions']} actions; cuda == cpu == the sequential agent "
          f"per episode; launches splat_onehot {small['launches']}, "
          f"splat_dense {small['dense_launches']} for "
          f"{small['group_splats']} group splats, {small['map_updates']} "
          f"episode map updates")
    fleet = report["full_fleet_features"] = phase_full_fleet(
        2, False, full_features, features=True)
    tag = "fleet features 384x384x96"
    print(f"[{tag}] {' '.join(fleet['argv'])}")
    print(f"[{tag}] 2 episodes in {fleet['wall_s']:.1f} s: "
          f"{fleet['episode_s']:.2f} s per episode against "
          f"{fleet['sequential_episode_s']:.1f} s for the sequential "
          f"episode; peak memory {fleet['peak_memory_bytes'] / 2**30:.2f} "
          f"GiB; task 2 equals the sequential episode: "
          f"{fleet['task2_equals_sequential']}; prop_fixed "
          f"{fleet['prop_fixed']}; launches splat_onehot {fleet['launches']}"
          f", splat_dense {fleet['dense_launches']} for "
          f"{fleet['group_splats']} group splats and {fleet['map_updates']} "
          f"episode map updates")
    print(f"[{tag}] fleet_timing {json.dumps(fleet['fleet_timing'])}")

    nms = report["nms"] = phase_nms(dev)
    print_nms(nms)
    det = report["detector"] = phase_detector(dev)
    for batch in (1, 2):
        d = det[f"b{batch}"]
        st = d["stages_ms"]
        print(f"[detector] 224x224, 54 classes, B={batch}: cuda vs cpu "
              f"{d['margin']['live_slots']} live slots, slot flips "
              f"{d['margin']['slot_flips']}, mask-pixel flips "
              f"{d['margin']['pixel_flips']} (largest margin "
              f"{max(d['margin']['slot_flip_margin'], d['margin']['pixel_flip_margin']):.3g},"
              f" tol {det['tolerance']}), max score diff "
              f"{d['margin']['max_score_diff']:.3g}; fused non-zero pixels "
              f"{d['fused_pixels']} at {det['threshold']}")
        print(f"[detector] B={batch}: {d['ms_per_frame']:.2f} ms a frame "
              f"(network {st['network']:.2f}, proposals {st['proposals']:.2f},"
              f" heads {st['heads']:.2f}, paste {st['paste']:.2f}, fuse "
              f"{st['fuse']:.2f} ms for the batch; CUDA events, median of "
              f"10); {d['flops_total'] / 1e9:.1f} GFLOP, bound "
              f"{d['flops_bound_ms']:.2f} ms at 67 TFLOP/s fp32")
    print(f"[detector] load and first call {det['load_and_first_call_ms']:.0f}"
          f" ms")
    small = report["small_learned"] = phase_small_learned()
    print(f"[learned 80x80x24] cuda {small['cuda_s']:.1f} s, cpu "
          f"{small['cpu_s']:.1f} s, {small['actions']} actions, results "
          f"equal; launches splat_onehot {small['launches']} for "
          f"{small['map_updates']} map updates, nms {small['nms_launches']} "
          f"for {small['sensor_calls']} sensor calls; fused non-zero pixels "
          f"{small['fused_pixels_min']}-{small['fused_pixels_max']} a frame "
          f"(mean {small['fused_pixels_mean']:.0f}) at {SMALL_THRESHOLD}")
    learned = report["full_learned"] = phase_full_episode(learned=True)
    tag = "learned 384x384x96x54"
    print_episode(tag, learned)
    print(f"[{tag}] sensor {learned['sensor_mean_ms']:.2f} ms a step (median "
          f"{learned['sensor_median_ms']:.2f}; host clock, card synced; "
          f"{learned['sensor_calls']} calls), nms launches "
          f"{learned['nms_launches']}; fused non-zero pixels "
          f"{learned['fused_pixels_min']}-{learned['fused_pixels_max']} a "
          f"frame (mean {learned['fused_pixels_mean']:.0f}, "
          f"{learned['frames_with_fused']} of {learned['frames']} frames) at "
          f"{LEARNED_THRESHOLD}")
    fleet = report["full_fleet_learned"] = phase_full_fleet(
        2, False, learned, learned=True)
    tag = "fleet learned 384x384x96x54"
    print(f"[{tag}] {' '.join(fleet['argv'])}")
    print(f"[{tag}] 2 episodes in {fleet['wall_s']:.1f} s: "
          f"{fleet['episode_s']:.2f} s per episode against "
          f"{fleet['sequential_episode_s']:.1f} s for the sequential "
          f"episode; peak memory {fleet['peak_memory_bytes'] / 2**30:.2f} "
          f"GiB; task 2 equals the sequential episode: "
          f"{fleet['task2_equals_sequential']}; launches splat_onehot "
          f"{fleet['launches']} for {fleet['group_splats']} group splats, "
          f"nms {fleet['nms_launches']} for {fleet['sensor_calls']} sensor "
          f"calls of 2 frames ({fleet['sensor_mean_ms']:.2f} ms each)")
    print(f"[{tag}] fleet_timing {json.dumps(fleet['fleet_timing'])}")

    training_start = time.perf_counter()
    data = report["search_data"] = phase_search_data()
    tag = "search data 80x80x24"
    print(f"[{tag}] tasks 0-{data['tasks'] - 1} on cuda: "
          f"{data['snapshots']} snapshots, {data['labels']} labels; wall s "
          f"per task {' '.join(f'{s:.2f}' for s in data['wall_s_per_task'])}"
          f"; task 0 on cpu {data['cpu_task0_s']:.1f} s: cells and counts "
          f"equal, snapshots within one float16 ulp (largest difference "
          f"{data['max_abs_diff_cpu']:.3g})")
    print(f"[{tag}] launches: splat_onehot {data['launches']} (unshuffle, "
          f"semantic1), splat_onehot_multi {data['multi_launches']} "
          f"(walkthrough, occupancy + semantic0) for {data['group_splats']} "
          f"group splats and {data['map_updates']} map updates")
    full_data = report["search_data_full"] = phase_search_data_full()
    tag = "search data 384x384x96x54"
    print(f"[{tag}] one task, camera 224, budgets 5 + 5: wall "
          f"{full_data['wall_s']:.1f} s, {full_data['snapshots']} snapshots, "
          f"{full_data['labels']} labels; map update "
          f"{full_data['update_ms_mean']:.2f} ms mean, "
          f"{full_data['update_ms_median']:.2f} median (host clock, card "
          f"synced; {full_data['map_updates']} updates); launches "
          f"splat_onehot {full_data['launches']}, splat_onehot_multi "
          f"{full_data['multi_launches']}; peak memory "
          f"{full_data['peak_memory_bytes'] / 2**30:.2f} GiB")
    trained = report["search_train"] = phase_search_train()
    for variant, t in trained.items():
        ep = t["episode"]
        print(f"[search train] {variant} ({t['channels']} channels), "
              f"{t['steps']} steps: {t['ms_per_step']:.2f} ms a step (fit "
              f"wall {t['wall_s']:.1f} s, validation included); best val "
              f"NLL {t['best_val_nll']:.3f} against uniform "
              f"{t['uniform_nll']:.3f}, argmax distance "
              f"{t['val_argmax_dist']:.1f} cells; loss {t['first_loss']:.3f}"
              f" -> {t['last_loss']:.3f}; first {TRAIN_CHECK_STEPS} losses "
              f"card vs cpu {t['card_cpu_loss_rel_diff']:.3g} (rtol "
              f"{TRAIN_LOSS_RTOL}); two card fits bit-equal: "
              f"{t['runs_bit_equal']}")
        print(f"[search train] {variant}: {t['best_line']}")
        print(f"[search train] {variant} .pth through the CLI on cuda: "
              f"{ep['policy_goals']} policy goals, wall {ep['wall_s']:.1f} s, "
              f"prop_fixed {ep['prop_fixed']}; launches splat_onehot "
              f"{ep['launches']} for {ep['group_splats']} group splats")
    full_train = report["search_train_full"] = phase_search_train_full(dev)
    for channels, t in full_train.items():
        print(f"[search train 384x384] {channels} channels, batch "
              f"{t['batch']}: {t['ms']:.2f} ms a step (median of 20 after "
              f"warm-up, CUDA events); bound {t['bound_ms']:.2f} ms by "
              f"{t['bound_by']}: {t['flops'] / 1e12:.3f} TFLOP at "
              f"{FP32_FLOPS / 1e12:.0f} TFLOP/s fp32 "
              f"({t['ms'] / t['bound_ms']:.1f}x the bound); peak memory "
              f"{t['peak_memory_bytes'] / 2**30:.2f} GiB")
    seg = report["segmenter_train"] = phase_segmenter_train(dev)
    hist = seg["history"]
    print(f"[segmenter train] camera 224, {seg['train_images']} training + "
          f"{seg['val_images']} validation images (generate and format "
          f"{seg['dataset_s']:.1f} s); 2 epochs at batch 8, {seg['steps']} "
          f"steps in {seg['train_s']:.1f} s: loss "
          f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}, pixel accuracy "
          f"{seg['before']['pixel_accuracy']:.3f} untrained -> "
          f"{hist[-1]['pixel_accuracy']:.3f}, mIoU "
          f"{seg['before']['miou']:.3f} -> {hist[-1]['miou']:.3f}")
    print(f"[segmenter train] {seg['ms']:.2f} ms a step (median, CUDA "
          f"events); bound {seg['bound_ms']:.2f} ms by {seg['bound_by']}: "
          f"{seg['flops'] / 1e12:.3f} TFLOP at {FP32_FLOPS / 1e12:.0f} "
          f"TFLOP/s fp32; segmenter.pth through --detector-arch unet on "
          f"cuda: wall {seg['episode']['wall_s']:.1f} s, launches "
          f"splat_onehot {seg['episode']['launches']} for "
          f"{seg['episode']['group_splats']} group splats")
    mt = report["maskrcnn_train"] = phase_maskrcnn_train(dev)
    tag = "maskrcnn train"
    c = mt["check"]
    print(f"[{tag}] R50-FPN 224x224, {MASKRCNN_CLASSES} classes, default "
          f"TrainConfig, batch 2, {c['parameters']} parameter tensors: card "
          f"against float64 on the CPU: losses rtol "
          f"{max(c['loss_rel_diff'].values()):.3g}, largest gradient error "
          f"{c['grad_err']:.3g} of the largest gradient ({c['grad_err_leaf']})"
          f" (tol {MASKRCNN_TOL}); targets by the margin rule: "
          f"{json.dumps(c['margin'])}; {c['rpn_positives']:.0f} RPN "
          f"positives, {c['roi_foreground']:.0f} foreground ROIs "
          f"({mt['check_s']:.1f} s)")
    for batch_size in (2, 8):
        t = mt[f"b{batch_size}"]
        print(f"[{tag}] batch {batch_size}: {t['ms']:.2f} ms a step (median "
              f"of {MASKRCNN_FALL_STEPS - 1} after the first, "
              f"{t['first_ms']:.1f} ms; CUDA events); bound "
              f"{t['bound_ms']:.2f} ms by {t['bound_by']}: "
              f"{t['flops'] / 1e12:.3f} TFLOP (3x the forward at 128 ROIs "
              f"and 32 mask ROIs a frame) at {FP32_FLOPS / 1e12:.0f} TFLOP/s "
              f"fp32 ({t['ms'] / t['bound_ms']:.1f}x the bound); peak memory "
              f"{t['peak_memory_bytes'] / 2**30:.2f} GiB; total loss "
              f"{t['totals'][0]:.3f} -> {t['totals'][-1]:.3f} on a fixed batch")
    print(f"[{tag}] python -m mass_tpu_torch.perception.maskrcnn_train on "
          f"{MASKRCNN_RUN_IMAGES} images, twice: {mt['run_steps']} steps and "
          f"{mt['val_frames']} scored frames in "
          f"{' and '.join(f'{w:.1f}' for w in mt['run_wall_s'])} s; the two "
          f"maskrcnn.pth equal byte for byte: {mt['runs_bit_equal']}; nms "
          f"launches {mt['nms_launches']}; {json.dumps(mt['run_history'])}")
    for name, e in mt["eval"].items():
        print(f"[{tag}] --eval-only{' --tta' if name == 'tta' else ''}: mIoU "
              f"{e['miou']:.4f}, pixel accuracy {e['pixel_accuracy']:.4f} "
              f"({e['wall_s']:.1f} s)")
    ep = mt["episode"]
    print(f"[{tag}] maskrcnn.pth through --detector-checkpoint on cuda "
          f"(80x80x24, camera 48, threshold 0.9): wall {ep['wall_s']:.1f} s, "
          f"{ep['sensor_calls']} sensor calls, nms {ep['nms_launches']}, "
          f"fused non-zero pixels {ep['fused_pixels_min']}-"
          f"{ep['fused_pixels_max']} a frame, splat_onehot {ep['launches']}")
    print(f"[{tag}] the phase took {mt['wall_s']:.1f} s")
    report["training_s"] = time.perf_counter() - training_start
    print(f"[training] the six training phases took "
          f"{report['training_s']:.1f} s")

    shard_start = time.perf_counter()
    shard = report["shard_kernels"] = phase_shard_kernels(dev)
    tag = "shard kernels"
    print(f"[{tag}] slabs on {json.dumps(shard['devices'])} (this machine "
          f"has {torch.cuda.device_count()} card(s))")
    for n in (2, 4):
        k = shard[f"slabs{n}"]
        print(f"[{tag}] the room frame into 384x384x96x54 in {n} slabs: "
              f"{k['launches']} launches, equal to the unsharded map bit for "
              f"bit: {k['bitwise_equal_unsharded']}; the slab launches "
              f"{k['ms']:.4f} ms together against {shard['unsharded_ms']:.4f}"
              f" ms unsharded (CUDA events, cold L2, median of 20; bound "
              f"{shard['bound_ms']:.4f} ms by {shard['bound_by']}); the whole "
              f"update (sort, gathers, re-base, launches) {k['update_ms']:.4f}"
              f" ms against {shard['unsharded_update_ms']:.4f} ms")
    k = shard["dense_slabs2"]
    print(f"[{tag}] dense 384x384x96x256 in 2 slabs: {k['launches']} "
          f"launches, equal to the unsharded map bit for bit: "
          f"{k['bitwise_equal_unsharded']}")
    small_shard = report["shard_small_episode"] = phase_shard_small_episode(
        report["small_episodes"])
    print(f"[shard episode] 80x80x24 in {small_shard['slabs']} slabs on "
          f"{small_shard['devices']}: cuda {small_shard['cuda_s']:.1f} s, cpu "
          f"{small_shard['cpu_s']:.1f} s, {small_shard['actions']} actions; "
          f"cuda == cpu == the unsharded episode; launches splat_onehot "
          f"{small_shard['launches']} for {small_shard['map_updates']} map "
          f"updates")
    full_shard = report["shard_full_episode"] = phase_shard_full_episode(full)
    tag = "shard episode 384x384x96x54"
    print(f"[{tag}] {full_shard['slabs']} slabs through "
          f"{full_shard['route']}: wall {full_shard['wall_s']:.1f} s against "
          f"{full_shard['unsharded_wall_s']:.1f} s unsharded; outcome equal "
          f"to [episode 384x384x96x54]: {full_shard['outcome_equal']}; "
          f"launches splat_onehot {full_shard['launches']} for "
          f"{full_shard['map_updates']} map updates; peak memory "
          f"{full_shard['peak_memory_bytes'] / 2**30:.2f} GiB against "
          f"{full_shard['unsharded_peak_memory_bytes'] / 2**30:.2f} GiB")
    print(f"[{tag}] timing {json.dumps(full_shard['timing'])}")
    shard_fleet = report["shard_fleet"] = phase_shard_fleet()
    print(f"[shard fleet] B=3 80x80x24 (tasks {shard_fleet['tasks']}) in "
          f"{shard_fleet['slabs']} slabs: {shard_fleet['wall_s']:.1f} s, "
          f"equal to the unsharded fleet; launches splat_onehot "
          f"{shard_fleet['launches']}, splat_onehot_multi "
          f"{shard_fleet['multi_launches']} for {shard_fleet['group_splats']}"
          f" group splats")
    dp = report["data_parallel"] = phase_data_parallel(dev)
    f, u, m = dp["fit"], dp["unet"], dp["maskrcnn"]
    print(f"[data parallel] 2 replicas on {dp['devices']}: policy fit "
          f"{f['steps']} steps, losses {f['loss_rel_diff']:.3g} from one "
          f"device (rtol {TRAIN_LOSS_RTOL}), val NLL {f['nll']:.5f} against "
          f"{f['one_device_nll']:.5f}, {f['ms']:.2f} ms a step against "
          f"{f['one_device_ms']:.2f} (host clock to the loss's copy, "
          f"median after the first); "
          f"two runs bit-equal: {f['runs_bit_equal']}")
    print(f"[data parallel] UNet batch 2 at 224: loss {u['loss']:.6f} "
          f"against {u['one_device_loss']:.6f}, gradients "
          f"{u['grad_err']:.3g} of the largest (tol {SHARD_TOL_UNET}); "
          f"{u['ms']:.2f} ms a step against {u['one_device_ms']:.2f} (CUDA "
          f"events); two runs bit-equal: {u['runs_bit_equal']}")
    print(f"[data parallel] Mask R-CNN batch 2 at 224: losses "
          f"{m['loss_rel_diff']:.3g} from one device, gradients "
          f"{m['grad_err']:.3g} of the largest (tol {MASKRCNN_TOL}); "
          f"{m['ms']:.2f} ms a step against {m['one_device_ms']:.2f}; nms "
          f"launches {m['nms_launches']} a step; two runs bit-equal: "
          f"{m['runs_bit_equal']}")
    report["shard_s"] = time.perf_counter() - shard_start
    print(f"[shard] the five phases of more than one device took "
          f"{report['shard_s']:.1f} s")

    tooling_single, tooling_multi = tooling_phases(report, full)

    kernels = [
        kernel_line("splat_onehot", "mass_tpu/ops/pallas_splat.py:756",
                    full["launches"] + tooling_single
                    + full_shard["launches"] + small_shard["launches"]
                    + shard_fleet["launches"], kernel),
        kernel_line("splat_onehot_multi", "mass_tpu/ops/pallas_splat.py:671",
                    compat["multi_launches"] + tooling_multi
                    + shard_fleet["multi_launches"], multi),
        kernel_line("splat_onehot_frames",
                    "mass_tpu/ops/pallas_splat.py:445", frames["launches"],
                    frames),
        # not a TPU kernel: the counterpart of XLA's scatter
        kernel_line("splat_dense", "mass_tpu/ops/scatter.py:279",
                    full_features["dense_launches"], dense),
        # not a TPU kernel: the counterpart of the fori_loop of nms
        kernel_line("nms", "mass_tpu/ops/detection.py:31",
                    learned["nms_launches"] + mt["nms_launches"]
                    + dp["maskrcnn"]["nms_launches"],
                    dict(nms["rpn_b1"], max_abs_err=nms["max_abs_err"]))]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - start
    os.makedirs(os.path.join("build", "chip_smoke"), exist_ok=True)
    with open(os.path.join("build", "chip_smoke", "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[total] {report['total_s']:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
