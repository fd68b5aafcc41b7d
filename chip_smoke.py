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
``--fleet-size 8`` (default) and ``--fleet-size 2`` (compat) at full
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
fleet whose task 2 must equal it.

Exits non-zero when there is no CUDA card, when a kernel fails to build,
launch or agree, or when any phase fails.  The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details also go to ``build/chip_smoke/report.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
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
                  rng_seed=None, head=None):
    """One episode of task ``seed`` at :func:`small_config`'s settings
    (with ``head``'s goal head and policy).  Returns (results, actions)."""
    from mass_tpu_torch.agent.loop import RearrangementAgent

    cfg = small_config(compat, head)
    policy = head_policy(head, device)
    actions = []
    if rng_seed is None:
        rng_seed = 1 if compat else 0
    agent = RearrangementAgent(
        cfg, small_sampler(cfg, seed, actions),
        rng=np.random.RandomState(rng_seed), device=device, policy=policy)
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


def small_fleet(device: str, compat: bool, tasks, rng_seeds, head=None):
    """A fleet of the small episodes of ``tasks`` (with ``head``'s goal
    head); (results, actions per episode)."""
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    cfg = small_config(compat, head)
    policy = head_policy(head, device)
    actions = [[] for _ in tasks]
    evaluator = FleetEvaluator(
        cfg, [small_sampler(cfg, s, a) for s, a in zip(tasks, actions)],
        seeds=list(rng_seeds), device=device, policy=policy)
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

    def check(self, nms_launches: int, batch: int) -> dict:
        """Two NMS launches a sensor call (the RPN levels of its frames,
        the class-aware NMS); detections fused into some frames."""
        calls = len(self.times)
        check(calls > 0 and nms_launches == 2 * calls,
              f"{nms_launches} NMS launches for {calls} sensor calls")
        check(self.frames == batch * calls, "sensor frames miscounted")
        check(max(self.fused) > 0, "no detection survived the threshold")
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
    for size, flag, sequential in ((FLEET, False, full), (2, True, compat)):
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

    kernels = [
        kernel_line("splat_onehot", "mass_tpu/ops/pallas_splat.py:756",
                    full["launches"], kernel),
        kernel_line("splat_onehot_multi", "mass_tpu/ops/pallas_splat.py:671",
                    compat["multi_launches"], multi),
        kernel_line("splat_onehot_frames",
                    "mass_tpu/ops/pallas_splat.py:445", frames["launches"],
                    frames),
        # not a TPU kernel: the counterpart of XLA's scatter
        kernel_line("splat_dense", "mass_tpu/ops/scatter.py:279",
                    full_features["dense_launches"], dense),
        # not a TPU kernel: the counterpart of the fori_loop of nms
        kernel_line("nms", "mass_tpu/ops/detection.py:31",
                    learned["nms_launches"],
                    dict(nms["rpn_b1"], max_abs_err=nms["max_abs_err"]))]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - start
    os.makedirs(os.path.join("build", "chip_smoke"), exist_ok=True)
    with open(os.path.join("build", "chip_smoke", "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[total] {report['total_s']:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
