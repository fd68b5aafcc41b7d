"""Smoke run of mass_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's three splat kernels from the sources in this
checkout (one library: the single-map, multi-map and frames kernels
share ``csrc/splat_onehot.cu``), holds each against its plain PyTorch
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

Exits non-zero when there is no CUDA card, when a kernel fails to build,
launch or agree, or when any phase fails.  The line before the last is
``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details also go to ``build/chip_smoke/report.json``.
"""

from __future__ import annotations

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


def kernel_device_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of the splat kernel per call of ``fn``, read from
    torch.profiler's trace (no launch latency in it), cold L2."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if "splat_onehot_kernel" in e.key)
    return total / 1e3 / iters


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
        device_ms=kernel_device_ms(
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


def small_config(compat: bool):
    """The JAX test suite's episode geometry (80x80x24 at 0.125 m, camera
    48); with ``compat`` the settings of tests/test_reference_compat.py's
    compat episode."""
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
    return cfg


def small_sampler(cfg, seed: int, actions: list):
    """A sampler of the one task ``seed`` that appends every action its
    tasks take to ``actions``."""
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    sampler = GridWorldTaskSampler([seed], camera=cfg.camera, max_steps=250,
                                   num_objects=2, num_misplaced=1,
                                   num_opened=0)
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
                  rng_seed=None):
    """One two-phase episode of task ``seed`` at :func:`small_config`'s
    settings.  Returns (results, actions)."""
    from mass_tpu_torch.agent.loop import RearrangementAgent

    cfg = small_config(compat)
    actions = []
    if rng_seed is None:
        rng_seed = 1 if compat else 0
    agent = RearrangementAgent(
        cfg, small_sampler(cfg, seed, actions),
        rng=np.random.RandomState(rng_seed), device=device)
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


def phase_full_episode(compat: bool = False) -> dict:
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join("build", "chip_smoke",
                          "episode_compat" if compat else "episode")
    flags = ["--reference-compat"] if compat else []
    torch.cuda.reset_peak_memory_stats()
    SP.LAUNCHES = SP.MULTI_LAUNCHES = 0   # main path starts here
    t0 = time.perf_counter()
    metrics = cli.main(FULL_ARGS + FULL_BUDGETS + flags
                       + ["--logdir", logdir])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES   # main path ends here
    check(len(metrics) == 1, "the CLI ran no episode")
    with open(os.path.join(logdir, "results", "2.json")) as f:
        results = json.load(f)
    updates = results["timing"]["mapping"]["count"]
    check_launches(single, multi, updates, compat)
    check(results["walkthrough/observed_cells"] > 0
          and results["unshuffle/observed_cells"] > 0,
          "the full-width maps stayed empty")
    check(0.0 <= results["unshuffle/prop_fixed"] <= 1.0,
          "prop_fixed out of range")
    return dict(budgets=FULL_BUDGETS + flags, wall_s=wall_s,
                launches=single, multi_launches=multi, map_updates=updates,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                timing=results["timing"],
                metrics={k: v for k, v in results.items()
                         if k != "timing"})


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
    """Counts the fleet's group splats by their number of families (a
    wrapper of ``parallel.fleet.apply_onehot_group``, which launches the
    kernels and counts the launches itself) and each fleet's frames folded
    per episode."""

    def __enter__(self):
        from mass_tpu_torch.parallel import evaluator as EV
        from mass_tpu_torch.parallel import fleet as TF

        self.splats, self.map_updates = [], []
        self._apply, self._run = TF.apply_onehot_group, EV.FleetEvaluator.run

        def apply(vms, *args):
            self.splats.append(len(vms))
            return self._apply(vms, *args)

        def run(evaluator):
            results = self._run(evaluator)
            self.map_updates.append([ep.map_updates
                                     for ep in evaluator.episodes])
            return results
        TF.apply_onehot_group, EV.FleetEvaluator.run = apply, run
        return self

    def __exit__(self, *exc):
        from mass_tpu_torch.parallel import evaluator as EV
        from mass_tpu_torch.parallel import fleet as TF

        TF.apply_onehot_group, EV.FleetEvaluator.run = self._apply, self._run

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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernel_ms = kernel_device_ms(lambda: fleet.update_batch(**fr), 5, flush)
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
                step_kernel_device_ms=kernel_ms,
                sequential_update_group_ms=sequential_ms)


def small_fleet(device: str, compat: bool, tasks, rng_seeds):
    """A fleet of the small episodes of ``tasks``; (results, actions per
    episode)."""
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    cfg = small_config(compat)
    actions = [[] for _ in tasks]
    evaluator = FleetEvaluator(
        cfg, [small_sampler(cfg, s, a) for s, a in zip(tasks, actions)],
        seeds=list(rng_seeds), device=device)
    return evaluator.run(), actions


def phase_small_fleet(compat: bool, small: dict) -> dict:
    """B = 2 small episodes (tasks 2 and 3) through the fleet on the card
    and on the CPU, each equal to the sequential port agent: task 2 to
    the small-episode phase's run (the same rng seed), task 3 to a
    sequential run on the card."""
    from mass_tpu_torch.ops import splat as SP

    tasks = (2, 3)
    base = 1 if compat else 0                      # task 2's rng seed
    rng_seeds = [base + s - tasks[0] for s in tasks]
    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0        # fleet path starts here
        t0 = time.perf_counter()
        gpu, gpu_actions = small_fleet("cuda", compat, tasks, rng_seeds)
        gpu_s = time.perf_counter() - t0
        counts = counter.check(SP.LAUNCHES, SP.MULTI_LAUNCHES, compat)
    t0 = time.perf_counter()
    cpu, cpu_actions = small_fleet("cpu", compat, tasks, rng_seeds)
    cpu_s = time.perf_counter() - t0
    seq3, seq3_actions = small_episode("cuda", compat, seed=3,
                                       rng_seed=rng_seeds[1])
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


def phase_full_fleet(size: int, compat: bool, sequential: dict) -> dict:
    """``--fleet-size size --total-tasks size`` through the CLI at full
    width (tasks 2 onwards, the full-width flags and budgets), with
    ``--seed -2`` so task 2 draws the sequential full-width episode's rng
    seed 0: that episode's outcome must come back."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join("build", "chip_smoke", f"fleet{size}"
                          + ("_compat" if compat else ""))
    flags = ["--reference-compat"] if compat else []
    argv = (FULL_ARGS + FULL_BUDGETS + flags
            + ["--fleet-size", str(size), "--total-tasks", str(size),
               "--seed", "-2", "--logdir", logdir])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with SplatCounter() as counter:
        SP.LAUNCHES = SP.MULTI_LAUNCHES = 0        # fleet path starts here
        t0 = time.perf_counter()
        metrics = cli.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = counter.check(SP.LAUNCHES, SP.MULTI_LAUNCHES, compat)
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
          f"time {k['device_ms']:.4f} ms (profiler); bound "
          f"{k['bound_ms']:.4f} ms ({k['bytes']} B: id, weight, class and "
          f"frame per valid record, each touched row read and written "
          f"once, at 3.35 TB/s), {k['ms'] / k['bound_ms']:.2f}x the bound;"
          f" plain {k['plain_ms']:.3f} ms; library call: none")


def print_episode(tag: str, full: dict) -> None:
    print(f"[{tag}] budgets {' '.join(full['budgets'])}")
    print(f"[{tag}] wall {full['wall_s']:.1f} s, peak memory "
          f"{full['peak_memory_bytes'] / 2**30:.2f} GiB, launches: "
          f"splat_onehot {full['launches']}, splat_onehot_multi "
          f"{full['multi_launches']}, for {full['map_updates']} map updates")
    print(f"[{tag}] timing {json.dumps(full['timing'])}")
    print(f"[{tag}] metrics {json.dumps(full['metrics'])}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mass_tpu_torch.ops import splat as SP

    dev = torch.device("cuda")
    report = {}

    t0 = time.perf_counter()
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
          f"{maps['step_kernel_device_ms']:.3f} ms) against "
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

    kernels = [
        kernel_line("splat_onehot", "mass_tpu/ops/pallas_splat.py:756",
                    full["launches"], kernel),
        kernel_line("splat_onehot_multi", "mass_tpu/ops/pallas_splat.py:671",
                    compat["multi_launches"], multi),
        kernel_line("splat_onehot_frames",
                    "mass_tpu/ops/pallas_splat.py:445", frames["launches"],
                    frames)]
    report["kernels"] = kernels
    os.makedirs(os.path.join("build", "chip_smoke"), exist_ok=True)
    with open(os.path.join("build", "chip_smoke", "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
