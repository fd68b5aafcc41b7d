"""Smoke run of mass_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds every kernel of the port's main path from the sources in this
checkout, holds each against its plain PyTorch version at the shapes
the main path gives it, runs a two-phase rearrangement episode on the
card at a small geometry (and the same episode on the CPU, which must
give equal results), then a full-width episode (384x384x96 voxels x 54
classes, 224x224 camera) through ``python -m mass_tpu_torch.agent.cli``'s
entry point, with the kernels' launch counts read around it.

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


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed with
    CUDA events after writing ``flush`` (larger than L2) so every call
    starts with a cold cache, as it does between frames.  A device-side
    sleep after the flush keeps the card busy while the host enqueues
    ``fn``, so the events bracket the device's work rather than the
    host's launch latency (a ``fn`` that synchronises inside, as the
    plain version does, still includes its host time)."""
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def room_frame(camera: int, rng: np.random.RandomState):
    """Depth of a 6 m x 6 m walled room with a floor 1.5 m below the
    camera, seen from its centre looking down 30 degrees, plus random
    class ids (the splat treats every pixel alike)."""
    from mass_tpu_torch.core import geometry as G

    f = camera / 2.0      # 90 degree field of view
    yaw, elevation = 0.3, -np.pi / 6
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


def phase_kernel_full_geometry(dev) -> dict:
    """The splat kernel against its plain version at full geometry."""
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core.voxelmap import VoxelMap
    from mass_tpu_torch.ops import splat as SP

    geo = MapGeometry(map_height=384, map_width=384, map_depth=96,
                      feature_size=54, grid_resolution=0.05)
    rng = np.random.RandomState(0)
    yaw, elevation, depth, classes = room_frame(224, rng)
    vm = VoxelMap.create(geo, (0.0, 0.0, 0.0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    vm.data.copy_(torch.rand(vm.data.shape, generator=gen, device=dev))
    from mass_tpu_torch.core import geometry as G
    rays = G.camera_rays(224, 224, 112.0, 112.0, device=dev)
    ids, weights = vm.contributions(
        rays, torch.zeros(3, device=dev), yaw, elevation,
        torch.as_tensor(depth, device=dev))
    classes = torch.as_tensor(classes, device=dev)
    runs = SP.sorted_runs(ids, weights, classes)
    num_voxels = geo.num_voxels
    valid_runs = int((runs.ids < num_voxels).sum())
    valid_records = int((ids < num_voxels).sum())
    check(valid_runs > 1000, f"synthetic frame touched {valid_runs} voxels")

    out1 = SP.apply_runs(vm.data.clone(), runs, 0.5)
    out2 = SP.apply_runs(vm.data.clone(), runs, 0.5)
    ref = SP.splat_onehot_reference(vm.data.clone(), runs, 0.5)
    torch.cuda.synchronize()
    max_err = float((out1 - ref).abs().max())
    identical = bool(torch.equal(out1, out2))
    changed = float((out1 - vm.data).abs().max())
    cpu = SP.splat_onehot_reference(
        vm.data.cpu(), SP.Runs(*(t.cpu() for t in runs)), 0.5)
    cpu_equal = bool(torch.equal(out1.cpu(), cpu))
    del out2, ref, cpu
    check(changed > 0, "the kernel changed nothing")
    check(max_err <= SPLAT_TOL,
          f"kernel vs plain max abs diff {max_err} > {SPLAT_TOL}")
    check(identical, "two kernel runs differ")
    check(cpu_equal, "kernel differs bitwise from the plain CPU version")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    scratch = out1
    for _ in range(3):
        SP.apply_runs(scratch, runs, 0.5)
        SP.splat_onehot_reference(scratch, runs, 0.5)
    kernel_ms = cuda_ms(lambda: SP.apply_runs(scratch, runs, 0.5), 20,
                        flush)
    plain_ms = cuda_ms(lambda: SP.splat_onehot_reference(scratch, runs, 0.5),
                       20, flush)
    # the record prep of the same map update (sort, runs; syncs the host)
    prep_ms = cuda_ms(lambda: SP.sorted_runs(ids, weights, classes), 20,
                      flush)
    # what the kernel must read and write: weight and class of each valid
    # record (4 B + 4 B), id and start of each run (int64, plus the last
    # start), and each touched row read and written once
    row_bytes = 4 * geo.feature_size
    n_runs = int(runs.ids.shape[0])
    bytes_moved = (8 * valid_records + 8 * (2 * n_runs + 1)
                   + 2 * row_bytes * valid_runs)
    # per record: w*w and three adds; per row element: 2 mul + 1 add
    flops = 4 * valid_records + 3 * geo.feature_size * valid_runs
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    del scratch, flush, vm
    torch.cuda.empty_cache()
    return dict(records=int(ids.shape[0]), valid_records=valid_records,
                touched_voxels=valid_runs, runs=n_runs, max_abs_err=max_err,
                tolerance=SPLAT_TOL, bit_identical_runs=identical,
                bitwise_equal_cpu_plain=cpu_equal, ms=kernel_ms,
                plain_ms=plain_ms, prep_ms=prep_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S
                >= flops / FP32_FLOPS else "operations",
                bytes=bytes_moved, flops=flops, library_ms=None)


def small_episode(device: str):
    """One two-phase episode at the JAX test suite's episode geometry
    (80x80x24 at 0.125 m, camera 48); returns (results, actions)."""
    from mass_tpu_torch.agent.loop import RearrangementAgent
    from mass_tpu_torch.config import AgentConfig, CameraConfig, NavConfig
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    cam = CameraConfig(height=48, width=48)
    cfg = AgentConfig(
        camera=cam, map_height=80, map_width=80, map_depth=24,
        grid_resolution=0.125,
        nav=NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                      map_slice_stop=12, max_goal_steps=80),
        ground_truth_segmentation=True, ground_truth_disagreement=True,
        exploration_budget_one=2, exploration_budget_two=2,
        start_task=0, total_tasks=1)
    sampler = GridWorldTaskSampler([2], camera=cam, num_objects=2,
                                   num_misplaced=1, num_opened=0)
    actions = []
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
    agent = RearrangementAgent(cfg, sampler, rng=np.random.RandomState(0),
                               device=device)
    return agent.run_task(0), actions


def phase_small_episodes() -> dict:
    from mass_tpu_torch.ops import splat as SP

    SP.LAUNCHES = 0
    t0 = time.perf_counter()
    gpu, gpu_actions = small_episode("cuda")
    gpu_s = time.perf_counter() - t0
    launches = SP.LAUNCHES
    t0 = time.perf_counter()
    cpu, cpu_actions = small_episode("cpu")
    cpu_s = time.perf_counter() - t0
    diff = {k: (gpu[k], cpu.get(k)) for k in gpu
            if k != "timing" and gpu[k] != cpu.get(k)}
    updates = gpu["timing"]["mapping"]["count"]
    check(not diff, f"cuda and cpu episodes differ: {diff}")
    check(gpu_actions == cpu_actions, "cuda and cpu action sequences differ")
    check(launches == updates > 0,
          f"{launches} kernel launches for {updates} map updates")
    return dict(results_equal=True, actions=len(gpu_actions),
                launches=launches, map_updates=updates, cuda_s=gpu_s,
                cpu_s=cpu_s, metrics={k: v for k, v in gpu.items()
                                      if k != "timing"})


def phase_full_episode() -> dict:
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat as SP

    logdir = os.path.join("build", "chip_smoke", "episode")
    torch.cuda.reset_peak_memory_stats()
    SP.LAUNCHES = 0                       # main path starts here
    t0 = time.perf_counter()
    metrics = cli.main(FULL_ARGS + FULL_BUDGETS + ["--logdir", logdir])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = SP.LAUNCHES                # main path ends here
    check(len(metrics) == 1, "the CLI ran no episode")
    with open(os.path.join(logdir, "results", "2.json")) as f:
        results = json.load(f)
    updates = results["timing"]["mapping"]["count"]
    check(launches == updates > 0,
          f"{launches} kernel launches for {updates} map updates")
    check(results["walkthrough/observed_cells"] > 0
          and results["unshuffle/observed_cells"] > 0,
          "the full-width maps stayed empty")
    check(0.0 <= results["unshuffle/prop_fixed"] <= 1.0,
          "prop_fixed out of range")
    return dict(budgets=FULL_BUDGETS, wall_s=wall_s, launches=launches,
                map_updates=updates,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                timing=results["timing"],
                metrics={k: v for k, v in results.items()
                         if k != "timing"})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mass_tpu_torch.ops import splat as SP

    dev = torch.device("cuda")
    report = {}

    build_s = SP.build()
    report["build_s"] = {"splat_onehot": build_s}
    print(f"[build] splat_onehot.cu: {build_s:.2f} s")

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["card"] = {"name": name, "nvidia_smi": smi}
    print(f"[card] {name}")
    print(smi)

    kernel = phase_kernel_full_geometry(dev)
    report["splat_full_geometry"] = kernel
    print(f"[splat] full geometry: touched voxels U={kernel['touched_voxels']}"
          f", records={kernel['valid_records']} valid of "
          f"{kernel['records']}; max abs diff vs plain "
          f"{kernel['max_abs_err']:.3g} (tol {SPLAT_TOL}); two runs "
          f"bit-identical: {kernel['bit_identical_runs']}; equal to the "
          f"plain CPU version: {kernel['bitwise_equal_cpu_plain']}")
    print(f"[splat] kernel {kernel['ms']:.4f} ms, plain "
          f"{kernel['plain_ms']:.4f} ms, bound {kernel['bound_ms']:.4f} ms "
          f"({kernel['bytes']} B: 8 B/valid record + 16 B/run + "
          f"2 x 216 B/touched voxel, at 3.35 TB/s); library call: none")
    print(f"[splat] record prep (sorted_runs: stable sort + runs) "
          f"{kernel['prep_ms']:.4f} ms for the same frame")

    small = phase_small_episodes()
    report["small_episodes"] = small
    print(f"[episode 80x80x24] cuda {small['cuda_s']:.1f} s, cpu "
          f"{small['cpu_s']:.1f} s, {small['actions']} actions, results "
          f"equal; {small['launches']} launches for "
          f"{small['map_updates']} map updates")

    full = phase_full_episode()
    report["full_episode"] = full
    print(f"[episode 384x384x96x54, camera 224] budgets "
          f"{' '.join(FULL_BUDGETS)}")
    print(f"[episode] wall {full['wall_s']:.1f} s, peak memory "
          f"{full['peak_memory_bytes'] / 2**30:.2f} GiB, splat launches "
          f"{full['launches']} for {full['map_updates']} map updates")
    print(f"[episode] timing {json.dumps(full['timing'])}")
    print(f"[episode] metrics {json.dumps(full['metrics'])}")

    kernels = [dict(
        name="splat_onehot", route="cuda",
        source="mass_tpu_torch/csrc/splat_onehot.cu",
        replaces="mass_tpu/ops/pallas_splat.py:756",
        launches=full["launches"], max_abs_err=kernel["max_abs_err"],
        ms=kernel["ms"], plain_ms=kernel["plain_ms"],
        bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"],
        library_ms=kernel["library_ms"])]
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
