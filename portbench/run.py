"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``mass_tpu_torch``) and
a CUDA card.  The run makes the cell's inputs and weights from the seed,
builds the port's fleet and folds set-up's frames, warms up every shape
of the cell with the stream's first ticks (that is set-up), then runs
ticks for ``--seconds``, reads the card's peak memory, with ``--trace 1``
runs on to the start of the next pass over the frames and traces a fixed
number of ticks from there, and checks everything the ticks
produced against the plain reference.  The last line of standard output
is one JSON object: ``correct``, ``attempted`` (agent steps in the
window), ``failed`` (compared outputs over their limit), ``metrics``
(``--trace 0``: the end-to-end metrics; ``--trace 1``: the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, ``counts`` (what
was compared, ticks, the check's seconds, host milliseconds a tick by
layer, tick percentiles) and last ``checks`` (each compared number
beside its limit, also the last lines of standard error).  No card, fewer cards than the cell asks for, or JAX or the JAX
package in the process: a nonzero exit and no result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check  # noqa: E402
from portbench.bench import Bench  # noqa: E402
from portbench.reference import maskrcnn as RM  # noqa: E402
from portbench.reference import resnet as RR  # noqa: E402
from portbench.reference import roofline  # noqa: E402
from portbench.reference import trace as RT  # noqa: E402
from portbench.reference import voxel as RV  # noqa: E402
from portbench.traffic import generator  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mass_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _mapping_bytes(config, traffic, inputs, schedule, ticks, device):
    """The least bytes of the traced ticks' map updates, by the
    reference's binning of their frames."""
    g = check.geometry(config)
    rays = RV.camera_rays(config["camera_size"], config["vertical_fov"],
                          device)
    bins = RV.grid_edges(inputs.origin, g, device)
    total = 0
    for t in ticks:
        f = schedule.frame(t)
        frames, ids, _, _ = RV.records(
            rays, bins, g, inputs.position[f], inputs.yaw[f],
            inputs.elevation[f], torch.from_numpy(inputs.depth[f]).to(device),
            torch.zeros(inputs.depth.shape[1:], dtype=torch.int32,
                        device=device))
        total += roofline.map_update_bytes(
            RV.touched_voxels(frames, ids, g.voxels), g.classes,
            traffic["batch"] * config["camera_size"] ** 2)
    return total


def _dense_bytes(config, traffic, inputs, schedule, ticks, device):
    """The least bytes of the traced ticks' dense updates, by the
    reference's binning of their feature cameras: each (family, episode)
    update that a tick makes, as one launch reads it."""
    g = check.geometry(config)
    rays = RV.camera_rays(
        config["camera_size"] // config["backbone"]["stride"],
        config["vertical_fov"], device)
    bins = RV.grid_edges(inputs.origin, g, device)
    total = 0
    for t in ticks:
        f = schedule.frame(t)
        for name, channels in config["dense_families"].items():
            rides = config["dense_rides_with"][name]
            for e in range(traffic["batch"]):
                if traffic["families"][e] != rides:
                    continue
                frames, ids, _, _ = check.dense_records(
                    config, g, rays, bins, inputs, [f], e, device)
                total += roofline.dense_update_bytes(
                    RV.touched_voxels(frames, ids, g.voxels), channels,
                    ids.numel(), ids.numel() // 8)
    return total


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, device, system_class=None, start=None,
             world_seed=None):
    """One run of a cell on ``device``: ``(result, checks)``.
    ``world_seed`` draws the houses and walks from it instead of the
    traffic's own (correctness runs over other worlds)."""
    start = time.perf_counter() if start is None else start
    if system_class is None:
        from portbench.system import PortSystem as system_class
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)

    inputs = generator.generate(traffic, config, seed, device,
                                world_seed=world_seed)
    system = system_class(config, traffic, inputs, device)
    t = 0
    for t in range(traffic["warmup_ticks"]):
        system.tick(t)
    t = traffic["warmup_ticks"]
    _sync(device)
    setup_s = time.perf_counter() - start
    # set-up's garbage is collected before the window, not inside it
    gc.collect()
    gc.freeze()

    system.spans.seconds.clear()
    ticks = []
    begin = time.perf_counter()
    while True:
        a = time.perf_counter()
        system.tick(t)
        b = time.perf_counter()
        ticks.append(b - a)
        t += 1
        if b - begin >= seconds:
            break
    window_s = b - begin
    gc.unfreeze()
    spans = {k: list(v) for k, v in system.spans.seconds.items()}
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    run = SimpleNamespace(
        batch=traffic["batch"], ticks=ticks, window_s=window_s,
        setup_s=setup_s, peak_bytes=peak, spans=spans, trace=None,
        traced_ticks=0, busy_s=0.0, trace_window_s=0.0,
        mapping_bytes=0, dense_bytes=0, detector_flops=(
            RM.flops(check.detector_config(config))
            if config.get("sensor") else 0),
        backbone_flops=(RR.flops(config["camera_size"],
                                 config["camera_size"])
                        if config.get("backbone") else 0))
    breakdown = None
    if traced:
        traced_at = time.perf_counter()
        # every traced run covers the same phase of the walks: the first
        # ticks of a pass over the frames, where every episode starts a
        # mission and refreshes its mesh
        while t % traffic["frames_per_episode"]:
            system.tick(t)
            t += 1
        logdir = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            data, t, tries = system.traced(t, traffic["traced_ticks"],
                                           logdir)
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        count = traffic["traced_ticks"]
        window = RT.spans(data, "portbench.ticks")[-1]
        run.trace, run.traced_ticks = data, count
        run.trace_window_s = (window[1] - window[0]) * 1e-6
        run.busy_s = RT.busy_us(data, *window) * 1e-6
        run.mapping_bytes = _mapping_bytes(
            config, traffic, inputs, system.schedule,
            range(t - count, t), device)
        if config.get("dense_families"):
            run.dense_bytes = _dense_bytes(
                config, traffic, inputs, system.schedule,
                range(t - count, t), device)
        breakdown = RT.breakdown(data, *window)
        trace_s = time.perf_counter() - traced_at

    entries = bench.metrics(workload, traced)
    metrics = {}
    for m in entries:
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run.trace = None

    system.release()
    judged = time.perf_counter()
    numbers = check.judge(config, traffic, inputs, system, device)
    check_s = time.perf_counter() - judged
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    failed = sum(c["value"] > c["limit"] for c in checks.values())
    result = {
        "correct": failed == 0,
        "attempted": traffic["batch"] * len(ticks),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": (torch.cuda.get_device_name(device) if cuda
                     else "cpu"),
            "count": cell["chips"],
            "memory_peak_bytes": peak}}
    if traced:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.trace_window_s
        result["breakdown"] = breakdown
    result["counts"] = {k: v for k, v in numbers.items()
                        if k not in checks}
    result["counts"]["ticks"] = t
    result["counts"]["check_s"] = check_s
    result["counts"]["host_ms"] = {k: 1e3 * sum(v) / len(v)
                                   for k, v in spans.items()}
    result["counts"]["tick_ms"] = dict(zip(
        ("p5", "p50", "p95", "max"),
        (float(x) for x in np.percentile(np.asarray(ticks) * 1e3,
                                         [5, 50, 95, 100]))))
    if traced:
        result["counts"]["trace_tries"] = tries
        result["counts"]["trace_s"] = trace_s
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache of the program at a fixed path inside
    # the checkout, so that only a checkout's first run builds
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # load from one process with few threads: the tick's host work is
    # Python and launches, and idle intra-op workers spinning beside it
    # on a shared host only add noise
    torch.set_num_threads(1)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", start=START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, default=_plain))
    return 0


def _plain(x):
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    raise TypeError(type(x))


if __name__ == "__main__":
    sys.exit(main())
