"""Does a torch.profiler trace record every kernel launch?  On one card.

    python -m mass_tpu_torch.profile_trace

Launches the single-map splat (one random frame's records into a
384x384x96x54 map) and the NMS kernel (the RPN's five levels of one
frame, 500 boxes each, whose shared-memory limit ``nms_launch`` raises
at every launch, and the first 256 boxes of the class-aware problem,
under the static limit) 20 times each, an L2 flush before every
launch, under each way of recording them, three times over, and prints
the launches each recorded.  The ways differ in one thing at a time:

- ``cuda/averages``: CUDA activity only, the card synchronised inside
  the window, launches counted through ``key_averages()``;
- ``cuda/json``: the same window, counted in its exported Chrome trace;
- ``cuda+cpu/averages``: CPU and CUDA activity, ``key_averages()``;
- ``cuda+cpu/json``: CPU and CUDA activity, counted in the exported
  Chrome trace (``trace`` without its pauses and its check);
- ``cuda/no sync``: CUDA activity only, no synchronisation before the
  profiler stops, ``key_averages()``;
- ``cuda/after timing``: ``cuda/averages`` right after the sequence the
  kernel table's timing runs first (one launch, 50 back to back, 20
  between CUDA events after a flush and a device sleep);
- ``trace``: ``utils.profiling.trace``, counted in the trace it parsed
  (a window that raised ``IncompleteTrace`` run again, three tries in
  all).

Then it runs, one after another in the same process, what the kernel
table's NMS phase runs before its timing (the built kernel's shape
queries, NMS launches of 1 to 1,024 boxes, the dependent-step probe,
the detector on one frame and on eight), and after each counts the
RPN's launches again under ``cuda/averages`` and ``trace``.  Last, it
holds ever more of the card's memory (1 GiB, 256 MiB, then 32 MiB left
free, as the script's full-width fleets leave PyTorch's cache holding
it), and at each step counts the splat, the RPN's NMS and two kernels of
a few lines outside the port (``TOY_SOURCE``: one launched as NMS is,
through ``cudaLaunchKernelEx`` as clusters of 8 blocks after raising its
shared-memory limit, one without the cluster), then again once the
memory is released.  The last line is a JSON object: per case and way,
the launches each repeat recorded of 20 (``trace``: and the tries it
took).  The run fails where a ``trace`` window was still incomplete after
its tries.
"""

from __future__ import annotations

import ctypes
import json
import os
import time

import numpy as np
import torch

ITERS = 20
REPEATS = 3
LOGDIR = os.path.join("build", "profile_trace")
# the card's memory left free while the last cases count, in bytes
FREE_STEPS = (1 << 30, 256 << 20, 32 << 20)

# a kernel of a few lines outside the port, launched as csrc/nms.cu
# launches its kernel (cudaLaunchKernelEx, clusters of 8 blocks, the
# dynamic shared-memory limit raised above 48 KB first), and its twin
# launched the same way without the cluster
TOY_SOURCE = r"""
#include <cuda_runtime.h>
#define TOY(name) __global__ void name(float* x) {                       \
    extern __shared__ float s[];                                        \
    const int i = blockIdx.x * blockDim.x + threadIdx.x;                \
    s[threadIdx.x] = x[i];                                              \
    __syncthreads();                                                    \
    x[i] = s[blockDim.x - 1 - threadIdx.x] + 1.0f;                      \
  }
TOY(toy_kernel)
TOY(toy_cluster_kernel)
extern "C" int toy_launch(float* x, int blocks, int cluster, int shared,
                          cudaStream_t stream) {
  void (*kernel)(float*) = cluster > 1 ? toy_cluster_kernel : toy_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = cluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(256);
  config.dynamicSmemBytes = shared;
  config.stream = stream;
  config.attrs = &attribute;
  config.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, x);
  return err != cudaSuccess ? err : cudaGetLastError();
}
"""


def _splat(dev, rng):
    """One launch of the single-map splat: a random frame's sorted
    records into a full-width map."""
    from mass_tpu_torch.ops import splat as SP

    V, F, n = 384 * 384 * 96, 54, 8 * 224 * 224
    data = torch.zeros((V, F), device=dev)
    ids = torch.from_numpy(rng.randint(0, V, n).astype(np.int32)).to(dev)
    weights = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
    classes = torch.from_numpy(rng.randint(0, F, n).astype(np.int32)).to(dev)
    records = SP.sorted_records(ids, weights, classes)
    return lambda: SP.apply_records(data, records, 0.5)


def nms_call(dev, problem):
    from mass_tpu_torch.ops import detection as D

    boxes, scores, threshold, caps = problem
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    scores = torch.from_numpy(scores.astype(np.float32)).to(dev)
    return lambda: D.nms(boxes, scores, threshold, caps)


def _window(fn, flush):
    for _ in range(ITERS):
        flush.zero_()
        fn()


def _averaged(prof, kernel: str) -> int:
    return sum(e.count for e in prof.key_averages() if kernel in e.key)


def _exported(prof) -> dict:
    os.makedirs(LOGDIR, exist_ok=True)
    path = os.path.join(LOGDIR, "window.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    return trace


def _json(prof, kernel: str) -> int:
    from mass_tpu_torch.utils import profiling

    return len(profiling.kernel_durations(_exported(prof), kernel))


def session_report(trace: dict, kernel: str) -> dict:
    """What a session's trace holds of its window of ``ITERS`` flushes and
    ``ITERS`` launches of ``kernel``: the kernel's launches recorded, the
    flushes' fill kernels recorded, and what ``unrecorded_launches``
    finds, by API (the port's NMS and the toys launch through
    ``cudaLaunchKernelExC``, the fills through ``cudaLaunchKernel``); the
    lost launches' positions among the session's launches in host order
    (as runs) and the times of the first two and the last of their calls
    after the session opened (us); over the recorded launches, their
    device record's start less their call's (us: min, median; a negative
    one means the two clocks disagree) and the first device record's
    start after the session opened."""
    from mass_tpu_torch.utils import profiling

    matched = profiling.unrecorded_launches(trace, first=1 << 20)
    lost = matched["first_unrecorded"]
    calls, device = {}, {}
    for e in trace["traceEvents"]:
        correlation = e.get("args", {}).get("correlation")
        if e.get("ph") != "X" or correlation is None:
            continue
        if e.get("cat") in profiling.DEVICE_CATEGORIES:
            device.setdefault(correlation, e["ts"])
        elif e.get("name") in profiling.LAUNCH_NAMES:
            calls[correlation] = e["ts"]
    start = min(e["ts"] for e in trace["traceEvents"]
                if e.get("cat") == "Trace")
    offsets = [device[c] - ts for c, ts in calls.items() if c in device]
    return dict(
        recorded=len(profiling.kernel_durations(trace, kernel)),
        fills=len(profiling.kernel_durations(trace, "FillFunctor")),
        launches=matched["launches"], unrecorded=matched["unrecorded"],
        by_api=matched["by_api"], unlisted=matched["unlisted"],
        lost_positions=_ranges([e["position"] for e in lost]),
        lost_call_us=[round(e["ts_us"], 1) for e in lost[:2] + lost[-1:]],
        offset_us=[round(min(offsets), 1), round(float(np.median(offsets)),
                                                 1)] if offsets else None,
        first_device_us=round(min(device.values()) - start, 1)
        if device else None)


def _ranges(values: list) -> list:
    """Sorted integers as runs: [0, 1, 2, 5] -> ["0-2", "5"]."""
    out = []
    for v in values:
        if out and v == out[-1][1] + 1:
            out[-1][1] = v
        else:
            out.append([v, v])
    return [f"{a}-{b}" if b > a else f"{a}" for a, b in out]


def matched_session(fn, kernel: str, flush, pause_s: float = 0.0,
                    primer: int = 0) -> dict:
    """A plain session (``cuda+cpu/json``) of ``ITERS`` calls of ``fn``,
    read by :func:`session_report`; with ``pause_s``, the host sleeps
    that long once the profiler has started and again before it stops
    (as ``utils.profiling.trace`` does), and with ``primer``, that many
    small kernels run (the card synchronised after them) before the
    window, inside the session (their launches count in the report)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pause_s)
        if primer:
            cell = torch.zeros(1, device=flush.device)
            for _ in range(primer):
                cell.add_(1)
            torch.cuda.synchronize()
        _window(fn, flush)
        torch.cuda.synchronize()
        time.sleep(pause_s)
    torch.cuda.synchronize()
    return session_report(_exported(prof), kernel)


def _timing_sequence(fn, flush):
    """What the kernel table's timing runs before its profiler window."""
    fn()
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    for _ in range(ITERS):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()


def _profiled(fn, kernel, flush, activities, sync=True, reader=_averaged,
              before=None) -> int:
    from torch.profiler import profile

    if before is not None:
        before()
    with profile(activities=activities) as prof:
        _window(fn, flush)
        if sync:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return reader(prof, kernel)


def _traced(fn, kernel, flush) -> dict:
    """``kernel``'s launches in a ``utils.profiling.trace`` of the window,
    and the tries the trace took (``profiling.retried``)."""
    from mass_tpu_torch.utils import profiling

    def window():
        with profiling.trace(LOGDIR) as handle:
            _window(fn, flush)
        return handle
    handle, tries = profiling.retried(window)
    return dict(recorded=len(profiling.kernel_durations(handle.data, kernel)),
                launches=handle.launches, unrecorded=handle.unrecorded,
                tries=tries)


def ways(fn, flush):
    from torch.profiler import ProfilerActivity

    cuda = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return {
        "cuda/averages": lambda k: _profiled(fn, k, flush, cuda),
        "cuda/json": lambda k: _profiled(fn, k, flush, cuda, reader=_json),
        "cuda+cpu/averages": lambda k: _profiled(fn, k, flush, both),
        "cuda+cpu/json": lambda k: _profiled(fn, k, flush, both,
                                             reader=_json),
        "cuda/no sync": lambda k: _profiled(fn, k, flush, cuda, sync=False),
        "cuda/after timing": lambda k: _profiled(
            fn, k, flush, cuda, before=lambda: _timing_sequence(fn, flush)),
        "trace": lambda k: _traced(fn, k, flush)}


def recorded(fn, kernel: str, flush, only=None) -> dict:
    """Launches of ``kernel`` each way (or each of ``only``) records of
    ``ITERS`` calls of ``fn``, ``REPEATS`` times over; ``trace``'s as
    :func:`_traced` returns them.  A ``trace`` still incomplete after its
    tries is reported as such, a way that raised otherwise (refused on a
    full card) with its error."""
    from mass_tpu_torch.utils import profiling

    every = ways(fn, flush)
    out = {way: [] for way in (only or every)}
    for _ in range(REPEATS):
        for way in out:
            try:
                out[way].append(every[way](kernel))
            except profiling.IncompleteTrace as e:
                out[way].append(f"incomplete after {profiling.TRACE_TRIES} "
                                f"tries: {e}"[:200])
            except RuntimeError as e:        # a way refused on a full card
                out[way].append(f"raised: {e}"[:200])
    return out


def _shape_queries(dev, rng):
    from mass_tpu_torch.ops import detection as D

    for n in (500, 512, 1024):
        D.nms_config(n)


def _many_sizes(dev, rng):
    from mass_tpu_torch.ops import detection as D

    for n in (1, 31, 33, 255, 257, 700, 1024):
        xy = rng.uniform(0, 200, (1, n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (1, n, 2))], 2)
        D.nms(torch.from_numpy(boxes.astype(np.float32)).to(dev),
              torch.from_numpy(rng.rand(1, n).astype(np.float32)).to(dev),
              0.5, min(n, 100))
    torch.cuda.synchronize()


def _step_probe(dev, rng):
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.ops import splat as SP

    probe = D._library().nms_step_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(5, dtype=torch.int64, device=dev)
    for _ in range(2):
        SP._raise_on(probe(1 << 16, out.data_ptr(), SP._stream(dev)),
                     "dependent-step probe")
        torch.cuda.synchronize()


def _detector(dev, rng):
    from mass_tpu_torch.perception import maskrcnn as TM

    torch.manual_seed(0)
    config = TM.MaskRCNNConfig()
    model = TM.MaskRCNN(config).to(dev).eval()
    anchors = TM.device_anchors(config, dev)
    with torch.no_grad():
        for batch in (1, 8):
            TM.detect(model, torch.rand(batch, 224, 224, 3, device=dev),
                      anchors)
    torch.cuda.synchronize()


def toys(dev) -> dict:
    """The two toy kernels' launches, built with the port's nvcc flags
    into ``build/profile_trace/``: name -> a launch of 40 blocks with 54 KB
    of dynamic shared memory each (NMS's at 500 boxes)."""
    import subprocess

    from mass_tpu_torch.ops import splat as SP

    os.makedirs(LOGDIR, exist_ok=True)
    source = os.path.join(LOGDIR, "toy.cu")
    library = os.path.join(LOGDIR, "libtoy.so")
    with open(source, "w") as f:
        f.write(TOY_SOURCE)
    subprocess.run([SP.nvcc(), *SP.NVCC_FLAGS, "-o", library, source],
                   check=True)
    launch = ctypes.CDLL(os.path.abspath(library)).toy_launch
    launch.restype = ctypes.c_int
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    x = torch.zeros(40 * 256, device=dev)

    def toy(cluster):
        return lambda: SP._raise_on(launch(
            x.data_ptr(), 40, cluster, 54000, SP._stream(dev)), "toy")
    return {"toy_kernel": toy(1), "toy_cluster_kernel": toy(8)}


def _hold(dev, free: int, held: list) -> None:
    """Allocate 64 MiB blocks until at most ``free`` bytes of the card
    are left (the blocks stay in ``held``)."""
    while torch.cuda.mem_get_info(dev)[0] > free + (64 << 20):
        held.append(torch.empty(64 << 20, dtype=torch.uint8, device=dev))


# what the kernel table's NMS phase runs before it times the RPN, in order
PRELUDES = (("the shape queries", _shape_queries),
            ("NMS of 1 to 1,024 boxes", _many_sizes),
            ("the step probe", _step_probe),
            ("the detector", _detector))


def main() -> None:
    from mass_tpu_torch.ops import splat as SP
    from mass_tpu_torch.profile_nms import problems

    if not torch.cuda.is_available():
        raise SystemExit("profile_trace: needs a CUDA card")
    SP.build()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    cases = problems(rng)
    boxes, scores, threshold, caps = cases["detection_b1"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernels = {
        "splat_onehot_kernel": _splat(dev, rng),
        "nms_kernel rpn_b1": nms_call(dev, cases["rpn_b1"]),
        "nms_kernel 256 boxes": nms_call(dev, (boxes[:, :256],
                                               scores[:, :256], threshold,
                                               caps))}
    result = {}

    def report(name, counts):
        result[name] = counts
        for way, got in counts.items():
            tries = [g["tries"] for g in got if isinstance(g, dict)]
            got = [g["recorded"] if isinstance(g, dict) else g for g in got]
            print(f"[profile_trace] {name}: {way}: {got} of {ITERS}"
                  + (f" ({tries} tries)" if tries else ""))

    for name, fn in kernels.items():
        fn()
        torch.cuda.synchronize()
        report(name, recorded(fn, name.split()[0], flush))
    pair = ("cuda/averages", "trace")
    for name, prelude in PRELUDES:
        prelude(dev, rng)
        report(f"nms_kernel rpn_b1 after {name}",
               recorded(kernels["nms_kernel rpn_b1"], "nms_kernel", flush,
                        only=pair))
    subjects = {"splat_onehot_kernel": kernels["splat_onehot_kernel"],
                "nms_kernel": kernels["nms_kernel rpn_b1"], **toys(dev)}
    held = []
    for free in FREE_STEPS + (None,):
        if free is None:
            del held[:]
            torch.cuda.empty_cache()
        else:
            _hold(dev, free, held)
        left = torch.cuda.mem_get_info(dev)[0] >> 20
        for name, fn in subjects.items():
            report(f"{name} with {left} MiB of the card free",
                   recorded(fn, name, flush, only=pair))
    print(json.dumps({"iters": ITERS, "recorded": result}))
    incomplete = [name for name, counts in result.items()
                  for got in counts.get("trace", [])
                  if isinstance(got, str) and got.startswith("incomplete")]
    if incomplete:
        raise SystemExit(f"profile_trace: a trace was still incomplete "
                         f"after its tries in {incomplete}")


if __name__ == "__main__":
    main()
