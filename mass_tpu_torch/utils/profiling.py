"""Tracing and step timing (the port of ``mass_tpu.utils.profiling``).

``span`` names a part of the port's work in a trace: while a profiler
runs it opens a ``record_function`` range, and otherwise it costs one
flag check.  The port opens ``mass.*`` spans where its fleet tick does
the work (the learned sensor's upload, stages, fusion and copy back; the
map update's upload, records and splats; the planner's refresh, snaps,
BFS, convergence checks and copy back).

``StageTimer`` aggregates wall time per pipeline stage (mapping,
planning, simulator, matching) across an episode, each stage inside a
``mass.stage.<name>`` span.  PyTorch returns from a CUDA call before the
card has finished it, so a timer whose stages launch device work
synchronises the card at the end of each stage; on the CPU there is
nothing to wait for.

``trace`` captures a ``torch.profiler`` trace, host operations and, on a
card, the card's kernels and copies (CUPTI), and writes it as a Chrome
trace where the JAX package's capture writes its own:
``logdir/plugins/profile/<YYYY_MM_DD_HH_MM_SS>/<host>.trace.json.gz``,
which Perfetto (ui.perfetto.dev) and TensorBoard's profile plugin open.
``block`` waits for the devices that hold a tree's tensors, for timing
boundaries.  ``read_trace``, ``kernel_durations``, ``device_summary``
and ``unrecorded_launches`` read a trace back: a kernel's launches and
device times, the card's busy share over the window, its top operations
and its longest idle gaps with the host operation that ran through each,
and the launches whose device record the profiler lost.

``trace`` never returns a CUDA trace that lost a launch: it matches every
launch of its window to the launch's device record and raises
:class:`IncompleteTrace` where one has none (kineto drops the device
records it stamps outside its capture window, and the card's clock as it
converts it runs off the host's: a window's first launches can lose
their records; ``trace``'s warm-up and pauses keep them in most
windows).  ``retried`` runs a traced window again in that case.  It puts
each card's records on the host's clock (:func:`align_clock`): no record
starts before its launch call, and no synchronisation returns before the
work it waited for has ended.

    with trace("build/trace") as t:        # the card, by default
        agent.run_task(0)
    print(t.launches, t.unrecorded)        # every launch, and 0
    print(t.clock)                         # each card's offsets and shift
    print(device_summary(t.data))          # the trace as it was parsed
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import socket
import threading
import time
import types
import warnings
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from mass_tpu_torch import resolve_device

# In a process that has run many kernels, every second profiler session
# loses the device records of its first ~20 launches (kineto counts them
# outside its capture window), and the card's clock as the profiler
# converts it drifts off the host's by up to a few milliseconds.  So trace
# launches PRIMING_LAUNCHES small kernels on each card in use in a warm-up
# step before the window opens (their records fall outside it, lost or
# not), and the host waits SKEW_PAUSE_S once the window has opened and
# again before it closes (PERF.md §6).
PRIMING_LAUNCHES = 1024
SKEW_PAUSE_S = 0.05
# the annotation around the traced block: device_summary's window
WINDOW = "profiling.trace window"
# trace categories of work on the device, and of work on the host that
# can run while the device idles
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver",
                   "user_annotation")
# trace categories of the host's CUDA calls, and the calls among them that
# put work on a device: each leaves one device record (a graph launch one
# per node) under its args["correlation"].  The others (synchronisations,
# event records, cudaFuncSetAttribute) put none.  A name may end in
# _ptsz or _ptds (the per-thread default stream's entry points).
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_APIS = (
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
    "cudaGraphLaunch", "cuGraphLaunch",
    "cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2D", "cudaMemcpy2DAsync",
    "cudaMemcpyPeer", "cudaMemcpyPeerAsync", "cudaMemcpyToSymbol",
    "cudaMemcpyToSymbolAsync", "cudaMemcpyFromSymbol",
    "cudaMemcpyFromSymbolAsync", "cuMemcpy", "cuMemcpyAsync",
    "cuMemcpyHtoD_v2", "cuMemcpyDtoH_v2", "cuMemcpyDtoD_v2",
    "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2", "cuMemcpyDtoDAsync_v2",
    "cudaMemset", "cudaMemsetAsync", "cudaMemset2D", "cudaMemset2DAsync",
    "cuMemsetD8_v2", "cuMemsetD32_v2", "cuMemsetD8Async", "cuMemsetD32Async")
LAUNCH_NAMES = frozenset(name + suffix for name in LAUNCH_APIS
                          for suffix in ("", "_ptsz", "_ptds"))
# host calls that return only once work on the card has ended: a
# synchronisation waits for what was launched before it (on the stream
# of the thread's last launch, or on the whole card), and a synchronous
# copy to the host for its own record
SYNC_NAMES = frozenset(name + suffix for name in (
    "cudaStreamSynchronize", "cudaDeviceSynchronize")
    for suffix in ("", "_ptsz", "_ptds"))
BLOCKING_COPY_NAMES = frozenset(name + suffix for name in (
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyFromSymbol", "cuMemcpy",
    "cuMemcpyDtoH_v2") for suffix in ("", "_ptsz", "_ptds"))
# the trace's top-level key that records align_clock's result
CLOCK_KEY = "mass_clock"
# the prefix of every span the port opens
SPAN_PREFIX = "mass."
# a traced window is run at most this many times (retried)
TRACE_TRIES = 3
_NO_ARGS: Dict = {}
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that names a part of the port's work in a trace: a
    ``record_function`` range while a profiler runs, else a shared no-op
    context (one flag check: no ``record_function``).  Names start with
    :data:`SPAN_PREFIX` and name a part of a layer,
    ``mass.<layer>.<part>``: no span wraps a whole layer, so a reader
    that names a stretch of the trace by the first span over it finds
    the part."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class IncompleteTrace(RuntimeError):
    """A CUDA trace in which a launch of the window has no device record.
    ``handle`` is the :class:`Trace`: its file stays at ``handle.path``."""

    def __init__(self, handle: "Trace"):
        self.handle = handle
        first = ", ".join(
            f"{e['name']} at {e['ts_us']:.1f} us"
            + (f" in {e['op']}" if e["op"] else "")
            for e in handle.matched["first_unrecorded"])
        super().__init__(
            f"trace: {handle.unrecorded} of {handle.launches} launches in "
            f"the window have no device record (first: {first}); the trace "
            f"is {handle.path}")


class StageTimer:
    """Accumulating per-stage wall-clock timer.

        timer = StageTimer(device)
        with timer.stage("mapping"):
            ...
        print(timer.summary())
    """

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time the block, and its card's work, as stage ``name``, inside
        a ``mass.stage.<name>`` span."""
        t0 = time.perf_counter()
        with span(SPAN_PREFIX + "stage." + name):
            try:
                yield
            finally:
                if self.device is not None and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: dict(total_s=self.totals[name],
                           count=self.counts[name],
                           mean_ms=1e3 * self.totals[name] /
                           max(self.counts[name], 1))
                for name in sorted(self.totals)}


@dataclasses.dataclass
class Trace:
    """A :func:`trace` in progress: whether it records CUDA activity and,
    once the trace has stopped, ``path``, the written file; ``data``, the
    trace as :func:`read_trace` would return it (parsed once, while it was
    written); ``launches``, the host's calls in the window that put work
    on a device, and ``unrecorded``, those of them without a device record
    (0 in a trace that ``trace`` returned); ``matched``, the whole
    :func:`unrecorded_launches` result; ``clock``, :func:`align_clock`'s
    result; and the seconds the profiler's export, the parse and the
    clock's alignment with the match took."""

    logdir: str
    cuda: bool
    path: Optional[str] = None
    data: Optional[Dict] = None
    launches: int = 0
    unrecorded: int = 0
    matched: Optional[Dict] = None
    clock: Optional[Dict] = None
    export_s: float = 0.0
    parse_s: float = 0.0
    check_s: float = 0.0


def _cards() -> List[int]:
    """The CUDA devices this process works on: the current one and every
    one that holds PyTorch memory (no other card gets a context)."""
    return sorted({torch.cuda.current_device()} | {
        index for index in range(torch.cuda.device_count())
        if torch.cuda.memory_reserved(index)})


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[Trace]:
    """Capture a torch.profiler trace viewable in Perfetto/TensorBoard.

    Records host operations, and with ``device`` CUDA (the default, as
    every entry point of the port) the card's kernels, copies and
    runtime calls too; ``device="cpu"`` records the host only.  On the
    card the profiler starts with a warm-up step, in which
    :data:`PRIMING_LAUNCHES` small kernels run on each card in use
    (outside the trace); once the window has opened, and again before it
    closes, the host waits :data:`SKEW_PAUSE_S`; and every card in use is
    synchronised at the block's end, so the block's first launches and
    those still in flight land in the trace.  The block runs inside a
    :data:`WINDOW` annotation.  The trace goes to
    ``logdir/plugins/profile/<time>/<host>.trace.json.gz``; the yielded
    :class:`Trace` names that file once the block has run, holds the
    parsed trace and the launches :func:`unrecorded_launches` matched.
    Each card's records are put on the host's clock before the file is
    written (:func:`align_clock`; ``clock`` on the handle, and
    :data:`CLOCK_KEY` in the file).

    Raises ``RuntimeError`` inside another trace (one profiler runs at a
    time, as in JAX), when CUDA is asked for on a machine without it, and
    when CUDA activity was asked for and the trace recorded none: it
    never records the host alone in place of the card.  Raises
    :class:`IncompleteTrace` (a ``RuntimeError``) once the file is
    written where a launch of the window has no device record: it never
    returns a trace that lost the card's work.  ``device="cpu"`` records
    no launch: ``launches`` is 0.
    """
    from torch.profiler import ProfilerActivity, profile, \
        record_function, schedule, supported_activities

    dev = resolve_device(device)
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("Profile has already been started. Only one "
                           "profile may be run at a time.")
    activities = [ProfilerActivity.CPU]
    handle = Trace(logdir, cuda=dev.type == "cuda")
    if handle.cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("trace: this PyTorch cannot record CUDA "
                               "activity (built without CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    pause = SKEW_PAUSE_S if handle.cuda else 0.0
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for index in _cards() if handle.cuda else []:
            cell = torch.zeros(1, device=f"cuda:{index}")
            for _ in range(PRIMING_LAUNCHES):
                cell.add_(1)
            torch.cuda.synchronize(index)
        prof.step()                            # the traced window opens
        time.sleep(pause)
        with record_function(WINDOW):
            yield handle
            for index in _cards() if handle.cuda else []:
                torch.cuda.synchronize(index)
        time.sleep(pause)
    out = os.path.join(logdir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{socket.gethostname()}.trace.json.gz")
    raw = path[:-len(".gz")]
    t0 = time.perf_counter()
    prof.export_chrome_trace(raw)
    handle.export_s = time.perf_counter() - t0
    with open(raw, "rb") as src:
        text = src.read()
    os.remove(raw)
    # the closing synchronisation is a CUDA runtime call: a trace that
    # holds none had no CUDA activity recorded (CUPTI refused or absent)
    if handle.cuda and b'"cuda_runtime"' not in text:
        raise RuntimeError("trace: CUDA activity was asked for and the "
                           "profiler recorded none")
    t0 = time.perf_counter()
    handle.data = json.loads(text)
    t1 = time.perf_counter()
    handle.clock = align_clock(handle.data)
    text = json.dumps(handle.data).encode()
    # the compression (which releases the GIL) beside the match
    writer = threading.Thread(target=_write_gzip, args=(path, text))
    writer.start()
    try:
        handle.matched = unrecorded_launches(handle.data)
        handle.parse_s, handle.check_s = t1 - t0, time.perf_counter() - t1
    finally:
        writer.join()
    handle.path = path
    handle.launches = handle.matched["launches"]
    handle.unrecorded = handle.matched["unrecorded"]
    if handle.unrecorded:
        raise IncompleteTrace(handle)


def _write_gzip(path: str, text: bytes) -> None:
    with gzip.open(path, "wb", compresslevel=1) as dst:
        dst.write(text)


def retried(window, tries: int = TRACE_TRIES):
    """``window()``, a block that records a :func:`trace`, run again where
    it raises :class:`IncompleteTrace`, ``tries`` times in all at most:
    returns (its result, the tries it took).  The last try's
    ``IncompleteTrace`` propagates; so does any other error at once."""
    for attempt in range(1, tries + 1):
        try:
            return window(), attempt
        except IncompleteTrace:
            if attempt == tries:
                raise


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor reachable from ``tree``: through dicts, lists, tuples
    (named ones too), dataclasses and the attributes of other objects
    (the port's maps, layers and fleets), each object once."""
    seen, stack = set(), [tree]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, torch.Tensor):
            yield node
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, (type, types.ModuleType, types.FunctionType,
                               types.MethodType)):
            continue
        elif dataclasses.is_dataclass(node):
            stack.extend(getattr(node, f.name)
                         for f in dataclasses.fields(node))
        elif hasattr(node, "__dict__"):
            stack.extend(vars(node).values())


def block(tree) -> None:
    """Synchronize on all tensors in a tree (for timing boundaries): each
    distinct CUDA device that holds one is synchronised once.  A tree of
    CPU tensors returns at once; no tensor is copied."""
    for device in {t.device for t in _tensors(tree)
                   if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def read_trace(path: str) -> Dict:
    """A trace :func:`trace` wrote (gzipped Chrome JSON)."""
    with gzip.open(path, "rt") as f:
        return json.load(f)


def _complete(trace: Dict, categories) -> List[Dict]:
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in categories]


def kernel_durations(trace: Dict, name: str) -> List[float]:
    """The device time in us of every launch of the kernels whose name
    holds ``name``, in the trace's order."""
    return [e["dur"] for e in _complete(trace, ("kernel",))
            if name in e["name"]]


def unrecorded_launches(trace: Dict, first: int = 5) -> Dict:
    """Match every host call of the trace that puts work on a device to
    its device record.

    A launch is a ``cuda_runtime`` or ``cuda_driver`` event named in
    :data:`LAUNCH_APIS`; its device record is an event of
    :data:`DEVICE_CATEGORIES` with the same ``args["correlation"]`` (a
    graph launch's nodes share its correlation: it counts once).  Returns
    ``launches`` and ``unrecorded`` (those without a device record), by
    API name in ``by_api`` ({name: [launches, unrecorded]}), the first
    ``first`` unrecorded ones in host order (``name``, ``ts_us`` after
    the trace's start, ``position`` among the launches, ``op``: the
    innermost host operation around the call, or ``None``) and
    ``unlisted``: the names of other host CUDA calls that have a device
    record (none, where :data:`LAUNCH_APIS` is complete).

    On an H100 (torch 2.11, CUDA 12.8) kineto writes each call as an
    ``X`` event of category ``cuda_runtime`` with ``args["correlation"]``,
    and each kernel, copy and memset as one of category ``kernel``,
    ``gpu_memcpy`` or ``gpu_memset`` with the same key.  A traced episode
    with NMS and host copies held these launches: ``cudaLaunchKernel``,
    ``cudaLaunchKernelExC`` (``cudaLaunchKernelEx``, as ``csrc/nms.cu``
    launches), ``cudaMemcpyAsync`` and ``cudaMemsetAsync``, every one
    with its device record; and these calls, none with one:
    ``cudaDeviceSynchronize``, ``cudaStreamSynchronize``,
    ``cudaStreamIsCapturing``, ``cudaPeekAtLastError``,
    ``cudaFuncSetAttribute``, ``cudaEventRecordWithFlags``,
    ``cudaEventQuery``, ``cudaDeviceGetAttribute``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessorWithFlags`` and
    ``cudaPointerGetAttributes``."""
    device, host = frozenset(DEVICE_CATEGORIES), frozenset(LAUNCH_CATEGORIES)
    recorded, calls = set(), []
    for e in trace["traceEvents"]:
        cat = e.get("cat")
        if cat in device:
            recorded.add(e.get("args", _NO_ARGS).get("correlation"))
        elif cat in host:
            calls.append(e)
    launches, lost, unlisted = [], [], set()
    by_api: Dict[str, List[int]] = {}
    for e in calls:
        seen = e.get("args", _NO_ARGS).get("correlation") in recorded
        if e["name"] in LAUNCH_NAMES:
            launches.append(e)
            counts = by_api.setdefault(e["name"], [0, 0])
            counts[0] += 1
            if not seen:
                lost.append(e)
                counts[1] += 1
        elif seen:
            unlisted.add(e["name"])
    return dict(launches=len(launches), unrecorded=len(lost), by_api=by_api,
                first_unrecorded=_first_lost(trace, launches, lost, first),
                unlisted=sorted(unlisted))


def _first_lost(trace: Dict, launches: List[Dict], lost: List[Dict],
                first: int) -> List[Dict]:
    """The first ``first`` of ``lost`` in host order, placed in the
    trace (a second pass over the events, made only where one was lost)."""
    if not lost or first <= 0:
        return []
    spans = _complete(trace, ("Trace",))
    start = min(e["ts"] for e in spans or launches)
    order = sorted(launches, key=lambda e: e["ts"])
    position = {id(e): k for k, e in enumerate(order)}
    ops = _complete(trace, ("cpu_op", "user_annotation"))
    out = []
    for e in sorted(lost, key=lambda e: e["ts"])[:first]:
        around = [o for o in ops if o["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                  and not o["name"].startswith("ProfilerStep#")
                  and o["name"] != WINDOW]
        op = min(around, key=lambda o: o["dur"], default=None)
        out.append(dict(name=e["name"], ts_us=e["ts"] - start,
                        position=position[id(e)],
                        op=op["name"] if op else None))
    return out


def _card(record: Dict) -> int:
    return record.get("args", _NO_ARGS).get("device", record.get("pid"))


def _clock_points(trace: Dict) -> Dict[int, Dict]:
    """For each card, the constraints the trace's host calls put on the
    offset (us) to add to its records' times, each at a record's start
    on the card's clock: ``lower`` ``[n, 2]`` rows (record start, its
    launch call's start less the record's: no record starts before its
    launch call) and ``upper`` rows (the start of the last record a
    synchronisation waited for, the call's return less that record's
    end: no synchronisation, or synchronous copy to the host, returns
    before the work it waited for has ended).  A synchronisation waits
    for every record launched before it on the stream of its thread's
    last launch (``cudaStreamSynchronize``, as PyTorch's copies to the
    host and ``item()`` call it) or on the whole card
    (``cudaDeviceSynchronize``)."""
    device: Dict = {}
    for e in _complete(trace, DEVICE_CATEGORIES):
        device.setdefault(e.get("args", _NO_ARGS).get("correlation"),
                          []).append(e)
    calls = sorted(_complete(trace, LAUNCH_CATEGORIES), key=lambda e: e["ts"])
    points: Dict[int, Dict] = {}
    ended: Dict = {}          # (card, stream) -> the latest-ending record
    last: Dict = {}           # host thread -> (card, stream) of its launch

    def card_points(card: int) -> Dict:
        return points.setdefault(card, dict(lower=[], upper=[]))

    for e in calls:
        end = e["ts"] + e["dur"]
        if e["name"] in LAUNCH_NAMES:
            records = device.get(e.get("args", _NO_ARGS).get("correlation"))
            for r in records or ():
                card = _card(r)
                at = card_points(card)
                at["lower"].append((r["ts"], e["ts"] - r["ts"]))
                key = (card, r.get("args", _NO_ARGS).get("stream"))
                if key not in ended or r["ts"] + r["dur"] > \
                        ended[key]["ts"] + ended[key]["dur"]:
                    ended[key] = r
                last[e.get("tid")] = key
                if e["name"] in BLOCKING_COPY_NAMES and "DtoH" in r["name"]:
                    at["upper"].append((r["ts"], end - r["ts"] - r["dur"]))
        elif e["name"] in SYNC_NAMES and e.get("tid") in last:
            card, stream = last[e.get("tid")]
            if e["name"].startswith("cudaDeviceSynchronize"):
                done = max((r for (c, _), r in ended.items() if c == card),
                           key=lambda r: r["ts"] + r["dur"])
            else:
                done = ended[card, stream]
            card_points(card)["upper"].append(
                (done["ts"], end - done["ts"] - done["dur"]))
    return {card: {k: np.asarray(v, np.float64).reshape(-1, 2)
                   for k, v in at.items()} for card, at in points.items()}


def _offsets(at: Dict, t0: float, drift: float):
    """The interval of offsets at ``t0`` that the card's constraints
    allow for a clock that runs ``drift`` (a rate, us per us) off the
    host's."""
    lower, upper = at["lower"], at["upper"]
    lo = float(np.max(lower[:, 1] - drift * (lower[:, 0] - t0))) \
        if len(lower) else -float("inf")
    hi = float(np.min(upper[:, 1] - drift * (upper[:, 0] - t0))) \
        if len(upper) else float("inf")
    return lo, hi


def _widest_drift(at: Dict, t0: float) -> float:
    """The drift whose interval of offsets is widest (or least crossed):
    the width is concave in the drift, so a golden-section search finds
    its peak within 5% of the host's rate."""
    def width(drift: float) -> float:
        lo, hi = _offsets(at, t0, drift)
        return hi - lo

    a, b = -0.05, 0.05
    g = (5 ** 0.5 - 1) / 2
    c, d = b - g * (b - a), a + g * (b - a)
    wc, wd = width(c), width(d)
    while b - a > 1e-13:
        if wc >= wd:
            b, d, wd = d, c, wc
            c = b - g * (b - a)
            wc = width(c)
        else:
            a, c, wc = c, d, wd
            d = a + g * (b - a)
            wd = width(d)
    return (a + b) / 2


def align_clock(trace: Dict) -> Dict[int, Dict]:
    """Put each card's records on the host's clock, in place.

    The card's clock, as the profiler converts it, may sit off the
    host's by a constant and may run at another rate (on an H100 up to
    4 ms a second inside one trace).  The constraints of
    :func:`_clock_points` bound the constant offsets that may be added
    to the card's records: ``lo_us``, minus the shortest wait from a
    launch call to its record's start, and ``hi_us``, the shortest wait
    from the end of the work to a synchronisation's return; a trace whose
    clocks agree has ``lo_us`` <= 0 <= ``hi_us`` and is left as it is.
    Where ``lo_us`` <= ``hi_us`` the records keep their rate and move by
    the offset nearest 0, the nearer end, 1 ns inside it (the trace's
    resolution).  Otherwise the offset is a line in the record's time,
    ``shift_us`` at the card's first record plus ``drift_ppm`` millionths
    of the time since: the drift whose interval of offsets is widest, and
    the offset in it chosen as above (in an interval narrower than 2 ns,
    its midpoint).  Each record (kernels, copies,
    memsets, and the ends of the flow arrows from their launches) moves
    by the line at its start.  Where even the widest line's interval is
    crossed (``consistent`` False), no line puts the records back: they
    are left as they are (``shift_us`` and ``drift_ppm`` 0) and a warning
    says so.

    Returns {card: ``lo_us``, ``hi_us``, ``launches`` and ``syncs`` (the
    records and calls behind the bounds), ``shift_us``, ``drift_ppm``,
    ``consistent``}, which the trace also keeps under :data:`CLOCK_KEY`
    (cards as strings, as JSON has them)."""
    clock, moved = {}, {}
    for card, at in _clock_points(trace).items():
        t0 = float(np.min(at["lower"][:, 0])) if len(at["lower"]) else 0.0
        lo, hi = _offsets(at, t0, 0.0)
        drift = 0.0 if lo <= hi else _widest_drift(at, t0)
        low, high = _offsets(at, t0, drift)
        consistent = low <= high
        if not consistent:
            warnings.warn(f"align_clock: card {card}'s records cross every "
                          f"line of offsets; left as they are")
            shift = drift = 0.0
        elif low <= 0.0 <= high and not drift:
            shift = 0.0
        elif high - low > 2e-3:
            shift = min(max(0.0, low + 1e-3), high - 1e-3)
        else:
            shift = (low + high) / 2
        clock[card] = dict(lo_us=lo, hi_us=hi, launches=len(at["lower"]),
                           syncs=len(at["upper"]), shift_us=shift,
                           drift_ppm=drift * 1e6, consistent=consistent)
        if shift or drift:
            moved[card] = (t0, shift, drift)
    for e in trace["traceEvents"] if moved else ():
        if e.get("cat") in DEVICE_CATEGORIES:
            line = moved.get(_card(e))
        elif e.get("cat") == "ac2g" and e.get("ph") == "f":
            line = moved.get(e.get("pid"))
        else:
            continue
        if line:
            t0, shift, drift = line
            e["ts"] += shift + drift * (e["ts"] - t0)
    trace[CLOCK_KEY] = {str(card): {k: _finite(v) for k, v in c.items()}
                        for card, c in clock.items()}
    return clock


def _finite(value):
    """An unbounded end as None (JSON has no infinity)."""
    if isinstance(value, float) and value in (float("inf"), -float("inf")):
        return None
    return value


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def device_summary(trace: Dict, top: int = 10, gaps: int = 3) -> Dict:
    """What the devices did over the trace's window: :func:`trace`'s
    :data:`WINDOW` annotation, else the profiler's span.

    ``busy_share``: the union of kernel, copy and memset intervals over
    the span (any device); ``top``: the device operations that took the
    most time, by name; ``gaps``: the longest stretches with no device
    work, each with the host operation (an op, a runtime call) that
    overlapped it most (``host``, ``None`` where the host ran Python
    only) and the port's :func:`span` that overlapped it most (``span``,
    ``None`` where none did; of equal overlaps, the innermost);
    ``launches`` and ``unrecorded_launches``: the window's launches and
    those the profiler lost (:func:`unrecorded_launches`), whose device
    time the busy share lacks.  Times in us."""
    matched = unrecorded_launches(trace, first=0)
    spans = [e for e in _complete(trace, ("user_annotation",))
             if e["name"] == WINDOW] or _complete(trace, ("Trace",))
    events = _complete(trace, DEVICE_CATEGORIES)
    # the profiler's own step annotation and trace's window span it all;
    # the port's spans are named apart from the host's operations
    host, parts = [], []
    for e in _complete(trace, HOST_CATEGORIES):
        if e["name"].startswith(SPAN_PREFIX):
            parts.append(e)
        elif not e["name"].startswith("ProfilerStep#") \
                and e["name"] != WINDOW:
            host.append(e)
    if spans:
        lo = min(e["ts"] for e in spans)
        hi = max(e["ts"] + e["dur"] for e in spans)
    else:
        every = events + host
        lo = min(e["ts"] for e in every)
        hi = max(e["ts"] + e["dur"] for e in every)
    busy = _merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
    idle = sorted(((edges[k], edges[k + 1])
                   for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]),
                  key=lambda g: g[0] - g[1])[:gaps]

    def around(events: List[Dict], a: float, b: float):
        # the most overlap; of equals, the innermost (shortest) event
        overlaps = [(min(b, e["ts"] + e["dur"]) - max(a, e["ts"]),
                     -e["dur"], k) for k, e in enumerate(events)]
        overlap, _, k = max(overlaps, default=(0.0, 0.0, -1))
        return None if overlap <= 0 else dict(
            name=events[k]["name"], cat=events[k]["cat"], overlap_us=overlap)

    return dict(
        span_us=hi - lo, busy_us=busy_us,
        busy_share=busy_us / (hi - lo) if hi > lo else 0.0,
        launches=matched["launches"],
        unrecorded_launches=matched["unrecorded"],
        device_events=len(events),
        top=[dict(name=n, count=c, total_us=t, share=t / (hi - lo))
             for n, (c, t) in ranked],
        gaps=[dict(start_us=a - lo, length_us=b - a, host=around(host, a, b),
                   span=around(parts, a, b))
              for a, b in idle])
