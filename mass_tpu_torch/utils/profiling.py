"""Tracing and step timing (the port of ``mass_tpu.utils.profiling``).

``StageTimer`` aggregates wall time per pipeline stage (mapping,
planning, simulator, matching) across an episode.  PyTorch returns from
a CUDA call before the card has finished it, so a timer whose stages
launch device work synchronises the card at the end of each stage; on
the CPU there is nothing to wait for.

``trace`` captures a ``torch.profiler`` trace, host operations and, on a
card, the card's kernels and copies (CUPTI), and writes it as a Chrome
trace where the JAX package's capture writes its own:
``logdir/plugins/profile/<YYYY_MM_DD_HH_MM_SS>/<host>.trace.json.gz``,
which Perfetto (ui.perfetto.dev) and TensorBoard's profile plugin open.
``block`` waits for the devices that hold a tree's tensors, for timing
boundaries.  ``read_trace``, ``kernel_durations`` and ``device_summary``
read a written trace back: a kernel's launches and device times, the
card's busy share over the window, its top operations and its longest
idle gaps with the host operation that ran through each.

    with trace("build/trace") as t:        # the card, by default
        agent.run_task(0)
    print(device_summary(read_trace(t.path)))
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import socket
import time
import types
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

from mass_tpu_torch import resolve_device

# kernels launched on each card while the profiler warms up, before the
# traced window opens: in a process that has loaded many kernels, every
# second profiler session loses the device records of its first ~20
# launches (torch's kernels and ctypes-launched ones alike), and these
# absorb the loss
PRIMING_LAUNCHES = 1024
# trace categories of work on the device, and of work on the host that
# can run while the device idles
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver",
                   "user_annotation")


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
        t0 = time.perf_counter()
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

    def report(self) -> str:
        lines = [f"{name:24s} {s['count']:6d}x  "
                 f"{s['mean_ms']:8.2f} ms  {s['total_s']:8.2f} s"
                 for name, s in self.summary().items()]
        return "\n".join(lines)


@dataclasses.dataclass
class Trace:
    """A :func:`trace` in progress: whether it records CUDA activity and,
    once the trace has stopped, ``path``, the written file."""

    logdir: str
    cuda: bool
    path: Optional[str] = None


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
    runtime calls too; ``device="cpu"`` records the host only.  The
    profiler starts with a warm-up step, in which
    :data:`PRIMING_LAUNCHES` small kernels run on each card in use
    (outside the trace), and before it stops it synchronises each of
    those cards, so the block's first launches and those still in
    flight land in the trace.  The trace goes to
    ``logdir/plugins/profile/<time>/<host>.trace.json.gz``; the yielded
    :class:`Trace` names that file once the block has run.

    Raises ``RuntimeError`` inside another trace (one profiler runs at a
    time, as in JAX), when CUDA is asked for on a machine without it, and
    when CUDA activity was asked for and the trace recorded none: it
    never records the host alone in place of the card.
    """
    from torch.profiler import ProfilerActivity, profile, schedule, \
        supported_activities

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
    cards = _cards() if handle.cuda else []
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for index in cards:
            cell = torch.zeros(1, device=f"cuda:{index}")
            for _ in range(PRIMING_LAUNCHES):
                cell.add_(1)
            torch.cuda.synchronize(index)
        prof.step()                            # the traced window opens
        yield handle
        for index in _cards() if handle.cuda else []:
            torch.cuda.synchronize(index)
    out = os.path.join(logdir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{socket.gethostname()}.trace.json.gz")
    raw = path[:-len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src:
        text = src.read()
    os.remove(raw)
    # the closing synchronisation is a CUDA runtime call: a trace that
    # holds none had no CUDA activity recorded (CUPTI refused or absent)
    if handle.cuda and b'"cuda_runtime"' not in text:
        raise RuntimeError("trace: CUDA activity was asked for and the "
                           "profiler recorded none")
    with gzip.open(path, "wb", compresslevel=1) as dst:
        dst.write(text)
    handle.path = path


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


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def device_summary(trace: Dict, top: int = 10, gaps: int = 3) -> Dict:
    """What the devices did over the trace's window (the profiler's span).

    ``busy_share``: the union of kernel, copy and memset intervals over
    the span (any device); ``top``: the device operations that took the
    most time, by name; ``gaps``: the longest stretches with no device
    work, each with the host operation (an op, a runtime call) that
    overlapped it most (``None`` where the host ran Python only).  Times
    in us."""
    spans = _complete(trace, ("Trace",))
    events = _complete(trace, DEVICE_CATEGORIES)
    # the profiler's own step annotation spans the whole window
    host = [e for e in _complete(trace, HOST_CATEGORIES)
            if not e["name"].startswith("ProfilerStep#")]
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

    def host_op(a: float, b: float):
        # the most overlap; of equals, the innermost (shortest) operation
        overlaps = [(min(b, e["ts"] + e["dur"]) - max(a, e["ts"]),
                     -e["dur"], k) for k, e in enumerate(host)]
        overlap, _, k = max(overlaps, default=(0.0, 0.0, -1))
        return None if overlap <= 0 else dict(
            name=host[k]["name"], cat=host[k]["cat"], overlap_us=overlap)

    return dict(
        span_us=hi - lo, busy_us=busy_us,
        busy_share=busy_us / (hi - lo) if hi > lo else 0.0,
        device_events=len(events),
        top=[dict(name=n, count=c, total_us=t, share=t / (hi - lo))
             for n, (c, t) in ranked],
        gaps=[dict(start_us=a - lo, length_us=b - a, host=host_op(a, b))
              for a, b in idle])
