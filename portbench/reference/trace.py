"""Reading a torch.profiler (kineto) Chrome trace: device intervals, the
launches made inside a host span, the device's busy time over a window,
and the breakdown of device operations and idle gaps.

Host calls that put work on a card (kernel launches, copies, memsets)
are ``cuda_runtime``/``cuda_driver`` events; each one's device record is
a ``kernel``/``gpu_memcpy``/``gpu_memset`` event with the same
``args["correlation"]``.  Times are microseconds on the trace's clock.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def complete(data: Dict, categories) -> List[Dict]:
    return [e for e in data["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in categories]


def spans(data: Dict, name: str) -> List[Tuple[float, float]]:
    """``(start, end)`` of every host annotation named ``name``."""
    return sorted((e["ts"], e["ts"] + e["dur"])
                  for e in complete(data, ("user_annotation",))
                  if e["name"] == name)


def merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def busy_us(data: Dict, lo: float, hi: float) -> float:
    """The union of device intervals inside ``[lo, hi]``."""
    return sum(b - a for a, b in merged(
        (max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
        for e in complete(data, DEVICE)
        if e["ts"] < hi and e["ts"] + e["dur"] > lo))


def launched_in(data: Dict, name: str) -> Tuple[int, float]:
    """Launches whose host call lies inside an annotation named ``name``,
    and the union of their device records' intervals (us)."""
    windows = spans(data, name)
    device = {}
    for e in complete(data, DEVICE):
        device.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    count, intervals = 0, []
    for e in complete(data, LAUNCH):
        records = device.get(e.get("args", {}).get("correlation"))
        if not records or not any(a <= e["ts"] <= b for a, b in windows):
            continue
        count += 1
        intervals += [(r["ts"], r["ts"] + r["dur"]) for r in records]
    return count, sum(b - a for a, b in merged(intervals))


def breakdown(data: Dict, lo: float, hi: float, top: int = 10) -> Dict:
    """The device operations that took most time inside ``[lo, hi]`` and
    the longest idle gaps, each named by the host operation that
    overlapped it most (``python`` where none did); seconds."""
    events = [e for e in complete(data, DEVICE)
              if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e["name"]] += min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                  for e in events)
    edges = [lo] + [x for a, b in busy for x in (a, b)] + [hi]
    gaps = sorted(((edges[k], edges[k + 1])
                   for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]),
                  key=lambda g: g[0] - g[1])[:top]
    host = [e for e in complete(data, HOST)
            if e["ts"] < hi and e["ts"] + e["dur"] > lo
            and not e["name"].startswith(("ProfilerStep#", "portbench.",
                                          "profiling.trace"))]

    def host_op(a: float, b: float) -> Optional[str]:
        best, name = 0.0, "python"
        for e in host:
            overlap = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if overlap > best or (overlap == best > 0 and name == "python"):
                best, name = overlap, e["name"]
        return name

    return {"device_ops": [[n, t * 1e-6] for n, t in ops],
            "idle_gaps": [[host_op(a, b), (b - a) * 1e-6] for a, b in gaps]}
