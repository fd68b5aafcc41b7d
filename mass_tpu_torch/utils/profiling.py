"""Per-stage wall-clock timing (the port of ``mass_tpu.utils.profiling``'s
``StageTimer``; tracing arrives with a later slice).

PyTorch returns from a CUDA call before the card has finished it, so a
timer whose stages launch device work synchronises the card at the end
of each stage; on the CPU there is nothing to wait for.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


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
