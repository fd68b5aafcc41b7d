"""planning.bfs_kernel_share on made-up traces: the share of the window's
BFS fields inside which the BFS kernel was launched, 0 where the fields
ran without it, and nothing without fields or a trace."""

import os
from types import SimpleNamespace

import pytest

from portbench.bench import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = "planning.bfs_kernel_share"
KERNEL = "void (anonymous namespace)::bfs_field_kernel(unsigned char const*)"


def _x(cat, name, ts, end, correlation=None):
    event = dict(ph="X", cat=cat, name=name, ts=ts, dur=end - ts)
    if correlation is not None:
        event["args"] = {"correlation": correlation}
    return event


def _launch(name, at, correlation):
    """A launch at ``at`` and its device record 5 us later."""
    return [_x("cuda_runtime", "cudaLaunchKernel", at, at + 2, correlation),
            _x("kernel", name, at + 5, at + 9, correlation)]


def _run(events):
    window = _x("user_annotation", "portbench.ticks", 100, 300)
    return SimpleNamespace(trace={"traceEvents": [window] + events},
                           traced_ticks=2)


FIELDS = [_x("user_annotation", "mass.planning.bfs", a, b)
          for a, b in ((90, 110), (120, 140), (200, 230), (260, 280),
                       (310, 330))]                  # 3 start in the window


@pytest.fixture(scope="module")
def read():
    return Bench(ROOT).reader(NAME)


def test_the_share_of_fields_that_launched_the_kernel(read):
    # the kernel in the fields at 120 and 200, another kernel in the one
    # at 260; launches between fields and past the window count nothing
    events = FIELDS + _launch(KERNEL, 125, 1) + _launch(KERNEL, 210, 2) \
        + _launch("void at::native::roll_cuda_kernel", 265, 3) \
        + _launch(KERNEL, 150, 4) + _launch(KERNEL, 315, 5)
    assert read(_run(events)) == pytest.approx(200.0 / 3)


def test_fields_without_the_kernel_read_zero(read):
    events = FIELDS + _launch("void at::native::where_kernel", 125, 1)
    assert read(_run(events)) == 0.0


def test_no_field_and_no_trace_read_nothing(read):
    assert read(_run(_launch(KERNEL, 125, 1))) is None
    assert read(SimpleNamespace(trace=None, traced_ticks=0)) is None


def test_the_share_is_declared_for_every_cell():
    bench = Bench(ROOT)
    entry = [m for m in bench.spec["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1 and entry[0]["unit"] == "%"
    assert entry[0]["workloads"] == [w["name"]
                                     for w in bench.spec["workloads"]]
