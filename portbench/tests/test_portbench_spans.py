"""The readers of the program's spans on a made-up trace with known
answers: idle stretches inside and outside spans, a gap across two parts
of a layer, overlapping copy spans, spans and device work across the
window's edges; and no value from a program that opens no span."""

import os
from types import SimpleNamespace

import pytest

from portbench.bench import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAMES = ("planning.wait_ms", "sensor.idle_ms", "mapping.idle_ms",
         "planning.idle_ms", "transfer.idle_ms", "unspanned.idle_ms")


def _x(cat, name, ts, end):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=end - ts)


def _span(name, ts, end):
    return _x("user_annotation", name, ts, end)


# two ticks in 100-300 us; the card idles 120-150, 160-200 and 210-290
# (150 us), its first and last kernels cross the window's edges
KERNELS = [_x("kernel", "k", a, b)
           for a, b in ((90, 120), (150, 160), (200, 210), (290, 320))]
SPANS = [
    _span("mass.planning.snap", 80, 105),          # from before the window
    _span("mass.sensor.upload", 110, 130),
    _span("mass.sensor.to_host", 125, 135),        # overlaps the upload
    _span("mass.sensor.network", 130, 170),        # 120-150 across parts
    _span("mass.mapping.upload", 175, 185),
    _span("mass.mapping.splat", 185, 195),
    _span("mass.planning.bfs", 215, 260),
    _span("mass.planning.bfs_check", 220, 240),
    _span("mass.planning.bfs_check", 245, 255),
    _span("mass.planning.to_host", 250, 270),      # overlaps a check
    _span("mass.planning.bfs_check", 295, 305)]    # past the window's end
# ms a tick: idle inside each union, and host time for the waits
WANT = {
    "planning.wait_ms": 0.025,             # 220-240, 245-270, 295-300
    "sensor.idle_ms": 0.020,               # 120-150, 160-170
    "mapping.idle_ms": 0.010,              # 175-195
    "planning.idle_ms": 0.0275,            # 215-270
    "transfer.idle_ms": 0.0225,            # 120-135, 175-185, 250-270
    "unspanned.idle_ms": 0.0175}           # 170-175, 195-200, 210-215,
#                                            270-290


def _run(events):
    window = _span("portbench.ticks", 100, 300)
    return SimpleNamespace(trace={"traceEvents": [window] + events},
                           traced_ticks=2)


@pytest.fixture(scope="module")
def readers():
    bench = Bench(ROOT)
    return {name: bench.reader(name) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_on_a_made_up_trace(readers, name):
    assert readers[name](_run(KERNELS + SPANS)) == pytest.approx(
        WANT[name], abs=1e-12)


def test_the_layers_and_the_rest_split_the_idle_time(readers):
    run = _run(KERNELS + SPANS)
    parts = sum(readers[f"{layer}.idle_ms"](run) for layer in (
        "sensor", "mapping", "planning", "unspanned"))
    assert parts == pytest.approx(150 * 1e-3 / 2, abs=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_no_span_and_no_trace_read_nothing(readers, name):
    other = [_span("portbench.planning", 210, 290)]
    assert readers[name](_run(KERNELS + other)) is None
    assert readers[name](SimpleNamespace(trace=None, traced_ticks=0)) \
        is None


def test_every_reader_is_declared_for_its_cells():
    bench = Bench(ROOT)
    cells = {m["name"]: m["workloads"] for m in bench.spec["per_layer"]}
    learned = ["learned-384.fleet8"]
    for name in NAMES:
        assert cells[name] == (learned if name == "sensor.idle_ms" else
                               learned + ["semantic-384.fleet8",
                                          "features-384.fleet2"])
