"""The port's spans (``utils/profiling.span``) and the trace's clock.

A small fleet tick on the CPU (a two-episode learned sensor call, one
batched map update, one refreshing batched plan and its copy to the
host) traced by ``utils/profiling.trace`` holds every ``mass.*`` span
where the work happens, each BFS convergence check nested in its field,
one check per 8 hops; untraced, no span enters ``record_function``, and
the tick's outputs are the same bit for bit.  ``align_clock`` puts each
card's device records of made-up traces back on the host's clock, off by
a constant or drifting."""

import copy
import glob
import gzip
import json
import math
import os

import numpy as np
import pytest
import torch

from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.nav import grid as NG
from mass_tpu_torch.parallel.fleet import FleetMaps
from mass_tpu_torch.perception import maskrcnn as TM
from mass_tpu_torch.perception.segmentation import (DetectorSegmentation,
                                                    make_batched_sensor)
from mass_tpu_torch.utils import profiling as TP
from tests import torch_checkpoints as TC

CAM = 48
CLASSES = 7
GEO = MapGeometry(map_height=40, map_width=40, map_depth=12,
                  grid_resolution=0.125)
STEP = 2
SPANS = {
    "mass.sensor.upload", "mass.sensor.network", "mass.sensor.proposals",
    "mass.sensor.heads", "mass.sensor.paste", "mass.sensor.fuse",
    "mass.sensor.to_host", "mass.mapping.upload", "mass.mapping.records",
    "mass.mapping.splat", "mass.planning.refresh", "mass.planning.snap",
    "mass.planning.bfs", "mass.planning.bfs_check", "mass.planning.to_host"}


@pytest.fixture(scope="module")
def sensor():
    cfg = TM.MaskRCNNConfig(num_classes=CLASSES, image_size=CAM,
                            pre_nms_topk=64, post_nms_topk=32,
                            candidate_pool=64, max_detections=8)
    model = TM.from_state_dict(TC.random_maskrcnn_state_dict(0, CLASSES),
                               cfg, "cpu")
    return make_batched_sensor(DetectorSegmentation(
        TM.make_detector(model), 0.1, CLASSES))


def _tick(sensor):
    """One fleet tick of two episodes from fresh maps: (class images, the
    maps, the plan's host arrays)."""
    rng = np.random.RandomState(4)
    fleet = FleetMaps(2, CameraConfig(height=CAM, width=CAM), GEO,
                      {"semantic0": CLASSES, "semantic1": CLASSES},
                      device="cpu")
    for e in range(2):
        fleet.reset(e, (0.1 * e, 0.0, 0.0))
    rgb = rng.rand(2, CAM, CAM, 3).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (2, CAM, CAM, 1)).astype(np.float32)
    position = np.asarray([[0.2, -0.1, 0.9], [-0.3, 0.2, 0.9]], np.float32)
    yaw = np.asarray([0.3, -1.2], np.float32)
    elevation = np.asarray([-0.2, 0.1], np.float32)
    classes = sensor(rgb)[..., 0]
    fleet.update_batch(position, yaw, elevation, depth,
                       {"semantic0": classes, "semantic1": classes},
                       active={"semantic0": np.asarray([True, False]),
                               "semantic1": np.asarray([False, True])})
    views = [fleet.view("semantic0", e) for e in range(2)]
    grids = NG.stack_grids([NG.build_nav_grid(
        NG.navigable_area(vm, 1, 0, 6), 0, 0, step=STEP) for vm in views])
    goals = torch.tensor([[2.0, 1.5], [-2.0, -1.0]])
    plan = NG.plan_batch(grids, views, torch.from_numpy(position), goals,
                         step=STEP, padding=1, z_start=0, z_stop=6,
                         threshold=0.0, refresh=True)
    host = NG.plan_to_host(*plan[:4])
    return classes, {k: v.clone() for k, v in fleet.buffers.items()}, host


@pytest.fixture(scope="module")
def traced(sensor, tmp_path_factory):
    with TP.trace(str(tmp_path_factory.mktemp("spans")),
                  device="cpu") as handle:
        out = _tick(sensor)
    return handle, out


def _spans(data, name=None):
    return [e for e in data["traceEvents"]
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(name or TP.SPAN_PREFIX)]


def test_a_traced_fleet_tick_holds_every_span(traced):
    handle, _ = traced
    names = {e["name"] for e in _spans(handle.data)}
    assert names == SPANS
    fields = [(e["ts"], e["ts"] + e["dur"])
              for e in _spans(handle.data, "mass.planning.bfs")
              if e["name"] == "mass.planning.bfs"]
    checks = _spans(handle.data, "mass.planning.bfs_check")
    assert checks and all(
        any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in fields)
        for e in checks)


def test_bfs_check_spans_count_the_convergence_checks(traced):
    """A field whose farthest reachable node lies D hops out takes the
    first check after 1 + 8(c - 1) >= D hops, the one that finds nothing
    changed: c checks, 8c + 1 hops."""
    handle, (_, _, host) = traced
    dist = host[0]
    far = int(dist[dist < NG.INF].max())
    checks = max(1, math.ceil((far - 1) / 8) + 1)
    assert checks >= 2
    assert len(_spans(handle.data, "mass.planning.bfs_check")) == checks


def test_untraced_spans_enter_no_record_function(sensor, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while untraced")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _tick(sensor)
    with TP.span("mass.mapping.splat"):
        pass


def test_a_traced_tick_equals_an_untraced_one(sensor, traced):
    _, (classes, maps, host) = traced
    want_classes, want_maps, want_host = _tick(sensor)
    assert np.array_equal(classes, want_classes)
    for name in want_maps:
        assert torch.equal(maps[name], want_maps[name]), name
        assert maps[name].abs().max() > 0
    for got, want in zip(host, want_host):
        assert np.array_equal(got, want)


def test_stage_timer_stages_leave_a_span(tmp_path):
    timer = TP.StageTimer()
    with TP.trace(str(tmp_path), device="cpu") as handle:
        with timer.stage("mapping"):
            torch.ones(3).sum()
    names = [e["name"] for e in _spans(handle.data)]
    assert names == ["mass.stage.mapping"]
    assert timer.summary()["mapping"]["count"] == 1


def test_device_summary_names_the_innermost_span_of_a_gap():
    events = [
        dict(ph="X", cat="Trace", name="PyTorch Profiler (0)", ts=0.0,
             dur=100.0),
        dict(ph="X", cat="user_annotation", name="mass.planning.bfs",
             ts=10.0, dur=80.0),
        dict(ph="X", cat="user_annotation", name="mass.planning.bfs_check",
             ts=40.0, dur=30.0),
        dict(ph="X", cat="cpu_op", name="aten::item", ts=41.0, dur=28.0),
        dict(ph="X", cat="kernel", name="k", ts=0.0, dur=40.0),
        dict(ph="X", cat="kernel", name="k", ts=70.0, dur=30.0)]
    gap, = TP.device_summary({"traceEvents": events}, gaps=1)["gaps"]
    assert (gap["start_us"], gap["length_us"]) == (40.0, 30.0)
    assert gap["span"]["name"] == "mass.planning.bfs_check"
    assert gap["host"]["name"] == "aten::item"


# ------------------------------------------------------------ the clock

def _timeline(late_us=0.0, card=0, first_corr=1):
    """Three launches on one stream and a stream synchronisation, the
    records 5 us after their launches and the sync returning 3 us after
    the last one ends, the card's records ``late_us`` off the host's."""
    host, device = [], []
    for k in range(3):
        corr = first_corr + k
        ts = 100.0 + 20.0 * k
        host.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                         ts=ts, dur=4.0, tid=card + 1,
                         args={"correlation": corr}))
        device.append(dict(ph="X", cat="kernel", name="k", pid=card, tid=7,
                           ts=ts + 5.0 + late_us, dur=30.0,
                           args={"device": card, "stream": 7,
                                 "correlation": corr}))
        device.append(dict(ph="f", cat="ac2g", name="ac2g", id=corr,
                           pid=card, tid=7, ts=ts + 5.0 + late_us, bp="e"))
    # the last record ends at 140 + 5 + 30 = 175; the sync returns at 178
    host.append(dict(ph="X", cat="cuda_runtime",
                     name="cudaStreamSynchronize", ts=150.0, dur=28.0,
                     tid=card + 1, args={"correlation": first_corr + 3}))
    return host + device


def _bounds(trace):
    """Each card's bounds on a constant offset, the trace left as it is."""
    return TP.align_clock(copy.deepcopy(trace))


def _held(trace):
    """Every card's bounds admit the trace as it stands."""
    bounds = _bounds(trace)
    return bool(bounds) and all(b["lo_us"] <= 0 <= b["hi_us"]
                                for b in bounds.values())


def test_a_consistent_trace_is_left_unchanged():
    trace = {"traceEvents": _timeline()}
    before = copy.deepcopy(trace["traceEvents"])
    clock = TP.align_clock(trace)
    assert trace["traceEvents"] == before
    assert clock[0]["lo_us"] == -5.0 and clock[0]["hi_us"] == 3.0
    assert clock[0]["shift_us"] == 0.0 and clock[0]["drift_ppm"] == 0.0
    assert clock[0]["consistent"]
    assert (clock[0]["launches"], clock[0]["syncs"]) == (3, 1)
    assert trace[TP.CLOCK_KEY]["0"]["shift_us"] == 0.0


@pytest.mark.parametrize("late_us, shift_us", [(-3000.0, 2995.0),
                                               (3000.0, -2997.0)])
def test_records_off_the_host_clock_are_shifted_back(late_us, shift_us):
    """Records 3 ms early move to the interval's lower end (each starts
    no earlier than its launch); 3 ms late, to its upper end (the sync
    returns no earlier than the work it waited for), 1 ns inside; a
    second card that agrees is left as it is."""
    trace = {"traceEvents": _timeline(late_us)
             + _timeline(card=1, first_corr=11)}
    other = [copy.deepcopy(e) for e in trace["traceEvents"]
             if e.get("pid") == 1]
    assert not _held(trace)
    clock = TP.align_clock(trace)
    assert clock[0]["shift_us"] == pytest.approx(
        shift_us + np.sign(shift_us) * 1e-3, abs=1e-6)
    assert clock[0]["drift_ppm"] == 0.0 and clock[1]["shift_us"] == 0.0
    assert trace[TP.CLOCK_KEY]["0"]["lo_us"] == -5.0 - late_us
    assert _held(trace)
    assert [e for e in trace["traceEvents"] if e.get("pid") == 1] == other
    flows = [e["ts"] for e in trace["traceEvents"]
             if e.get("ph") == "f" and e["pid"] == 0]
    kernels = [e["ts"] for e in trace["traceEvents"]
               if e.get("cat") == "kernel" and e["pid"] == 0]
    assert flows == kernels


@pytest.mark.parametrize("ppm", [-4000.0, 40.0, 4000.0])
def test_a_card_clock_that_drifts_is_put_back_on_a_line(ppm):
    """A card's clock that runs ``ppm`` millionths off the host's over a
    second (each record 5 us after its launch, each sync returning 3 us
    after the work ends) crosses every constant offset; a line of offsets
    puts every record back, the drift read to a thousandth of a ppm."""
    events = []
    for k in range(50):
        t = 20_000.0 * k
        block = _timeline(first_corr=10 * k)
        for e in block:
            e["ts"] += t
            if e.get("cat") in ("kernel", "ac2g"):
                e["ts"] += ppm * 1e-6 * (t - 500_000.0)
        events += block
    trace = {"traceEvents": events}
    bounds = _bounds(trace)[0]
    assert bounds["lo_us"] > bounds["hi_us"]
    clock = TP.align_clock(trace)
    assert clock[0]["consistent"]
    # records at d = h + ppm (h - c) back at h: d - h = ppm (d - c) / (1 + ppm)
    assert clock[0]["drift_ppm"] == pytest.approx(-ppm / (1 + ppm * 1e-6),
                                                  abs=1e-3)
    assert _held(trace)


def test_a_trace_that_no_line_puts_back_is_left_as_it_is():
    """A sync that returns 10 us before the work it waited for ends, and
    that work's record 5 us after its launch: every line of offsets is
    crossed at that record, so nothing moves, and a warning says so."""
    events = _timeline()
    events[3]["dur"] = 15.0                  # returns at 165; work ends 175
    trace = {"traceEvents": events}
    before = copy.deepcopy(events)
    with pytest.warns(UserWarning, match="left as they are"):
        clock = TP.align_clock(trace)
    assert trace["traceEvents"] == before
    assert (clock[0]["lo_us"], clock[0]["hi_us"]) == (-5.0, -10.0)
    assert not clock[0]["consistent"]
    assert clock[0]["shift_us"] == 0.0 and clock[0]["drift_ppm"] == 0.0
    assert trace[TP.CLOCK_KEY]["0"]["consistent"] is False


def test_device_synchronize_and_blocking_copies_bound_the_clock():
    """A device synchronisation waits for every stream of its card; a
    synchronous copy to the host for its own record."""
    events = _timeline()[:3] + _timeline()[4:]       # no stream sync
    events += [
        dict(ph="X", cat="kernel", name="k2", pid=0, tid=9, ts=150.0,
             dur=60.0, args={"device": 0, "stream": 9, "correlation": 5}),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=145.0,
             dur=3.0, tid=2, args={"correlation": 5}),
        dict(ph="X", cat="cuda_runtime", name="cudaDeviceSynchronize",
             ts=190.0, dur=22.0, tid=1, args={"correlation": 6})]
    assert _bounds({"traceEvents": events})[0]["hi_us"] == 2.0
    copy_events = _timeline()[:3] + [
        dict(ph="X", cat="cuda_runtime", name="cudaMemcpy", ts=200.0,
             dur=50.0, tid=1, args={"correlation": 7}),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH (Device -> "
             "Pageable)", pid=0, tid=7, ts=230.0, dur=19.0,
             args={"device": 0, "stream": 7, "correlation": 7})]
    bounds = _bounds({"traceEvents": copy_events})[0]
    assert (bounds["hi_us"], bounds["syncs"]) == (1.0, 1)


def test_trace_writes_the_shifted_records_it_returns(tmp_path, monkeypatch):
    """Where a card's records move, the written file holds the trace as
    ``trace`` returns it, clock and all."""
    monkeypatch.setattr(TP, "_clock_points", lambda trace: {0: dict(
        lower=np.asarray([[10.0, 3000.0]]),
        upper=np.asarray([[10.0, 3010.0]]))})
    with TP.trace(str(tmp_path), device="cpu") as handle:
        torch.ones(3).sum()
    assert handle.clock[0]["shift_us"] == pytest.approx(3000.001)
    path, = glob.glob(os.path.join(str(tmp_path), "plugins", "profile", "*",
                                   "*.trace.json.gz"))
    with gzip.open(path, "rt") as f:
        written = json.load(f)
    assert written == handle.data
    assert written[TP.CLOCK_KEY]["0"]["shift_us"] == \
        handle.clock[0]["shift_us"]
