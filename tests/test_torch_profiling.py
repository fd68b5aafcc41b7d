"""mass_tpu_torch.utils.profiling held against the JAX package's:
``trace`` leaves one gzipped Chrome trace where JAX's capture leaves its
own and changes nothing it traces (the port's map bit for bit; against
JAX's map atol 1e-5, the voxel tolerance); a trace inside a trace raises
in both; ``block`` returns None on the counterparts of the same trees,
reaches every tensor of the port's, and makes no CUDA call on CPU trees.
The trace reader is held to a made-up device timeline exactly."""

import collections
import dataclasses
import glob
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mass_tpu.config import CameraConfig as JCamera
from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core import geometry as JG
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.maps import MapSet as JMapSet
from mass_tpu.maps import SemanticMap as JSemanticMap
from mass_tpu.parallel import make_mesh as jmake_mesh
from mass_tpu.parallel import shard_voxelmap as jshard_voxelmap
from mass_tpu.parallel.fleet import FleetMaps as JFleetMaps
from mass_tpu.utils import profiling as JP
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.maps import MapSet, SemanticMap
from mass_tpu_torch.parallel.fleet import FleetMaps
from mass_tpu_torch.parallel.sharding import ShardedVoxelMap
from mass_tpu_torch.utils import profiling as TP

GEO = dict(map_height=32, map_width=16, map_depth=4, feature_size=6,
           grid_resolution=0.2)
ORIGIN = (0.13, -0.4, 0.2)
CAM = 9


def _frame(seed):
    rng = np.random.RandomState(seed)
    return dict(
        depth=rng.uniform(0.05, 2.2, (CAM, CAM, 1)).astype(np.float32),
        classes=rng.randint(0, GEO["feature_size"],
                            (CAM, CAM)).astype(np.int32),
        pos=(np.asarray(ORIGIN) + rng.uniform(-0.3, 0.3, 3)).astype(
            np.float32),
        yaw=np.float32(rng.uniform(-np.pi, np.pi)),
        elev=np.float32(rng.uniform(-0.8, 0.2)))


def _rays():
    return np.asarray(JG.camera_rays(CAM, CAM, 7.0, 7.0))


def _torch_update(fr):
    vm = VoxelMap.create(MapGeometry(**GEO), ORIGIN, device="cpu")
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    vm.update_classes(t(_rays()), t(fr["pos"]), float(fr["yaw"]),
                      float(fr["elev"]), t(fr["depth"]), t(fr["classes"]))
    return vm


def _jax_update(fr):
    vm = JVoxelMap.create(JMapGeometry(**GEO), ORIGIN)
    vm = vm.update_classes(jnp.asarray(_rays()), jnp.asarray(fr["pos"]),
                           fr["yaw"], fr["elev"], jnp.asarray(fr["depth"]),
                           jnp.asarray(fr["classes"]))
    JP.block(vm)
    return vm


def _only_trace(logdir):
    found = glob.glob(os.path.join(str(logdir), "plugins", "profile", "*",
                                   "*.trace.json.gz"))
    assert len(found) == 1, found
    with gzip.open(found[0], "rt") as f:
        trace = json.load(f)
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    return found[0], trace


def test_trace_writes_one_chrome_trace_as_jax_does(tmp_path):
    fr = _frame(0)
    untraced = _torch_update(fr)
    with TP.trace(str(tmp_path / "torch"), device="cpu") as handle:
        assert handle.path is None and not handle.cuda
        traced = _torch_update(fr)
    with JP.trace(str(tmp_path / "jax")):
        jvm = _jax_update(fr)

    path, trace = _only_trace(tmp_path / "torch")
    assert handle.path == path
    _only_trace(tmp_path / "jax")
    ops = {e["name"] for e in trace["traceEvents"]
           if e.get("cat") == "cpu_op"}
    # the update's record sort and the plain splat's run cut
    assert {"aten::sort", "aten::nonzero"} <= ops, sorted(ops)
    assert TP.device_summary(trace)["device_events"] == 0
    assert torch.equal(traced.data, untraced.data)      # bit for bit
    assert traced.data.abs().max() > 0
    np.testing.assert_allclose(traced.grid().numpy(), np.asarray(jvm.grid()),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_trace_inside_a_trace_raises(package, tmp_path):
    def trace(name):
        logdir = str(tmp_path / name)
        return (JP.trace(logdir) if package == "jax"
                else TP.trace(logdir, device="cpu"))

    with pytest.raises(RuntimeError, match="already been started"):
        with trace("outer"):
            with trace("inner"):
                pass
    assert not glob.glob(str(tmp_path / "inner" / "**" / "*.gz"),
                         recursive=True)
    with trace("after"):           # the failed nesting left no profiler on
        pass
    _only_trace(tmp_path / "after")


@dataclasses.dataclass
class _Pair:
    a: object
    b: object


_Named = collections.namedtuple("_Named", "a b")


def _trees(kind):
    """The JAX package's tree of ``kind`` and the port's counterpart, with
    the port's tensors that ``block`` must reach."""
    rng = np.random.RandomState(3)
    arrays = [rng.rand(4, 3).astype(np.float32) for _ in range(4)]
    if kind == "containers":
        jtree = {"x": jnp.asarray(arrays[0]),
                 "y": [jnp.asarray(arrays[1]), (jnp.asarray(arrays[2]),)],
                 "z": _Named(jnp.asarray(arrays[3]), 1.0)}
        tensors = [torch.from_numpy(a) for a in arrays]
        ttree = {"x": tensors[0], "y": [tensors[1], (tensors[2],)],
                 "z": _Named(_Pair(tensors[3], "label"), 1.0)}
        return jtree, ttree, tensors
    if kind == "voxelmap":
        fr = _frame(1)
        vm = _torch_update(fr)
        return _jax_update(fr), vm, [vm.data, vm.bins_x]
    if kind == "sharded":
        jvm = jshard_voxelmap(JVoxelMap.create(JMapGeometry(**GEO), ORIGIN),
                              jmake_mesh((2,), ("map",)))
        vm = ShardedVoxelMap.create(MapGeometry(**GEO), ["cpu"] * 2, ORIGIN)
        return jvm, vm, list(vm.slab_data) + [vm.bins_z]
    if kind == "fleet":
        shape = dict(map_height=16, map_width=12, map_depth=4,
                     grid_resolution=0.25)
        fams = {"semantic0": 6, "occupancy": 1}
        jfleet = JFleetMaps(2, JCamera(height=10, width=10),
                            JMapGeometry(**shape), fams)
        fleet = FleetMaps(2, CameraConfig(height=10, width=10),
                          MapGeometry(**shape), fams, device="cpu")
        return jfleet, fleet, list(fleet.buffers.values()) + [fleet.bins_y]
    assert kind == "layers"
    cam = dict(height=CAM, width=CAM)
    geo = {k: v for k, v in GEO.items() if k != "feature_size"}
    jmaps = JMapSet(semantic0=JSemanticMap(JCamera(**cam), 6, **geo))
    maps = MapSet(semantic0=SemanticMap(CameraConfig(**cam), 6,
                                        device="cpu", **geo))
    layer = maps["semantic0"]
    return jmaps, maps, [layer.voxel_map.data, layer.rays]


@pytest.mark.parametrize("kind", ["containers", "voxelmap", "sharded",
                                  "fleet", "layers"])
def test_block_on_counterpart_trees(kind, monkeypatch):
    jtree, ttree, tensors = _trees(kind)
    assert JP.block(jtree) is None
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    assert TP.block(ttree) is None
    assert calls == []                   # CPU tensors: no CUDA call
    reached = {id(t) for t in TP._tensors(ttree)}
    assert all(id(t) in reached for t in tensors)


def _event(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


def test_device_summary_of_a_made_up_timeline():
    events = [
        _event("Trace", "PyTorch Profiler (0)", 100.0, 100.0),
        _event("user_annotation", "ProfilerStep#1", 100.0, 100.0),
        _event("cpu_op", "aten::sort", 100.0, 30.0),
        _event("cpu_op", "aten::item", 140.0, 45.0),
        _event("cuda_runtime", "cudaStreamSynchronize", 140.0, 40.0),
        _event("kernel", "void splat_onehot_kernel<1, 2, 1, 32, false>()",
               110.0, 20.0),
        _event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 125.0, 10.0),
        _event("kernel", "nms_kernel(float4 const*)", 180.0, 5.0),
        _event("kernel", "nms_kernel(float4 const*)", 190.0, 6.0),
        {"ph": "M", "name": "process_name", "pid": 1}]
    summary = TP.device_summary({"traceEvents": events}, top=2, gaps=2)
    assert summary["span_us"] == 100.0 and summary["busy_us"] == 36.0
    assert summary["busy_share"] == 0.36 and summary["device_events"] == 4
    assert [(t["name"], t["count"], t["total_us"]) for t in
            summary["top"]] == [
        ("void splat_onehot_kernel<1, 2, 1, 32, false>()", 1, 20.0),
        ("nms_kernel(float4 const*)", 2, 11.0)]
    # idle 135-180 (aten::item and the sync inside it overlap it by 40 us
    # each: the inner one is named), then 100-110 (aten::sort)
    assert [(g["start_us"], g["length_us"], g["host"]["name"])
            for g in summary["gaps"]] == [
        (35.0, 45.0, "cudaStreamSynchronize"), (0.0, 10.0, "aten::sort")]
    assert TP.kernel_durations({"traceEvents": events}, "nms_kernel") == \
        [5.0, 6.0]


def _call(cat, name, ts, correlation, dur=2.0):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                args={"correlation": correlation})


# made-up windows for the launch matcher: (events, launches, unrecorded,
# by_api, first unrecorded names)
_KERNEL = "void at::native::vectorized_elementwise_kernel<4>()"
_WINDOWS = {
    "complete": (
        [_call("cuda_runtime", "cudaLaunchKernel", 10.0, 1),
         _call("kernel", _KERNEL, 12.0, 1),
         _call("cuda_runtime", "cudaMemcpyAsync", 20.0, 2),
         _call("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 22.0, 2),
         _call("cuda_runtime", "cudaMemsetAsync", 30.0, 3),
         _call("gpu_memset", "Memset (Device)", 31.0, 3)],
        3, 0, {"cudaLaunchKernel": [1, 0], "cudaMemcpyAsync": [1, 0],
               "cudaMemsetAsync": [1, 0]}, []),
    "lost kernel": (
        [_call("cuda_runtime", "cudaLaunchKernel", 10.0, 1),
         _call("cuda_runtime", "cudaLaunchKernel", 20.0, 2),
         _call("kernel", _KERNEL, 22.0, 2)],
        2, 1, {"cudaLaunchKernel": [2, 1]}, ["cudaLaunchKernel"]),
    "lost copy": (
        [_call("cuda_runtime", "cudaLaunchKernel", 10.0, 1),
         _call("kernel", _KERNEL, 12.0, 1),
         _call("cuda_runtime", "cudaMemcpyAsync", 20.0, 2)],
        2, 1, {"cudaLaunchKernel": [1, 0], "cudaMemcpyAsync": [1, 1]},
        ["cudaMemcpyAsync"]),
    "lost cluster launch": (
        [_call("cuda_runtime", "cudaFuncSetAttribute", 9.0, 1),
         _call("cuda_runtime", "cudaLaunchKernelExC", 10.0, 2),
         _call("cuda_runtime", "cudaFuncSetAttribute", 19.0, 3),
         _call("cuda_runtime", "cudaLaunchKernelExC", 20.0, 4),
         _call("kernel", "nms_kernel(float4 const*)", 22.0, 4),
         _call("cuda_driver", "cuLaunchKernel", 30.0, 5),
         _call("kernel", "toy_kernel(float*)", 31.0, 5)],
        3, 1, {"cudaLaunchKernelExC": [2, 1], "cuLaunchKernel": [1, 0]},
        ["cudaLaunchKernelExC"]),
    "graph launch": (
        [_call("cuda_runtime", "cudaGraphLaunch", 10.0, 7),
         _call("kernel", _KERNEL, 12.0, 7),
         _call("kernel", "nms_kernel(float4 const*)", 13.0, 7),
         _call("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 14.0, 7)],
        1, 0, {"cudaGraphLaunch": [1, 0]}, []),
    "syncs left out": (
        [_call("cuda_runtime", "cudaFuncSetAttribute", 9.0, 1),
         _call("cuda_runtime", "cudaStreamSynchronize", 10.0, 2),
         _call("cuda_runtime", "cudaDeviceSynchronize", 11.0, 3),
         _call("cuda_runtime", "cudaEventRecord", 12.0, 4),
         _call("cuda_runtime", "cudaStreamIsCapturing", 13.0, 5),
         _call("cuda_runtime", "cudaLaunchKernel_ptsz", 20.0, 6),
         _call("kernel", _KERNEL, 21.0, 6)],
        1, 0, {"cudaLaunchKernel_ptsz": [1, 0]}, []),
}


@pytest.mark.parametrize("window", sorted(_WINDOWS))
def test_unrecorded_launches_of_made_up_windows(window):
    """Every host call that puts work on the card is matched to its device
    record by correlation: a kernel, a copy, a memset; a graph launch's
    nodes count once; synchronisations, event records and
    cudaFuncSetAttribute are no launch."""
    events, launches, unrecorded, by_api, names = _WINDOWS[window]
    trace = {"traceEvents": [
        _event("Trace", "PyTorch Profiler (0)", 5.0, 40.0),
        _event("user_annotation", "ProfilerStep#1", 5.0, 40.0),
        _event("cpu_op", "aten::fill_", 19.0, 5.0)] + events
        + [{"ph": "M", "name": "process_name", "pid": 1},
           {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 12.0}]}
    got = TP.unrecorded_launches(trace)
    assert (got["launches"], got["unrecorded"]) == (launches, unrecorded)
    assert got["by_api"] == by_api and got["unlisted"] == []
    assert [e["name"] for e in got["first_unrecorded"]] == names
    for e in got["first_unrecorded"]:
        # the lost call at 20 us lies inside aten::fill_ (19-24 us); the
        # one at 10 us inside no op; ts from the trace's start (5 us)
        assert e["op"] == ("aten::fill_" if e["ts_us"] == 15.0 else None)
    summary = TP.device_summary(trace)
    assert (summary["launches"], summary["unrecorded_launches"]) == \
        (launches, unrecorded)


def test_unrecorded_launches_names_unlisted_calls():
    """A host call outside LAUNCH_APIS that left a device record is
    named, so a missing API name shows."""
    trace = {"traceEvents": [
        _call("cuda_runtime", "cudaLaunchHostFunc", 10.0, 1),
        _call("cuda_runtime", "cudaMemcpy3DAsync", 20.0, 2),
        _call("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 21.0, 2)]}
    got = TP.unrecorded_launches(trace)
    assert (got["launches"], got["unrecorded"]) == (0, 0)
    assert got["unlisted"] == ["cudaMemcpy3DAsync"]


def test_device_summary_reports_lost_launches():
    """``device_summary`` carries the window's launches and those without
    a device record beside its busy share, which lacks their time."""
    trace = {"traceEvents": [
        _event("Trace", "PyTorch Profiler (0)", 0.0, 100.0),
        _call("cuda_runtime", "cudaLaunchKernel", 10.0, 1),
        _call("cuda_runtime", "cudaLaunchKernel", 20.0, 2),
        _call("kernel", _KERNEL, 22.0, 2, dur=30.0),
        _call("cuda_runtime", "cudaMemcpyAsync", 60.0, 3)]}
    summary = TP.device_summary(trace)
    assert summary["busy_share"] == 0.3
    assert (summary["launches"], summary["unrecorded_launches"]) == (3, 2)


def test_cpu_trace_matches_no_launch(tmp_path):
    """A CPU trace records no launch: 0 launches, nothing raised; the
    handle holds the parsed trace, equal to the file's."""
    fr = _frame(0)
    with TP.trace(str(tmp_path), device="cpu") as handle:
        _torch_update(fr)
    path, trace = _only_trace(tmp_path)
    assert (handle.launches, handle.unrecorded) == (0, 0)
    assert handle.matched["first_unrecorded"] == []
    assert handle.data == trace and handle.path == path
    assert handle.export_s > 0 and handle.parse_s > 0 and handle.check_s > 0


def test_trace_refuses_a_window_that_lost_a_launch(tmp_path, monkeypatch):
    """Where the matcher finds a launch without its device record,
    ``trace`` raises IncompleteTrace (a RuntimeError) naming the counts
    and the first lost call, and leaves the file for inspection."""
    lost = dict(launches=40, unrecorded=3, by_api={},
                first_unrecorded=[dict(name="cudaLaunchKernelExC",
                                       ts_us=12.5, position=1, op=None)],
                unlisted=[])
    monkeypatch.setattr(TP, "unrecorded_launches", lambda trace: lost)
    with pytest.raises(TP.IncompleteTrace,
                       match=r"3 of 40 launches .* cudaLaunchKernelExC at "
                             r"12\.5 us") as raised:
        with TP.trace(str(tmp_path), device="cpu"):
            _torch_update(_frame(0))
    assert isinstance(raised.value, RuntimeError)
    handle = raised.value.handle
    assert (handle.launches, handle.unrecorded) == (40, 3)
    path, _ = _only_trace(tmp_path)
    assert handle.path == path


@pytest.mark.parametrize("failures", [0, 1, 2, 3])
def test_retried_runs_an_incomplete_window_again(failures):
    """``retried`` re-runs a window that raised IncompleteTrace, three
    tries in all; the third failure propagates."""
    tries = []

    def window():
        tries.append(1)
        if len(tries) <= failures:
            raise TP.IncompleteTrace(TP.Trace(
                "logdir", cuda=True, path="t.json.gz", launches=2,
                unrecorded=1, matched=dict(first_unrecorded=[])))
        return "handle"

    if failures < TP.TRACE_TRIES:
        assert TP.retried(window) == ("handle", failures + 1)
    else:
        with pytest.raises(TP.IncompleteTrace, match="1 of 2 launches"):
            TP.retried(window)
    assert len(tries) == min(failures + 1, TP.TRACE_TRIES)


def test_retried_lets_other_errors_through():
    def window():
        raise RuntimeError("CUDA activity was asked for and the profiler "
                           "recorded none")

    with pytest.raises(RuntimeError, match="recorded none"):
        TP.retried(window)


def test_device_summary_reads_the_window_annotation():
    """Where the trace holds ``trace``'s window annotation, the summary's
    span is the annotation's, not the profiler's (which includes the
    pauses at each end), and the annotation is no host operation of a
    gap."""
    trace = {"traceEvents": [
        _event("Trace", "PyTorch Profiler (0)", 0.0, 200.0),
        _event("user_annotation", TP.WINDOW, 50.0, 100.0),
        _call("cuda_runtime", "cudaLaunchKernel", 60.0, 1),
        _call("kernel", _KERNEL, 70.0, 1, dur=25.0)]}
    summary = TP.device_summary(trace, gaps=1)
    assert summary["span_us"] == 100.0 and summary["busy_share"] == 0.25
    assert summary["gaps"] == [dict(start_us=45.0, length_us=55.0,
                                    host=None, span=None)]
    with_trace = TP.device_summary({"traceEvents": trace["traceEvents"][:1]
                                    + trace["traceEvents"][2:]})
    assert with_trace["span_us"] == 200.0


def test_cpu_trace_annotates_its_window(tmp_path):
    """The traced block runs inside one window annotation, which holds
    the block's host operations."""
    with TP.trace(str(tmp_path), device="cpu") as handle:
        _torch_update(_frame(0))
    windows = [e for e in handle.data["traceEvents"]
               if e.get("name") == TP.WINDOW]
    assert len(windows) == 1 and windows[0]["cat"] == "user_annotation"
    lo, hi = windows[0]["ts"], windows[0]["ts"] + windows[0]["dur"]
    sorts = [e for e in handle.data["traceEvents"]
             if e.get("name") == "aten::sort"]
    assert sorts and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                         for e in sorts)
    # (hi - lo in float64 against the file's rounded dur)
    assert TP.device_summary(handle.data)["span_us"] == \
        pytest.approx(windows[0]["dur"], abs=1e-3)
