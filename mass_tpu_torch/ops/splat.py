"""The one-hot splat kernels for Hopper and their plain PyTorch versions.

Replaces the three TPU kernels of ``mass_tpu/ops/pallas_splat.py``:

- ``splat_onehot_cmajor`` -> :func:`apply_records` (``csrc/splat_onehot.cu``,
  M = 1): one frame's corner records (``ops/scatter.corner_contributions``)
  into one voxel-major ``[V, F]`` map;
- ``splat_onehot_multi_cmajor`` -> :func:`apply_records_multi` (the same
  kernel body, M = 2..4): the same frame into two to four maps of one
  grid, each with its own classes and EMA weight;
- ``splat_onehot_frames_cmajor`` -> :func:`apply_frame_records` (the same
  kernel body with frame sub-runs): T frames folded into one map in
  order, equal to T single-map updates in a row.

Every map updates in place by the same rule::

    W_v = sum w,  S2_v = sum w^2,  T_v[f] = sum w^2 [class == f]
    row_v = row_v * (1 - iw * S2_v / W_v) + (iw / W_v) * T_v

Preparation is plain PyTorch: a stable int32 sort of the records by
voxel id and gathers (:func:`sorted_records`, once per frame for all
maps of a group; :func:`sorted_frame_records` for T frames flattened
frame-major, which also gives each record its frame).  The kernel finds
the runs of equal ids, and inside them the frames' sub-runs, itself, so
nothing syncs with the host between the sort and the launch.  The
kernels sum each run in sorted order, so an update is deterministic (no
float atomics) and equals its plain version on the CPU bit for bit.

Dense per-pixel features (the backbone embeddings of ``FeatureMap`` and
``ClipMap``) go through a fourth kernel, which replaces no TPU kernel but
the JAX package's XLA scatter ``ops/scatter.apply_dense_rows``:
:func:`apply_dense_records` (``csrc/splat_dense.cu``) folds one frame's
sorted records, each carrying its pixel, into a ``[V, F]`` map by the
same rule with ``T_v = sum w^2 feat[pixel]``, touching only the runs'
rows (:func:`sorted_dense_records`, :func:`splat_dense_reference`).

The kernels are built with ``nvcc`` for ``sm_90a`` into ``build/kernels/``
at first use (one library per source, all at once, :func:`build`) and
bound with ctypes.  A wrapper launches its kernel for CUDA maps, counts
the launch (``LAUNCHES``, ``MULTI_LAUNCHES``, ``FRAMES_LAUNCHES``,
``DENSE_LAUNCHES``), and takes the plain version only for maps that lie
on the CPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
# every CUDA source of the port: the splat kernels', the detector's
# greedy NMS (ops/detection.py) and the planner's BFS field (nav/grid.py),
# built together
LIBRARIES = ("splat_onehot", "splat_dense", "nms", "bfs")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
MAX_MAPS = 4
# the largest grid whose discard id V fits the kernel's int32 ids, and
# the most records one launch takes
MAX_VOXELS = 2**31 - 1
MAX_RECORDS = 2**31 - 1

# kernel launches made by the wrappers (read by chip_smoke.py to show
# the main path went through each kernel)
LAUNCHES = 0          # apply_records
MULTI_LAUNCHES = 0    # apply_records_multi
FRAMES_LAUNCHES = 0   # apply_frame_records
DENSE_LAUNCHES = 0    # apply_dense_records

_libs: Dict[str, ctypes.CDLL] = {}


class Records(NamedTuple):
    """One frame's records, stable-sorted by voxel id.

    ``ids [R]`` (int32, nondecreasing) are the voxel ids, ``weights [R]``
    (float32) the trilinear weights and ``classes`` (int32) the classes,
    ``[R]`` for one map or ``[M, R]`` for a group of M maps.  Records with
    the discard id ``V`` (invalid pixels), or any id outside ``[0, V)``,
    are skipped.
    """

    ids: torch.Tensor
    weights: torch.Tensor
    classes: torch.Tensor


class FrameRecords(NamedTuple):
    """T frames' records in one stream, stable-sorted by voxel id.

    ``ids``, ``weights`` and ``classes`` are ``[R]`` as in
    :class:`Records`; ``frames [R]`` (int32) is each record's frame,
    nondecreasing inside every voxel's run.
    """

    ids: torch.Tensor
    weights: torch.Tensor
    classes: torch.Tensor
    frames: torch.Tensor


class DenseRecords(NamedTuple):
    """One frame's dense-feature records, stable-sorted by voxel id:
    ``ids [R]`` (int32, nondecreasing), ``weights [R]`` (float32) and
    ``pixels [R]`` (int32), each record's row of the ``[P, F]`` feature
    image.  Ids outside ``[0, V)`` (the discard id ``V``) are skipped."""

    ids: torch.Tensor
    weights: torch.Tensor
    pixels: torch.Tensor


def _cut(keys_sorted: torch.Tensor):
    """Unique keys of a sorted stream and the ``[K + 1]`` range starts:
    a range starts wherever the key differs from the one before it."""
    n = keys_sorted.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=keys_sorted.device)
    new[1:] = keys_sorted[1:] != keys_sorted[:-1]
    first = new.nonzero().squeeze(1)
    return keys_sorted[first], torch.cat([first, first.new_full((1,), n)])


def sort_ids(ids: torch.Tensor):
    """Stable sort of voxel ids as int32 (ties keep record order):
    ``(sorted ids, order)``."""
    return torch.sort(ids.to(torch.int32), stable=True)


def gather_records(ids_sorted: torch.Tensor, order: torch.Tensor,
                   weights: torch.Tensor,
                   classes: Sequence[torch.Tensor]) -> Records:
    """The records in sorted order: weights, and each map's ``[N]``
    class image gathered into ``classes [M, R]`` (record ``k`` is pixel
    ``k % N``)."""
    cls = torch.stack([c.reshape(-1).to(torch.int32) for c in classes])
    return Records(ids=ids_sorted,
                   weights=weights[order].to(torch.float32).contiguous(),
                   classes=cls.index_select(1, order % cls.shape[1]))


def sorted_records_multi(ids: torch.Tensor, weights: torch.Tensor,
                         classes: Sequence[torch.Tensor]) -> Records:
    """Stable-sort ``[8N]`` corner records by voxel id once for a group
    of maps (ids narrowed to int32: every id, the discard id included,
    must be below ``2**31``)."""
    return gather_records(*sort_ids(ids), weights, classes)


def sorted_records(ids: torch.Tensor, weights: torch.Tensor,
                   classes: torch.Tensor) -> Records:
    """:func:`sorted_records_multi` for one map: ``classes`` is ``[N]``
    and the records' classes ``[R]``."""
    records = sorted_records_multi(ids, weights, [classes])
    return records._replace(classes=records.classes[0])


def gather_frame_records(ids_sorted: torch.Tensor, order: torch.Tensor,
                         weights: torch.Tensor,
                         classes: torch.Tensor) -> FrameRecords:
    """T frames' records in the sorted order of their flattened
    ``[T * 8N]`` records: weights, classes (record ``t * 8N + j`` has
    ``classes[t, j % N]``, ``classes [T, N]``) and frames ``order //
    8N``."""
    num_frames = classes.shape[0]
    per_frame = order.shape[0] // num_frames
    pixels = classes.shape[-1]
    frames = order // per_frame
    cls = classes.reshape(-1).to(torch.int32)
    return FrameRecords(
        ids=ids_sorted,
        weights=weights.reshape(-1).index_select(0, order).to(
            torch.float32).contiguous(),
        classes=cls.index_select(0, (order % pixels).add_(frames,
                                                          alpha=pixels)),
        frames=frames.to(torch.int32))


def sorted_dense_records(ids: torch.Tensor, weights: torch.Tensor,
                         num_pixels: int) -> DenseRecords:
    """Stable-sort ``[8N]`` corner-major records by voxel id (int32); a
    record's pixel is its original position modulo ``num_pixels`` (N for
    one frame, B*N for a fleet's corner-major batch)."""
    ids_sorted, order = sort_ids(ids)
    return DenseRecords(
        ids=ids_sorted,
        weights=weights.reshape(-1)[order].to(torch.float32).contiguous(),
        pixels=(order % num_pixels).to(torch.int32))


def sorted_frame_records(ids: torch.Tensor, weights: torch.Tensor,
                         classes: torch.Tensor) -> FrameRecords:
    """Records of T frames (``ids``/``weights [T, 8N]``, ``classes
    [T, N]``) flattened frame-major and stable-sorted by voxel id (int32),
    so within a voxel they stay in frame order, then record order."""
    return gather_frame_records(*sort_ids(ids.reshape(-1)), weights,
                                classes.reshape(ids.shape[0], -1))


def rebase_records(records, first: int, device):
    """``records`` (:class:`Records`, :class:`FrameRecords` or
    :class:`DenseRecords`) for a slab of a map that starts at voxel
    ``first``, on ``device``: the ids less ``first``.  The ids stay in
    order; those below the slab go negative and those past it reach the
    slab's end or beyond, and the kernels and plain versions skip both.
    Nothing is copied for ``first`` 0 on the records' own device."""
    if first:
        records = records._replace(ids=records.ids - first)
    return type(records)(*(t.to(device) for t in records))


# ----------------------------------------------------------------------
# plain versions: the kernels' sums in the same order (index_add_ on the
# CPU adds in index order) and the same float32 blend
# ----------------------------------------------------------------------

def _record_sums(starts: torch.Tensor, w: torch.Tensor):
    """(run of each record, W, S2, w^2) of sorted records cut at
    ``starts [U + 1]``."""
    n_runs = starts.shape[0] - 1
    run_of = torch.repeat_interleave(
        torch.arange(n_runs, device=w.device), starts[1:] - starts[:-1])
    w2 = w * w
    w_sum = w.new_zeros(n_runs).index_add_(0, run_of, w)
    s2_sum = w.new_zeros(n_runs).index_add_(0, run_of, w2)
    return run_of, w_sum, s2_sum, w2


def _class_sums(run_of, n_runs: int, w2, classes,
                num_features: int) -> torch.Tensor:
    """``T [U, F]``; classes outside ``[0, F)`` are dropped, as the
    kernels drop them."""
    cls = classes.to(torch.int64)
    ok = (cls >= 0) & (cls < num_features)
    return w2.new_zeros(n_runs * num_features).index_add_(
        0, (run_of * num_features + cls)[ok], w2[ok]).view(
        n_runs, num_features)


def _blend(data, run_ids, w_sum, s2_sum, t_sum,
           interpolation_weight: float) -> torch.Tensor:
    iw = torch.tensor(np.float32(interpolation_weight), device=data.device)
    safe_w = w_sum.clamp_min(1e-30)
    mult = torch.where(w_sum > 0, 1.0 - (iw * s2_sum) / safe_w,
                       torch.ones_like(w_sum))
    scale = iw / safe_w
    keep = (run_ids >= 0) & (run_ids < data.shape[0])
    rows = run_ids[keep]
    data[rows] = (data[rows] * mult[keep][:, None]
                  + scale[keep][:, None] * t_sum[keep])
    return data


def _splat_runs(data, run_ids, starts, weights, classes,
                interpolation_weight: float) -> torch.Tensor:
    run_of, w_sum, s2_sum, w2 = _record_sums(starts, weights)
    t_sum = _class_sums(run_of, w_sum.shape[0], w2, classes, data.shape[1])
    return _blend(data, run_ids, w_sum, s2_sum, t_sum, interpolation_weight)


def splat_onehot_reference(data: torch.Tensor, records: Records,
                           interpolation_weight: float) -> torch.Tensor:
    """Plain PyTorch version of the single-map kernel.  Updates
    ``data [V, F]`` in place and returns it."""
    run_ids, starts = _cut(records.ids)
    return _splat_runs(data, run_ids, starts, records.weights,
                       records.classes, interpolation_weight)


def splat_onehot_multi_reference(datas: Sequence[torch.Tensor],
                                 records: Records,
                                 interpolation_weights: Sequence[float]
                                 ) -> List[torch.Tensor]:
    """Plain PyTorch version of the multi-map kernel: W and S2 once, T
    and the blend per map (``records.classes [M, R]``), each map equal to
    :func:`splat_onehot_reference` on its own classes."""
    run_ids, starts = _cut(records.ids)
    run_of, w_sum, s2_sum, w2 = _record_sums(starts, records.weights)
    for data, cls, iw in zip(datas, records.classes, interpolation_weights):
        t_sum = _class_sums(run_of, w_sum.shape[0], w2, cls, data.shape[1])
        _blend(data, run_ids, w_sum, s2_sum, t_sum, iw)
    return list(datas)


def splat_onehot_frames_reference(data: torch.Tensor,
                                  records: FrameRecords,
                                  interpolation_weight: float
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the frames kernel:
    :func:`splat_onehot_reference` frame by frame, in frame order, on
    each frame's records (in sorted order they are that frame's
    :func:`sorted_records`)."""
    for t in torch.unique(records.frames).tolist():
        sel = records.frames == t
        splat_onehot_reference(data, Records(
            records.ids[sel], records.weights[sel], records.classes[sel]),
            interpolation_weight)
    return data


def splat_dense_reference(data: torch.Tensor, records: DenseRecords,
                          features: torch.Tensor,
                          interpolation_weight: float) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel: the same runs, sums and
    float32 expressions (JAX's ``_blend_fields`` order), and each row's
    contributions added in record order (``index_add_`` on the CPU adds
    in index order).  Touches only the runs' rows; updates ``data [V, F]``
    in place and returns it."""
    run_ids, starts = _cut(records.ids)
    run_of, w_sum, s2_sum, _ = _record_sums(starts, records.weights)
    iw = torch.tensor(np.float32(interpolation_weight), device=data.device)
    safe_w = w_sum.clamp_min(1e-30)
    mult = torch.where(w_sum > 0, 1.0 - (iw * s2_sum) / safe_w,
                       torch.ones_like(w_sum))
    keep = (run_ids >= 0) & (run_ids < data.shape[0])
    kept = keep[run_of]
    run_of = run_of[kept]
    w = records.weights[kept]
    scale = iw * w * w / safe_w[run_of]
    contrib = scale[:, None] * features[records.pixels[kept].long()]
    slot = torch.cumsum(keep, 0) - 1            # run -> row among kept
    rows = run_ids[keep].long()
    new_rows = data[rows] * mult[keep][:, None]
    new_rows.index_add_(0, slot[run_of], contrib)
    data[rows] = new_rows
    return data


# ----------------------------------------------------------------------
# build and bind
# ----------------------------------------------------------------------

def _paths(name: str):
    return (os.path.join(_PKG, "csrc", f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def nvcc() -> str:
    """The CUDA compiler: on the path, else under CUDA_HOME."""
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(names: Sequence[str] = LIBRARIES) -> Dict[str, float]:
    """Compile the named ``csrc/<name>.cu`` sources for sm_90a, one
    ``nvcc`` each, all started together, skipping a library newer than
    its source.  Returns the seconds until each one was ready."""
    t0 = time.perf_counter()
    compiler = nvcc()
    jobs, seconds = {}, {}
    for name in names:
        source, library = _paths(name)
        if (os.path.exists(library)
                and os.path.getmtime(library) >= os.path.getmtime(source)):
            seconds[name] = 0.0
            continue
        if not os.path.exists(compiler):
            raise RuntimeError(
                f"nvcc not found: the kernels are built from "
                f"{os.path.dirname(source)} at first use and need the CUDA "
                "toolkit")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{library}.tmp{os.getpid()}"
        jobs[name] = (subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), tmp, library, source)
    failed = []
    for name, (proc, tmp, library, source) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{err}")
            continue
        os.replace(tmp, library)
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


# each kernel's launch entry ``<kernel>_launch``: its library (built
# from ``csrc/<library>.cu``) and its argument types
_ENTRIES = {
    "splat_onehot": ("splat_onehot", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]),
    "splat_onehot_multi": ("splat_onehot", [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p]),
    "splat_onehot_frames": ("splat_onehot", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]),
    "splat_dense": ("splat_dense", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]),
    "nms": ("nms", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    "bfs": ("bfs", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]),
}
# each library's query entries (no arguments, an int back)
_LIMITS = {"splat_onehot": ("splat_onehot_max_features",),
           "splat_dense": ("splat_dense_max_features",),
           "nms": ("nms_max_boxes", "nms_max_counts"),
           "bfs": ()}
KERNELS = tuple(_ENTRIES)


def _library(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its kernels' launch entries and
    its query entries (``_LIMITS``) bound."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_paths(name)[1])
        for kernel, (library, argtypes) in _ENTRIES.items():
            if library == name:
                launch = getattr(lib, f"{kernel}_launch")
                launch.restype = ctypes.c_int
                launch.argtypes = argtypes
        for query in _LIMITS[name]:
            limit = getattr(lib, query)
            limit.restype = ctypes.c_int
            limit.argtypes = []
        _libs[name] = lib
    return lib


def tile_records() -> int:
    """Records per tile of the built splat kernel: a run longer than
    this crosses a tile's end."""
    return _library("splat_onehot").splat_onehot_tile()


def dense_config() -> Dict[str, int]:
    """The built dense kernel's shape (its float4 form): threads a block,
    records a warp's window, channels a warp, window and tail records
    whose lines one load brings, records one tail load of ids spans, and,
    as the compiler left them, registers and spilled bytes a thread and
    resident blocks an SM."""
    out = (ctypes.c_int * 9)()
    _raise_on(_library("splat_dense").splat_dense_config(out),
              "dense splat config")
    return dict(zip(("threads", "window_records", "slice_channels",
                     "step_records", "tail_step_records",
                     "tail_load_records", "registers", "spill_bytes",
                     "blocks_per_sm"), out))


def _check_map(kernel: str, data: torch.Tensor, max_features: int) -> None:
    if data.dtype != torch.float32 or data.dim() != 2 or \
            not data.is_contiguous():
        raise ValueError(f"{kernel} kernel: data must be a contiguous "
                         f"float32 [V, F] tensor, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if data.shape[1] > max_features:
        raise ValueError(f"{kernel} kernel: F={data.shape[1]} exceeds "
                         f"{max_features}")


_RECORD_DTYPES = {"ids": torch.int32, "weights": torch.float32,
                  "classes": torch.int32, "frames": torch.int32,
                  "pixels": torch.int32}


def _check_records(kernel: str, device, records, num_voxels: int,
                   class_dim: int) -> None:
    """Every field of ``records`` (:class:`Records`,
    :class:`FrameRecords` or :class:`DenseRecords`) is a contiguous tensor on ``device`` of its
    dtype, 1-D (``classes``: ``class_dim``-D) and of one length R below
    ``MAX_RECORDS``; V fits the kernel's int32 ids."""
    for name in records._fields:
        t = getattr(records, name)
        dims = class_dim if name == "classes" else 1
        dtype = _RECORD_DTYPES[name]
        if t.device != device or t.dtype != dtype or t.dim() != dims or \
                not t.is_contiguous():
            raise ValueError(
                f"{kernel} kernel: {name} must be a contiguous {dims}-D "
                f"{dtype} tensor on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lengths = {t.shape[-1] for t in records}
    if len(lengths) != 1:
        raise ValueError(f"{kernel} kernel: inconsistent record shapes "
                         f"{[tuple(t.shape) for t in records]}")
    if lengths.pop() > MAX_RECORDS:
        raise ValueError(f"{kernel} kernel: more than {MAX_RECORDS} "
                         "records in one launch")
    check_voxels(num_voxels)


def check_voxels(num_voxels: int) -> None:
    """The kernel reads voxel ids as int32, the discard id ``V``
    included."""
    if num_voxels > MAX_VOXELS:
        raise ValueError(f"splat: V={num_voxels} voxels do not fit the "
                         f"kernel's int32 ids (at most {MAX_VOXELS})")


def _device_kind(datas: Sequence[torch.Tensor], kernel: str) -> str:
    kinds = {d.device.type for d in datas}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds != {"cuda"} or len({d.device for d in datas}) != 1:
        raise ValueError(f"{kernel}: maps on unsupported or mixed devices "
                         f"{sorted(str(d.device) for d in datas)}")
    return "cuda"


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def apply_records(data: torch.Tensor, records: Records,
                  interpolation_weight: float) -> torch.Tensor:
    """Fold one frame's sorted records into ``data [V, F]`` in place:
    the CUDA kernel for a CUDA map, the plain version for a CPU map."""
    global LAUNCHES
    if _device_kind([data], "splat") == "cpu":
        return splat_onehot_reference(data, records, interpolation_weight)
    lib = _library("splat_onehot")
    _check_map("splat", data, lib.splat_onehot_max_features())
    _check_records("splat", data.device, records, data.shape[0], 1)
    _raise_on(lib.splat_onehot_launch(
        data.data_ptr(), data.shape[1], data.shape[0],
        records.ids.data_ptr(), records.weights.data_ptr(),
        records.classes.data_ptr(), records.ids.shape[0],
        float(interpolation_weight), _stream(data.device)), "splat")
    LAUNCHES += 1
    return data


def apply_records_multi(datas: Sequence[torch.Tensor], records: Records,
                        interpolation_weights: Sequence[float]
                        ) -> List[torch.Tensor]:
    """Fold one frame's sorted records (``records.classes [M, R]``) into
    2 <= M <= 4 maps ``[V, F_m]`` in place, each with its own EMA weight:
    the CUDA kernel for CUDA maps, the plain version for CPU maps."""
    global MULTI_LAUNCHES
    datas = list(datas)
    num_maps = len(datas)
    if not 2 <= num_maps <= MAX_MAPS or \
            len(interpolation_weights) != num_maps:
        raise ValueError(f"multi splat: takes 2-{MAX_MAPS} maps with one "
                         f"EMA weight each (one map goes through "
                         f"apply_records), got {num_maps} maps and "
                         f"{len(interpolation_weights)} weights")
    if records.classes.dim() != 2 or records.classes.shape[0] != num_maps:
        raise ValueError(f"multi splat: records.classes must be "
                         f"[{num_maps}, R], got "
                         f"{tuple(records.classes.shape)}")
    if len({d.shape[0] for d in datas}) != 1:
        raise ValueError("multi splat: the maps must share one grid (V)")
    if _device_kind(datas, "multi splat") == "cpu":
        return splat_onehot_multi_reference(datas, records,
                                            interpolation_weights)
    lib = _library("splat_onehot")
    for data in datas:
        _check_map("multi splat", data, lib.splat_onehot_max_features())
    _check_records("multi splat", datas[0].device, records,
                   datas[0].shape[0], 2)
    pad = MAX_MAPS - num_maps
    _raise_on(lib.splat_onehot_multi_launch(
        num_maps,
        (ctypes.c_void_p * MAX_MAPS)(*[d.data_ptr() for d in datas],
                                     *[None] * pad),
        (ctypes.c_int * MAX_MAPS)(*[d.shape[1] for d in datas], *[0] * pad),
        (ctypes.c_float * MAX_MAPS)(*[float(w) for w in
                                      interpolation_weights], *[0.0] * pad),
        datas[0].shape[0], records.ids.data_ptr(),
        records.weights.data_ptr(), records.classes.data_ptr(),
        records.ids.shape[0], _stream(datas[0].device)), "multi splat")
    MULTI_LAUNCHES += 1
    return datas


def apply_frame_records(data: torch.Tensor, records: FrameRecords,
                        interpolation_weight: float) -> torch.Tensor:
    """Fold T frames' sorted records into ``data [V, F]`` in place, in
    frame order: the CUDA kernel for a CUDA map, the plain version for a
    CPU map."""
    global FRAMES_LAUNCHES
    if _device_kind([data], "frames splat") == "cpu":
        return splat_onehot_frames_reference(data, records,
                                             interpolation_weight)
    lib = _library("splat_onehot")
    _check_map("frames splat", data, lib.splat_onehot_max_features())
    _check_records("frames splat", data.device, records, data.shape[0], 1)
    _raise_on(lib.splat_onehot_frames_launch(
        data.data_ptr(), data.shape[1], data.shape[0],
        records.ids.data_ptr(), records.weights.data_ptr(),
        records.classes.data_ptr(), records.frames.data_ptr(),
        records.ids.shape[0], float(interpolation_weight),
        _stream(data.device)), "frames splat")
    FRAMES_LAUNCHES += 1
    return data


def apply_dense_records(data: torch.Tensor, records: DenseRecords,
                        features: torch.Tensor,
                        interpolation_weight: float) -> torch.Tensor:
    """Fold one frame's sorted dense records into ``data [V, F]`` in
    place, record ``r`` carrying ``features[records.pixels[r]]`` (``[P,
    F]``): the CUDA kernel for a CUDA map, the plain version for a CPU
    map.  Every pixel index must be below P (not checked on the card:
    that would sync)."""
    global DENSE_LAUNCHES
    if _device_kind([data, features], "dense splat") == "cpu":
        return splat_dense_reference(data, records, features,
                                     interpolation_weight)
    lib = _library("splat_dense")
    _check_map("dense splat", data, lib.splat_dense_max_features())
    if features.dtype != torch.float32 or features.dim() != 2 or \
            not features.is_contiguous() or \
            features.shape[1] != data.shape[1]:
        raise ValueError(f"dense splat kernel: features must be a "
                         f"contiguous float32 [P, {data.shape[1]}] tensor, "
                         f"got {features.dtype} {tuple(features.shape)}")
    _check_records("dense splat", data.device, records, data.shape[0], 1)
    _raise_on(lib.splat_dense_launch(
        data.data_ptr(), data.shape[1], data.shape[0],
        records.ids.data_ptr(), records.weights.data_ptr(),
        records.pixels.data_ptr(), features.data_ptr(),
        records.ids.shape[0], float(interpolation_weight),
        _stream(data.device)), "dense splat")
    DENSE_LAUNCHES += 1
    return data


def splat_onehot(data: torch.Tensor, ids: torch.Tensor,
                 weights: torch.Tensor, classes: torch.Tensor,
                 interpolation_weight: float) -> torch.Tensor:
    """One frame's one-hot corner records into ``data [V, F]`` in place
    (``ids``/``weights`` ``[8N]``, ``classes`` ``[N]``)."""
    check_voxels(data.shape[0])
    return apply_records(data, sorted_records(ids, weights, classes),
                         interpolation_weight)


def splat_onehot_multi(datas: Sequence[torch.Tensor], ids: torch.Tensor,
                       weights: torch.Tensor,
                       classes: Sequence[torch.Tensor],
                       interpolation_weights: Sequence[float]
                       ) -> List[torch.Tensor]:
    """One frame's records into M maps of one grid in place, sorted once
    (``classes``: one ``[N]`` image per map)."""
    check_voxels(max((d.shape[0] for d in datas), default=0))
    return apply_records_multi(
        datas, sorted_records_multi(ids, weights, classes),
        interpolation_weights)


def splat_onehot_frames(data: torch.Tensor, ids: torch.Tensor,
                        weights: torch.Tensor, classes: torch.Tensor,
                        interpolation_weight: float) -> torch.Tensor:
    """T frames' records (``ids``/``weights [T, 8N]``, ``classes
    [T, N]``) into ``data [V, F]`` in place, in frame order."""
    check_voxels(data.shape[0])
    return apply_frame_records(
        data, sorted_frame_records(ids, weights, classes),
        interpolation_weight)


def splat_dense(data: torch.Tensor, ids: torch.Tensor,
                weights: torch.Tensor, features: torch.Tensor,
                interpolation_weight: float) -> torch.Tensor:
    """One frame's dense corner records (``ids``/``weights [8N]``,
    ``features [N, F]``) into ``data [V, F]`` in place."""
    check_voxels(data.shape[0])
    return apply_dense_records(
        data, sorted_dense_records(ids, weights, features.shape[0]),
        features.to(torch.float32).contiguous(), interpolation_weight)
