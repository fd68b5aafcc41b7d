"""The single-map one-hot splat: a CUDA kernel for Hopper and its plain
PyTorch version.

Replaces ``mass_tpu/ops/pallas_splat.py:splat_onehot_cmajor``.  One
frame's corner records (``ops/scatter.corner_contributions``) fold into a
voxel-major ``[V, F]`` map in place:

    W_v = sum w,  S2_v = sum w^2,  T_v[f] = sum w^2 [class == f]
    row_v = row_v * (1 - iw * S2_v / W_v) + (iw / W_v) * T_v

Preparation is plain PyTorch (:func:`sorted_runs`): a stable sort of the
records by voxel id, then one run per touched voxel.  The kernel
(``csrc/splat_onehot.cu``) gives each run to one warp and sums it in
sorted order, so the update is deterministic (no float atomics) and
equals :func:`splat_onehot_reference` on the CPU bit for bit.

The kernel is built with ``nvcc`` for ``sm_90a`` into ``build/kernels/``
at first use and bound with ctypes.  :func:`apply_runs` launches it for
a CUDA map (and counts the launch in ``LAUNCHES``) and takes the plain
version only for a map that lies on the CPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "splat_onehot.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIBRARY = os.path.join(BUILD_DIR, "libsplat_onehot.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches made by apply_runs (read by chip_smoke.py to show the
# main path went through the kernel)
LAUNCHES = 0

_lib = None


class Runs(NamedTuple):
    """Records sorted by voxel id and cut into runs of one voxel each.

    ``ids [U]`` and ``starts [U + 1]`` (int64) give each run's voxel id
    and record range; ``weights [R]`` (float32) and ``classes [R]``
    (int32) are the sorted records.  A run with id ``V`` holds the
    discarded records of invalid pixels and is skipped.
    """

    ids: torch.Tensor
    starts: torch.Tensor
    weights: torch.Tensor
    classes: torch.Tensor


def sorted_runs(ids: torch.Tensor, weights: torch.Tensor,
                classes: torch.Tensor) -> Runs:
    """Stable-sort ``[8N]`` corner records by voxel id (ties keep record
    order) and cut them into per-voxel runs; ``classes`` is ``[N]``."""
    ids_s, order = torch.sort(ids.to(torch.int64), stable=True)
    cls8 = classes.reshape(-1).repeat(8).to(torch.int32)
    run_ids, counts = torch.unique_consecutive(ids_s, return_counts=True)
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return Runs(ids=run_ids, starts=starts,
                weights=weights[order].to(torch.float32).contiguous(),
                classes=cls8[order].contiguous())


def splat_onehot_reference(data: torch.Tensor, runs: Runs,
                           interpolation_weight: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same sums in the same
    order (``index_add_`` on the CPU adds in index order) and the same
    float32 blend.  Updates ``data [V, F]`` in place and returns it."""
    num_voxels, num_features = data.shape
    n_runs = runs.ids.shape[0]
    counts = runs.starts[1:] - runs.starts[:-1]
    run_of = torch.repeat_interleave(
        torch.arange(n_runs, device=data.device), counts)
    w = runs.weights
    w2 = w * w
    w_sum = w.new_zeros(n_runs).index_add_(0, run_of, w)
    s2_sum = w.new_zeros(n_runs).index_add_(0, run_of, w2)
    cls = runs.classes.to(torch.int64)
    ok = (cls >= 0) & (cls < num_features)   # the kernel drops the rest
    t_sum = w.new_zeros(n_runs * num_features).index_add_(
        0, (run_of * num_features + cls)[ok], w2[ok]).view(
        n_runs, num_features)
    iw = torch.tensor(np.float32(interpolation_weight), device=data.device)
    safe_w = w_sum.clamp_min(1e-30)
    mult = torch.where(w_sum > 0, 1.0 - (iw * s2_sum) / safe_w,
                       torch.ones_like(w_sum))
    scale = iw / safe_w
    keep = runs.ids < num_voxels
    rows = runs.ids[keep]
    data[rows] = (data[rows] * mult[keep][:, None]
                  + scale[keep][:, None] * t_sum[keep])
    return data


def build() -> float:
    """Compile ``csrc/splat_onehot.cu`` for sm_90a unless the library is
    newer than its source; returns the seconds spent."""
    t0 = time.perf_counter()
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return time.perf_counter() - t0
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the splat kernel is built from "
            f"{SOURCE} at first use and needs the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.tmp{os.getpid()}"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        lib.splat_onehot_launch.restype = ctypes.c_int
        lib.splat_onehot_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p]
        lib.splat_onehot_max_features.restype = ctypes.c_int
        lib.splat_onehot_max_features.argtypes = []
        _lib = lib
    return _lib


def _check(data: torch.Tensor, runs: Runs, max_features: int) -> None:
    if data.dtype != torch.float32 or data.dim() != 2 or \
            not data.is_contiguous():
        raise ValueError("splat kernel: data must be a contiguous float32 "
                         f"[V, F] tensor, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if data.shape[1] > max_features:
        raise ValueError(f"splat kernel: F={data.shape[1]} exceeds "
                         f"{max_features}")
    want = (("ids", torch.int64), ("starts", torch.int64),
            ("weights", torch.float32), ("classes", torch.int32))
    for name, dtype in want:
        t = getattr(runs, name)
        if t.device != data.device or t.dtype != dtype or \
                t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"splat kernel: runs.{name} must be a contiguous 1-D "
                f"{dtype} tensor on {data.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if runs.starts.shape[0] != runs.ids.shape[0] + 1 or \
            runs.weights.shape != runs.classes.shape:
        raise ValueError("splat kernel: inconsistent run shapes")


def apply_runs(data: torch.Tensor, runs: Runs,
               interpolation_weight: float) -> torch.Tensor:
    """Fold prepared runs into ``data [V, F]`` in place: the CUDA kernel
    for a CUDA map, the plain version for a CPU map."""
    global LAUNCHES
    if data.device.type == "cpu":
        return splat_onehot_reference(data, runs, interpolation_weight)
    if data.device.type != "cuda":
        raise ValueError(f"splat: unsupported device {data.device}")
    lib = _library()
    _check(data, runs, lib.splat_onehot_max_features())
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.splat_onehot_launch(
            data.data_ptr(), data.shape[1], data.shape[0],
            runs.ids.data_ptr(), runs.starts.data_ptr(),
            runs.weights.data_ptr(), runs.classes.data_ptr(),
            runs.ids.shape[0], float(interpolation_weight), stream)
    if err != 0:
        raise RuntimeError(f"splat kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return data


def splat_onehot(data: torch.Tensor, ids: torch.Tensor,
                 weights: torch.Tensor, classes: torch.Tensor,
                 interpolation_weight: float) -> torch.Tensor:
    """One frame's one-hot corner records into ``data [V, F]`` in place
    (``ids``/``weights`` ``[8N]``, ``classes`` ``[N]``)."""
    return apply_runs(data, sorted_runs(ids, weights, classes),
                      interpolation_weight)
