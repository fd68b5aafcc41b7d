"""Device meshes (port of ``mass_tpu.parallel.mesh``).

The JAX package names two scaling axes over a ``jax.sharding.Mesh``:
``data`` (independent episodes, frames or training samples) and ``map``
(the voxel grid cut into row slabs).  The port runs one process, so its
mesh is only a named grid of ``torch.device``: the sharded maps
(``parallel/sharding.py``), the fleet (``parallel/fleet.py``) and the
data-parallel trainers (``utils/training.Replicas``) read the devices of
an axis and place a slab or a replica on each.

The default device list is every CUDA card, ``cuda:0`` first.  An
explicit list may repeat a device: ``["cpu"] * 8`` is the CPU as eight
devices (what the JAX package's tests get from eight virtual CPU
devices), and ``["cuda:0"] * 4`` four slabs on one card.  Nothing ever
places several slabs on one card unless the caller lists it so.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """``torch.device(device)`` with a CUDA index (``cuda`` is the
    current card), so two spellings of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceMesh:
    """A named grid of ``torch.device``: ``devices`` is a numpy object
    array of shape ``axis_sizes``, ``shape[axis]`` an axis's size (as in
    ``jax.sharding.Mesh``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs "
                             f"{devices.ndim} axis names, got "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        kinds = {d.type for d in devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must be of one kind, got "
                             f"{sorted(str(d) for d in devices.flat)}")

    def axis_devices(self, axes: Union[str, Sequence[str]]
                     ) -> List[torch.device]:
        """The devices along ``axes`` (one name or several), in mesh
        order, at index 0 of every other axis: where a slab or replica
        cut over those axes lives."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{unknown}")
        index = tuple(slice(None) if name in axes else 0
                      for name in self.axis_names)
        return list(self.devices[index].flat)


def cuda_devices() -> List[torch.device]:
    """Every CUDA card, ``cuda:0`` first (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh of the requested shape from the first devices of
    ``devices`` (default: every CUDA card).  Asking for more devices than
    the list holds raises, naming both numbers."""
    devices = cuda_devices() if devices is None else [
        canonical_device(d) for d in devices]
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        kind = "" if devices and devices[0].type != "cuda" else "CUDA "
        raise ValueError(f"mesh of {n} {kind}devices requested, "
                         f"{len(devices)} available")
    if any(d.type == "cuda" for d in devices[:n]):
        present = len(cuda_devices())
        missing = sorted({str(d) for d in devices[:n]
                          if d.type == "cuda" and d.index >= present})
        if missing:
            raise ValueError(f"mesh devices {missing} requested, {present} "
                             f"CUDA devices present")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return DeviceMesh(grid.reshape(tuple(axis_sizes)), axis_names)


def data_map_mesh(n_devices: Optional[int] = None,
                  data: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> DeviceMesh:
    """Default 2-D mesh: outer ``data`` (episode batch) x inner ``map``
    (voxel-grid rows).  With no hints, puts everything on ``map`` (and
    ``data`` 2 when the count is even and above 2, as JAX's does)."""
    devices = cuda_devices() if devices is None else list(devices)
    n = n_devices or len(devices)
    if data is None:
        data = 2 if n % 2 == 0 and n > 2 else 1
    return make_mesh((data, n // data), ("data", "map"), devices)
