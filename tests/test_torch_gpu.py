"""Tests of the port that need a CUDA card (marker ``gpu``; each skips
without one).  The file imports no JAX, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import json
import os

import numpy as np
import pytest
import torch

from mass_tpu_torch.config import MapGeometry
from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.ops import splat as SP

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _runs(device, seed=0):
    """A random frame's runs on a 32x16x4x6 map (the JAX splat tests'
    geometry), with the map's random starting values."""
    rng = np.random.RandomState(seed)
    geo = MapGeometry(map_height=32, map_width=16, map_depth=4,
                      feature_size=6, grid_resolution=0.2)
    vm = VoxelMap.create(geo, device="cpu")
    vm.data.copy_(torch.from_numpy(rng.rand(geo.num_voxels, 6).astype(
        np.float32)))
    depth = rng.uniform(0.05, 2.2, (9, 11, 1)).astype(np.float32)
    depth[0, 0, 0] = 50.0
    ids, w = vm.contributions(
        G.camera_rays(9, 11, 7.0, 7.0), torch.from_numpy(
            rng.uniform(-0.3, 0.3, 3).astype(np.float32)),
        float(rng.uniform(-np.pi, np.pi)), float(rng.uniform(-0.8, 0.2)),
        torch.from_numpy(depth))
    classes = torch.from_numpy(rng.randint(0, 6, 99).astype(np.int32))
    runs = SP.sorted_runs(ids, w, classes)
    return vm.data, runs, SP.Runs(*(t.to(device) for t in runs))


def test_kernel_matches_plain_versions(cuda):
    data, cpu_runs, runs = _runs(cuda)
    gpu = data.to(cuda)
    before = SP.LAUNCHES
    out = SP.apply_runs(gpu.clone(), runs, 0.5)
    again = SP.apply_runs(gpu.clone(), runs, 0.5)
    plain_gpu = SP.splat_onehot_reference(gpu.clone(), runs, 0.5)
    torch.cuda.synchronize()
    assert SP.LAUNCHES == before + 2
    assert torch.equal(out, again)                  # deterministic
    assert (out - plain_gpu).abs().max().item() <= 1e-5
    plain_cpu = SP.splat_onehot_reference(data.clone(), cpu_runs, 0.5)
    assert torch.equal(out.cpu(), plain_cpu)        # bit for bit
    assert not torch.equal(out.cpu(), data)


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    data, _, runs = _runs(cuda)
    gpu = data.to(cuda)
    with pytest.raises(ValueError):
        SP.apply_runs(gpu.double(), runs, 0.5)
    with pytest.raises(ValueError):
        SP.apply_runs(gpu.t(), runs, 0.5)
    with pytest.raises(ValueError):
        SP.apply_runs(gpu, runs._replace(classes=runs.classes.long()), 0.5)
    with pytest.raises(ValueError):
        SP.apply_runs(gpu, runs._replace(weights=runs.weights.cpu()), 0.5)


def test_frozen_protocol_random_arm_on_card(cuda, tmp_path):
    """tests/test_frozen_protocol.py's random arm, task 0, through the
    port's CLI on the card: equal to the committed JAX record."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.ops import splat

    with open(os.path.join(REPO, "experiments", "mr22", "random", "results",
                           "0.json")) as f:
        committed = json.load(f)
    splat.LAUNCHES = 0
    cli.main([
        "--backend", "gridworld", "--camera-size", "48",
        "--map-height", "160", "--map-width", "160", "--map-depth", "24",
        "--grid-resolution", "0.125", "--step-size", "2",
        "--obstacle-padding", "2", "--map-slice-start", "0",
        "--map-slice-stop", "12", "--room-size", "12", "--num-rooms", "3",
        "--num-objects", "5", "--num-misplaced", "2",
        "--exploration-budget-one", "2", "--exploration-budget-two", "2",
        "--max-goal-steps", "60", "--ground-truth-segmentation",
        "--ground-truth-disagreement", "--record-found-objects",
        "--start-task", "0", "--total-tasks", "1", "--device", "cuda",
        "--logdir", str(tmp_path)])
    with open(tmp_path / "results" / "0.json") as f:
        fresh = json.load(f)
    assert splat.LAUNCHES == fresh["timing"]["mapping"]["count"] > 0
    drift = {k: (committed[k], fresh.get(k)) for k in committed
             if k != "timing" and fresh.get(k) != committed[k]}
    assert not drift
