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


def _records(rng, vm):
    """One random 9x11 frame's corner records on ``vm``'s grid."""
    depth = rng.uniform(0.05, 2.2, (9, 11, 1)).astype(np.float32)
    depth[0, 0, 0] = 50.0
    return vm.contributions(
        G.camera_rays(9, 11, 7.0, 7.0), torch.from_numpy(
            rng.uniform(-0.3, 0.3, 3).astype(np.float32)),
        float(rng.uniform(-np.pi, np.pi)), float(rng.uniform(-0.8, 0.2)),
        torch.from_numpy(depth))


def _random_map(rng, num_features):
    """A 32x16x4 map (the JAX splat tests' geometry) of random values."""
    geo = MapGeometry(map_height=32, map_width=16, map_depth=4,
                      feature_size=num_features, grid_resolution=0.2)
    vm = VoxelMap.create(geo, device="cpu")
    vm.data.copy_(torch.from_numpy(rng.rand(geo.num_voxels,
                                            num_features).astype(np.float32)))
    return vm


def _runs(device, seed=0):
    """A random frame's runs on a 32x16x4x6 map, with the map's random
    starting values."""
    rng = np.random.RandomState(seed)
    vm = _random_map(rng, 6)
    ids, w = _records(rng, vm)
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


def test_multi_kernel_matches_plain_versions(cuda):
    """Occupancy (F=1) and semantic (F=6) maps from one record stream,
    EMA weights 0.5 and 0.25, one out-of-range class in the semantic
    image: each map equals the single-map kernel on its own classes and
    the plain version on the CPU bit for bit."""
    rng = np.random.RandomState(1)
    occ, sem = _random_map(rng, 1), _random_map(rng, 6)
    ids, w = _records(rng, sem)
    cls_sem = rng.randint(0, 6, 99).astype(np.int32)
    cls_sem[5] = 9                                   # dropped for sem only
    classes = [torch.zeros(99, dtype=torch.int32), torch.from_numpy(cls_sem)]
    cpu_runs = SP.sorted_runs_multi(ids, w, classes)
    runs = SP.Runs(*(t.to(cuda) for t in cpu_runs))
    datas = [occ.data.to(cuda), sem.data.to(cuda)]
    iws = (0.5, 0.25)
    before = SP.MULTI_LAUNCHES
    out = SP.apply_runs_multi([d.clone() for d in datas], runs, iws)
    again = SP.apply_runs_multi([d.clone() for d in datas], runs, iws)
    plain = SP.splat_onehot_multi_reference([d.clone() for d in datas], runs,
                                            iws)
    cpu = SP.splat_onehot_multi_reference(
        [occ.data.clone(), sem.data.clone()], cpu_runs, iws)
    torch.cuda.synchronize()
    assert SP.MULTI_LAUNCHES == before + 2
    for m in range(2):
        single = SP.apply_runs(datas[m].clone(), runs._replace(
            classes=runs.classes[m].contiguous()), iws[m])
        assert torch.equal(out[m], again[m])
        assert torch.equal(out[m], single)
        assert (out[m] - plain[m]).abs().max().item() <= 1e-5
        assert torch.equal(out[m].cpu(), cpu[m])
        assert not torch.equal(out[m], datas[m])
    with pytest.raises(ValueError, match="2-4 maps"):   # one map
        SP.apply_runs_multi(datas[:1], runs._replace(
            classes=runs.classes[:1].contiguous()), iws[:1])
    with pytest.raises(ValueError):             # five maps
        SP.apply_runs_multi(datas * 2 + datas[:1], runs, iws * 2 + iws[:1])
    with pytest.raises(ValueError):             # F > 128
        SP.apply_runs_multi([datas[0], torch.zeros(
            datas[0].shape[0], 129, device=cuda)], runs, iws)


def test_frames_kernel_matches_plain_versions(cuda):
    """Three frames in one launch equal three single-map launches in a
    row and the plain version on the CPU, bit for bit."""
    rng = np.random.RandomState(2)
    vm = _random_map(rng, 6)
    recs = [_records(rng, vm) for _ in range(3)]
    ids = torch.stack([i for i, _ in recs])
    w = torch.stack([x for _, x in recs])
    classes = torch.from_numpy(rng.randint(0, 6, (3, 99)).astype(np.int32))
    cpu_runs = SP.frame_runs(ids, w, classes)
    runs = SP.FrameRuns(*(t.to(cuda) for t in cpu_runs))
    data = vm.data.to(cuda)
    before = SP.FRAMES_LAUNCHES
    out = SP.apply_frame_runs(data.clone(), runs, 0.5)
    again = SP.apply_frame_runs(data.clone(), runs, 0.5)
    plain = SP.splat_onehot_frames_reference(data.clone(), runs, 0.5)
    seq = data.clone()
    for t in range(3):
        SP.apply_runs(seq, SP.Runs(*(x.to(cuda) for x in SP.sorted_runs(
            ids[t], w[t], classes[t]))), 0.5)
    cpu = SP.splat_onehot_frames_reference(vm.data.clone(), cpu_runs, 0.5)
    torch.cuda.synchronize()
    assert SP.FRAMES_LAUNCHES == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out, seq)
    assert (out - plain).abs().max().item() <= 1e-5
    assert torch.equal(out.cpu(), cpu)
    assert not torch.equal(out, data)


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
