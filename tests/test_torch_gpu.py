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
from tests import torch_streams as TS

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


def _sorted(device, seed=0):
    """A random frame's sorted records on a 32x16x4x6 map, with the
    map's random starting values."""
    rng = np.random.RandomState(seed)
    vm = _random_map(rng, 6)
    ids, w = _records(rng, vm)
    classes = torch.from_numpy(rng.randint(0, 6, 99).astype(np.int32))
    records = SP.sorted_records(ids, w, classes)
    return vm.data, records, SP.Records(*(t.to(device) for t in records))


def test_kernel_matches_plain_versions(cuda):
    data, cpu_runs, runs = _sorted(cuda)
    gpu = data.to(cuda)
    before = SP.LAUNCHES
    out = SP.apply_records(gpu.clone(), runs, 0.5)
    again = SP.apply_records(gpu.clone(), runs, 0.5)
    plain_gpu = SP.splat_onehot_reference(gpu.clone(), runs, 0.5)
    torch.cuda.synchronize()
    assert SP.LAUNCHES == before + 2
    assert torch.equal(out, again)                  # deterministic
    assert (out - plain_gpu).abs().max().item() <= 1e-5
    plain_cpu = SP.splat_onehot_reference(data.clone(), cpu_runs, 0.5)
    assert torch.equal(out.cpu(), plain_cpu)        # bit for bit
    assert not torch.equal(out.cpu(), data)


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    """Wrong dtypes, a non-contiguous map, records off the card, V too
    large for int32 ids: the wrapper raises and launches nothing."""
    data, _, runs = _sorted(cuda)
    gpu = data.to(cuda)
    before = SP.LAUNCHES
    with pytest.raises(ValueError):
        SP.apply_records(gpu.double(), runs, 0.5)
    with pytest.raises(ValueError):
        SP.apply_records(gpu.t(), runs, 0.5)
    with pytest.raises(ValueError):
        SP.apply_records(gpu, runs._replace(classes=runs.classes.long()),
                         0.5)
    with pytest.raises(ValueError):
        SP.apply_records(gpu, runs._replace(ids=runs.ids.long()), 0.5)
    with pytest.raises(ValueError):
        SP.apply_records(gpu, runs._replace(weights=runs.weights.cpu()), 0.5)
    with pytest.raises(ValueError):
        SP.apply_records(gpu, runs._replace(weights=runs.weights[:-1]), 0.5)
    huge = torch.empty((SP.MAX_VOXELS + 1, 0), device=cuda)  # no memory
    with pytest.raises(ValueError, match="int32"):
        SP.apply_records(huge, runs, 0.5)
    with pytest.raises(ValueError, match="int32"):
        SP.apply_records_multi([huge, huge], runs._replace(
            classes=torch.stack([runs.classes] * 2)), (0.5, 0.5))
    assert SP.LAUNCHES == before


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
    cpu_runs = SP.sorted_records_multi(ids, w, classes)
    runs = SP.Records(*(t.to(cuda) for t in cpu_runs))
    datas = [occ.data.to(cuda), sem.data.to(cuda)]
    iws = (0.5, 0.25)
    before = SP.MULTI_LAUNCHES
    out = SP.apply_records_multi([d.clone() for d in datas], runs, iws)
    again = SP.apply_records_multi([d.clone() for d in datas], runs, iws)
    plain = SP.splat_onehot_multi_reference([d.clone() for d in datas], runs,
                                            iws)
    cpu = SP.splat_onehot_multi_reference(
        [occ.data.clone(), sem.data.clone()], cpu_runs, iws)
    torch.cuda.synchronize()
    assert SP.MULTI_LAUNCHES == before + 2
    for m in range(2):
        single = SP.apply_records(datas[m].clone(), runs._replace(
            classes=runs.classes[m].contiguous()), iws[m])
        assert torch.equal(out[m], again[m])
        assert torch.equal(out[m], single)
        assert (out[m] - plain[m]).abs().max().item() <= 1e-5
        assert torch.equal(out[m].cpu(), cpu[m])
        assert not torch.equal(out[m], datas[m])
    with pytest.raises(ValueError, match="2-4 maps"):   # one map
        SP.apply_records_multi(datas[:1], runs._replace(
            classes=runs.classes[:1].contiguous()), iws[:1])
    with pytest.raises(ValueError):             # five maps
        SP.apply_records_multi(datas * 2 + datas[:1], runs, iws * 2 + iws[:1])
    with pytest.raises(ValueError):             # F > 128
        SP.apply_records_multi([datas[0], torch.zeros(
            datas[0].shape[0], 129, device=cuda)], runs, iws)
    with pytest.raises(ValueError):             # a non-contiguous map
        SP.apply_records_multi([datas[0], torch.zeros(
            6, datas[1].shape[0], device=cuda).t()], runs, iws)
    assert SP.MULTI_LAUNCHES == before + 2


def _check_streams(cuda, ids, w, classes, datas):
    """The kernel (one map) or the multi-map kernel on one stream: equal
    to the plain version on the CPU bit for bit, the same bits twice."""
    num_maps = len(datas)
    iws = TS.INTERPOLATION_WEIGHTS[:num_maps]
    cpu = SP.Records(torch.from_numpy(ids), torch.from_numpy(w),
                     torch.from_numpy(classes))
    gpu = SP.Records(*(t.to(cuda) for t in cpu))
    maps = [torch.from_numpy(d) for d in datas]
    if num_maps == 1:
        cpu, gpu = (r._replace(classes=r.classes[0]) for r in (cpu, gpu))
        want = [SP.splat_onehot_reference(maps[0].clone(), cpu, iws[0])]
        before = SP.LAUNCHES
        outs = [[SP.apply_records(maps[0].to(cuda), gpu, iws[0])]
                for _ in range(2)]
        assert SP.LAUNCHES == before + 2
    else:
        want = SP.splat_onehot_multi_reference(
            [d.clone() for d in maps], cpu, iws)
        before = SP.MULTI_LAUNCHES
        outs = [SP.apply_records_multi([d.to(cuda) for d in maps], gpu, iws)
                for _ in range(2)]
        assert SP.MULTI_LAUNCHES == before + 2
    torch.cuda.synchronize()
    for first, second, ref in zip(*outs, want):
        assert torch.equal(first, second)
        assert torch.equal(first.cpu(), ref)


@pytest.mark.parametrize("num_maps", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(TS.STREAMS))
def test_kernel_on_chosen_runs(cuda, name, num_maps):
    """The kernel on tests/torch_streams.py's streams (runs of 1, 31, 32
    and 33 records, a stream shorter than a tile, a run across a tile's
    end, one longer than a tile, one voxel, only discard ids, negative
    ids), sized by the built kernel's tile."""
    assert SP.tile_records() == TS.TILE_RECORDS
    _check_streams(cuda, *TS.stream(name, num_maps, seed=num_maps))


@pytest.mark.parametrize("num_maps", [1, 2, 3, 4])
def test_kernel_on_more_tiles_than_blocks(cuda, num_maps):
    """A stream of three times as many tiles as the card can hold blocks
    (at most 32 per SM), so every block of the persistent grid sums
    three or more tiles through both stage buffers, with runs across
    tile ends all along: equal to the plain CPU version bit for bit."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _check_streams(cuda, *TS.many_tile_stream(
        3 * sms * TS.MAX_BLOCKS_PER_SM, num_maps, seed=num_maps))


def test_frames_kernel_matches_plain_versions(cuda):
    """Three frames' sorted records in one launch equal three single-map
    launches in a row and the plain version on the CPU, bit for bit."""
    rng = np.random.RandomState(2)
    vm = _random_map(rng, 6)
    recs = [_records(rng, vm) for _ in range(3)]
    ids = torch.stack([i for i, _ in recs])
    w = torch.stack([x for _, x in recs])
    classes = torch.from_numpy(rng.randint(0, 6, (3, 99)).astype(np.int32))
    cpu_records = SP.sorted_frame_records(ids, w, classes)
    records = SP.sorted_frame_records(ids.to(cuda), w.to(cuda),
                                      classes.to(cuda))
    for a, b in zip(records, cpu_records):
        assert torch.equal(a.cpu(), b)
    data = vm.data.to(cuda)
    before = SP.FRAMES_LAUNCHES
    out = SP.apply_frame_records(data.clone(), records, 0.5)
    again = SP.apply_frame_records(data.clone(), records, 0.5)
    plain = SP.splat_onehot_frames_reference(data.clone(), records, 0.5)
    seq = data.clone()
    for t in range(3):
        SP.apply_records(seq, SP.sorted_records(ids[t].to(cuda),
                                                w[t].to(cuda),
                                                classes[t].to(cuda)), 0.5)
    cpu = SP.splat_onehot_frames_reference(vm.data.clone(), cpu_records, 0.5)
    torch.cuda.synchronize()
    assert SP.FRAMES_LAUNCHES == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out, seq)
    assert (out - plain).abs().max().item() <= 1e-5
    assert torch.equal(out.cpu(), cpu)
    assert not torch.equal(out, data)
    with pytest.raises(ValueError):             # int64 frames
        SP.apply_frame_records(data, records._replace(
            frames=records.frames.long()), 0.5)
    with pytest.raises(ValueError):             # a short frames stream
        SP.apply_frame_records(data, records._replace(
            frames=records.frames[:-1]), 0.5)
    assert SP.FRAMES_LAUNCHES == before + 2


def _check_frame_stream(cuda, ids, w, classes, frames, data):
    """The frames kernel on one stream: equal to the plain version on
    the CPU bit for bit, the same bits twice."""
    cpu = SP.FrameRecords(*(torch.from_numpy(a)
                            for a in (ids, w, classes, frames)))
    gpu = SP.FrameRecords(*(t.to(cuda) for t in cpu))
    want = SP.splat_onehot_frames_reference(torch.from_numpy(data.copy()),
                                            cpu, 0.5)
    before = SP.FRAMES_LAUNCHES
    outs = [SP.apply_frame_records(torch.from_numpy(data).to(cuda), gpu,
                                   0.5) for _ in range(2)]
    torch.cuda.synchronize()
    assert SP.FRAMES_LAUNCHES == before + 2
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0].cpu(), want)


@pytest.mark.parametrize("num_features", [54, 7, 33, 128])
@pytest.mark.parametrize("name", sorted(TS.FRAME_STREAMS))
def test_frames_kernel_on_chosen_subruns(cuda, name, num_features):
    """The frames kernel on tests/torch_streams.py's T-frame streams
    (sub-runs of 1, 31, 32, 33 records, a frame change at a tile's end, a
    sub-run across it, a run over two tiles with three frames, T = 1, a
    frame of discard ids only, a voxel of frames 0 and 2 but not 1,
    negative ids), with rows as float2 (F = 54, 128) and as one float
    per class slot (F = 7, 33)."""
    assert SP.tile_records() == TS.TILE_RECORDS
    _check_frame_stream(cuda, *TS.frame_stream(name, num_features,
                                               seed=num_features))


def test_frames_kernel_on_more_tiles_than_blocks(cuda):
    """A T-frame stream of three times as many tiles as the card can hold
    blocks, with sub-runs across tile ends all along: equal to the plain
    CPU version bit for bit."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _check_frame_stream(cuda, *TS.many_tile_frame_stream(
        3 * sms * TS.MAX_BLOCKS_PER_SM, seed=3))


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


@pytest.mark.parametrize("arm", ["cond-ihr", "revisit"])
def test_frozen_protocol_head_arm_on_card(cuda, arm, tmp_path):
    """Task 0 of the committed cond-ihr (conditioned policy with
    inhibition, its convs on cuDNN) and revisit arms through the port's
    CLI on the card: equal to the committed JAX records."""
    from mass_tpu_torch.agent import cli
    from tests.test_torch_agent import PROTOCOL
    from tests.test_torch_heads import ARMS

    with open(os.path.join(REPO, "experiments", "mr22", arm, "results",
                           "0.json")) as f:
        committed = json.load(f)
    cpu = PROTOCOL.index("--platform")
    argv = PROTOCOL[:cpu] + PROTOCOL[cpu + 2:] + ARMS[arm]
    SP.LAUNCHES = 0
    cli.main(argv + ["--device", "cuda", "--logdir", str(tmp_path)])
    with open(tmp_path / "results" / "0.json") as f:
        fresh = json.load(f)
    assert SP.LAUNCHES == fresh["timing"]["mapping"]["count"] > 0
    assert ("search_policy" in fresh["timing"]) == (arm == "cond-ihr")
    drift = {k: (committed[k], fresh.get(k)) for k in committed
             if k != "timing" and fresh.get(k) != committed[k]}
    assert not drift


def _fleet_frames(seed, batch, camera):
    rng = np.random.RandomState(seed)
    return dict(
        positions=rng.uniform(-0.4, 0.4, (batch, 3)).astype(np.float32)
        + np.asarray([[2.0, 2.0, 0.8]], np.float32),
        yaws=rng.uniform(-np.pi, np.pi, batch).astype(np.float32),
        elevations=rng.uniform(-0.6, 0.0, batch).astype(np.float32),
        depths=rng.uniform(0.2, 3.0, (batch, camera, camera, 1)).astype(
            np.float32),
        classes={name: rng.randint(0, 54, (batch, camera, camera)).astype(
            np.int32) for name in ("semantic0", "semantic1")})


def test_fleet_maps_equal_single_kernel_updates(cuda):
    """A three-family fleet of 3 episodes on the card, one unmasked step
    (one multi-map launch) and one step with the compat phases' masks
    (one multi-map launch for semantic0 + occupancy, one single-map
    launch for semantic1): every slab equals the single-map kernel's
    updates of that episode's own map and the CPU fleet, bit for bit."""
    from mass_tpu_torch.config import CameraConfig
    from mass_tpu_torch.parallel.fleet import FleetMaps

    batch, camera = 3, 12
    geo = MapGeometry(map_height=24, map_width=24, map_depth=8,
                      grid_resolution=0.25)
    families = {"semantic0": 54, "semantic1": 54, "occupancy": 1}
    origins = [(2.0, 2.0, 0.8), (2.25, 1.7, 0.8), (1.6, 2.4, 0.7)]
    fleets = {dev: FleetMaps(batch, CameraConfig(height=camera,
                                                 width=camera), geo,
                             families, device=dev)
              for dev in (cuda, "cpu")}
    singles = {name: [VoxelMap.create(MapGeometry(
        feature_size=f, map_height=24, map_width=24, map_depth=8,
        grid_resolution=0.25), origins[e], device=cuda)
        for e in range(batch)] for name, f in families.items()}
    for fleet in fleets.values():
        for e in range(batch):
            fleet.reset(e, origins[e])
    phases = {"semantic0": np.asarray([True, True, False]),
              "occupancy": np.asarray([True, True, False]),
              "semantic1": np.asarray([False, False, True])}
    for step, active in enumerate((None, phases)):
        fr = _fleet_frames(step, batch, camera)
        before = (SP.LAUNCHES, SP.MULTI_LAUNCHES)
        fleets[cuda].update_batch(**fr, active=active)
        assert (SP.LAUNCHES - before[0], SP.MULTI_LAUNCHES - before[1]) == (
            (0, 1) if active is None else (1, 1))
        fleets["cpu"].update_batch(**fr, active=active)
        for name, maps in singles.items():
            for e, vm in enumerate(maps):
                if active is not None and not active[name][e]:
                    continue
                cls = fr["classes"].get(
                    name, np.zeros((batch, camera, camera), np.int32))[e]
                vm.update_classes(fleets[cuda].rays,
                                  torch.from_numpy(fr["positions"][e]).to(
                                      cuda), float(fr["yaws"][e]),
                                  float(fr["elevations"][e]),
                                  torch.from_numpy(fr["depths"][e]).to(cuda),
                                  torch.from_numpy(cls).to(cuda))
    torch.cuda.synchronize()
    for name, maps in singles.items():
        for e, vm in enumerate(maps):
            got = fleets[cuda].view(name, e).data
            assert torch.equal(got, vm.data), (name, e)
            assert torch.equal(got.cpu(), fleets["cpu"].view(name, e).data)
            assert bool(got.any())


@pytest.mark.parametrize("compat", [False, True], ids=["default", "compat"])
def test_fleet_episodes_on_card_equal_cpu(cuda, compat):
    """B = 2 fleet episodes at the episode tests' geometry on the card
    equal the same fleet on the CPU and the sequential agent on the card:
    results apart from timing, and every map update a splat launch."""
    from mass_tpu_torch.agent.loop import RearrangementAgent
    from mass_tpu_torch.config import (AgentConfig, CameraConfig,
                                       MatchConfig, NavConfig)
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    cam = CameraConfig(height=48, width=48)
    cfg = AgentConfig(
        camera=cam, map_height=80, map_width=80, map_depth=24,
        grid_resolution=0.125,
        nav=NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                      map_slice_stop=12, graph_update_interval=5,
                      max_goal_steps=0 if compat else 60,
                      reference_compat=compat),
        match=MatchConfig(contour_padding=0, confidence_threshold=0.1,
                          distance_threshold=0.2, max_instances=8),
        navigate_on_semantic=not compat, exploration_budget_one=1,
        exploration_budget_two=1, ground_truth_segmentation=True,
        ground_truth_disagreement=True, start_task=0, total_tasks=1)
    seeds = [2, 4]

    def sampler(seed):
        return GridWorldTaskSampler([seed], camera=cam, max_steps=120,
                                    num_objects=2, num_misplaced=1,
                                    num_opened=0)

    def fleet(device):
        return FleetEvaluator(cfg, [sampler(s) for s in seeds],
                              seeds=[100 + s for s in seeds],
                              device=device).run()

    SP.LAUNCHES = SP.MULTI_LAUNCHES = 0
    gpu = fleet(cuda)
    launches = (SP.LAUNCHES, SP.MULTI_LAUNCHES)
    cpu = fleet("cpu")
    assert launches[0] > 0 and (launches[1] > 0) == compat
    for s, g, c in zip(seeds, gpu, cpu):
        want = RearrangementAgent(cfg, sampler(s),
                                  rng=np.random.RandomState(100 + s),
                                  device=cuda).run_task(0)
        for k in want:
            if k != "timing":
                assert g[k] == c[k] == want[k], (s, k)


# ----------------------------------------------------------------------
# the dense-row splat (csrc/splat_dense.cu)
# ----------------------------------------------------------------------

def _dense_case(seed, num_features, long_run=False, pixels=99):
    """A random frame's dense records on a 32x16x4 map of random values
    (``long_run``: a third of the records on one voxel), on the CPU."""
    rng = np.random.RandomState(seed)
    vm = _random_map(rng, num_features)
    ids, w = _records(rng, vm)
    if long_run:
        ids = ids.clone()
        ids[torch.from_numpy(rng.rand(ids.shape[0]) < 0.33)] = 77
    feats = torch.from_numpy(rng.randn(pixels, num_features).astype(
        np.float32))
    return vm.data, SP.sorted_dense_records(ids, w, pixels), feats


@pytest.mark.parametrize("num_features", [256, 1, 7, 128, 1024])
@pytest.mark.parametrize("long_run", [False, True])
def test_dense_kernel_matches_plain_versions(cuda, num_features, long_run):
    """The kernel equals the plain version on the CPU bit for bit (float4
    rows for F % 4 == 0, one float a lane otherwise), two runs are
    identical, and the plain version on the card (atomics) agrees within
    1e-5."""
    data, cpu_rec, feats = _dense_case(num_features, num_features, long_run)
    rec = SP.DenseRecords(*(t.to(cuda) for t in cpu_rec))
    gpu, gfeats = data.to(cuda), feats.to(cuda)
    before = SP.DENSE_LAUNCHES
    out = SP.apply_dense_records(gpu.clone(), rec, gfeats, 0.5)
    again = SP.apply_dense_records(gpu.clone(), rec, gfeats, 0.5)
    plain_gpu = SP.splat_dense_reference(gpu.clone(), rec, gfeats, 0.5)
    torch.cuda.synchronize()
    assert SP.DENSE_LAUNCHES == before + 2
    assert torch.equal(out, again)
    assert (out - plain_gpu).abs().max().item() <= 1e-5
    plain_cpu = SP.splat_dense_reference(data.clone(), cpu_rec, feats, 0.5)
    assert torch.equal(out.cpu(), plain_cpu)
    assert not torch.equal(out.cpu(), data)


@pytest.mark.parametrize("num_features", TS.DENSE_FEATURES)
@pytest.mark.parametrize("name", sorted(TS.DENSE_STREAMS))
def test_dense_kernel_on_streams(cuda, name, num_features):
    """Each chosen stream (runs that straddle a window or outlast several
    tail loads, single-record runs, more windows than the card holds
    warps at once, invalid runs) through the kernel: bit-equal to the
    plain version on the CPU, and to a second run."""
    ids, weights, feats, data = TS.dense_stream(name, num_features)
    cpu_rec = SP.sorted_dense_records(torch.from_numpy(ids),
                                      torch.from_numpy(weights),
                                      feats.shape[0])
    rec = SP.DenseRecords(*(t.to(cuda) for t in cpu_rec))
    gpu, gfeats = torch.from_numpy(data).to(cuda), torch.from_numpy(
        feats).to(cuda)
    before = SP.DENSE_LAUNCHES
    out = SP.apply_dense_records(gpu.clone(), rec, gfeats, 0.5)
    again = SP.apply_dense_records(gpu.clone(), rec, gfeats, 0.5)
    torch.cuda.synchronize()
    assert SP.DENSE_LAUNCHES == before + 2
    assert torch.equal(out, again)
    plain = SP.splat_dense_reference(torch.from_numpy(data.copy()), cpu_rec,
                                     torch.from_numpy(feats), 0.5)
    assert torch.equal(out.cpu(), plain)
    assert torch.equal(out.cpu(), torch.from_numpy(data)) == (
        name == "all_discard")


def test_dense_kernel_config_matches_the_streams(cuda):
    """The streams' window and tail-load lengths are the built kernel's."""
    config = SP.dense_config()
    assert config["window_records"] == TS.DENSE_WINDOW
    assert config["tail_load_records"] == TS.DENSE_TAIL_LOAD
    assert config["registers"] > 0 and config["blocks_per_sm"] > 0


def test_dense_kernel_on_an_unaligned_map(cuda):
    """A map view that starts 4 bytes into its storage takes the
    one-float path and still equals the plain version."""
    data, cpu_rec, feats = _dense_case(3, 8)
    rec = SP.DenseRecords(*(t.to(cuda) for t in cpu_rec))
    storage = torch.empty(data.numel() + 1, device=cuda)
    gpu = storage[1:].view(data.shape)
    gpu.copy_(data)
    SP.apply_dense_records(gpu, rec, feats.to(cuda), 0.25)
    plain = SP.splat_dense_reference(data.clone(), cpu_rec, feats, 0.25)
    assert torch.equal(gpu.cpu(), plain)


def test_dense_kernel_wrapper_rejects_bad_inputs(cuda):
    data, cpu_rec, feats = _dense_case(4, 16)
    rec = SP.DenseRecords(*(t.to(cuda) for t in cpu_rec))
    gpu, gfeats = data.to(cuda), feats.to(cuda)
    before = SP.DENSE_LAUNCHES
    with pytest.raises(ValueError):
        SP.apply_dense_records(gpu.double(), rec, gfeats, 0.5)
    with pytest.raises(ValueError):
        SP.apply_dense_records(gpu, rec, gfeats[:, :8], 0.5)
    with pytest.raises(ValueError):
        SP.apply_dense_records(gpu, rec, gfeats.t().contiguous().t(), 0.5)
    with pytest.raises(ValueError):
        SP.apply_dense_records(gpu, rec._replace(pixels=rec.pixels.long()),
                               gfeats, 0.5)
    with pytest.raises(ValueError):
        SP.apply_dense_records(gpu, rec, feats, 0.5)          # mixed
    wide = torch.zeros((4, 1025), device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        SP.apply_dense_records(wide, rec, torch.zeros((99, 1025),
                                                      device=cuda), 0.5)
    assert SP.DENSE_LAUNCHES == before


def test_feature_map_on_card_equals_cpu(cuda):
    """FeatureMap updates of the shipped backbone on the card: the dense
    kernel's launches, and the map within the backbone's tolerance of the
    CPU's (cuDNN sums its convs in another order)."""
    from mass_tpu_torch.config import CameraConfig
    from mass_tpu_torch.maps import FeatureMap
    from mass_tpu_torch.perception.resnet import load_backbone_checkpoint

    path = os.path.join(REPO, "mass_tpu_torch", "checkpoints",
                        "backbone-rand.pth")
    maps = {}
    before = SP.DENSE_LAUNCHES
    for device in (cuda, "cpu"):
        backbone, _ = load_backbone_checkpoint(path, device)
        fmap = FeatureMap(CameraConfig(height=32, width=32), 256, backbone,
                          device=device, map_height=32, map_width=32,
                          map_depth=8, grid_resolution=0.2)
        rng = np.random.RandomState(0)
        for _ in range(3):
            fmap.update_from_observation(dict(
                position=rng.uniform(-0.3, 0.3, 3).astype(np.float32),
                yaw=np.float32(rng.uniform(-3, 3)), elevation=np.float32(
                    -0.3), depth=rng.uniform(0.3, 2.5, (32, 32, 1)).astype(
                        np.float32), rgb=rng.rand(32, 32, 3).astype(
                            np.float32)))
        maps[str(torch.device(device).type)] = fmap.voxel_map.data.cpu()
    assert SP.DENSE_LAUNCHES == before + 3
    assert maps["cuda"].any()
    assert (maps["cuda"] - maps["cpu"]).abs().max().item() <= 2e-4


def test_fm_protocol_task0_on_card(cuda, tmp_path):
    """Task 0 of the frozen feature-matching protocol on the card equals
    the committed record and the CPU run on every field but timing."""
    from mass_tpu_torch.agent import cli

    flags = ["--backend", "gridworld", "--camera-size", "48",
             "--map-height", "80", "--map-width", "80", "--map-depth", "24",
             "--grid-resolution", "0.125", "--step-size", "2",
             "--obstacle-padding", "2", "--map-slice-start", "0",
             "--map-slice-stop", "12", "--room-size", "6",
             "--num-objects", "1", "--num-misplaced", "0",
             "--num-opened", "0", "--duplicate-class-pairs", "1",
             "--exploration-budget-one", "3", "--exploration-budget-two",
             "2", "--max-goal-steps", "60", "--max-steps", "500",
             "--ground-truth-segmentation", "--ground-truth-disagreement",
             "--ground-truth-semantic-search", "--use-feature-matching",
             "--backbone-checkpoint", os.path.join(
                 REPO, "mass_tpu_torch", "checkpoints", "backbone-rand.pth"),
             "--start-task", "0", "--total-tasks", "1"]
    with open(os.path.join(REPO, "experiments", "fm", "fm-features",
                           "results", "0.json")) as f:
        committed = json.load(f)
    before = SP.DENSE_LAUNCHES
    out = {}
    for device in ("cuda", "cpu"):
        cli.main(flags + ["--device", device, "--logdir",
                          str(tmp_path / device)])
        with open(tmp_path / device / "results" / "0.json") as f:
            out[device] = json.load(f)
    assert SP.DENSE_LAUNCHES > before
    for k in committed:
        if k != "timing":
            assert out["cuda"][k] == out["cpu"][k] == committed[k], k


# ----------------------------------------------------------------------
# greedy NMS (csrc/nms.cu) and the detector on the card
# ----------------------------------------------------------------------

def _nms_both(cuda, boxes, scores, threshold, outputs):
    from mass_tpu_torch.ops import detection as D

    before = D.LAUNCHES
    got = D.nms(torch.from_numpy(boxes).to(cuda),
                torch.from_numpy(scores).to(cuda), threshold, outputs)
    torch.cuda.synchronize()
    assert D.LAUNCHES == before + 1
    want = D.nms_reference(torch.from_numpy(boxes),
                           torch.from_numpy(scores), threshold, outputs)
    return got.cpu(), want


@pytest.mark.parametrize("name", sorted(TS.NMS_STREAMS))
def test_nms_kernel_on_streams(cuda, name):
    """Each chosen stream alone: the kernel's keep row equals the plain
    loop on the CPU exactly (ties, +inf and signed-zero scores, repeated
    zero-area picks, dead boxes, class islands, words of the bitmask, caps
    above the survivors, thresholds 0 and 1, the widest problem)."""
    boxes, scores, threshold, outputs = TS.nms_stream(name)
    got, want = _nms_both(cuda, boxes[None], scores[None], threshold,
                          outputs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cycled", [False, True])
def test_nms_kernel_on_a_padded_batch(cuda, cycled):
    """Every stream in one launch, padded with -inf scores, a cap per
    problem; or the batch twice over with the caps cycled (the RPN's
    levels of B frames)."""
    boxes, scores, _, outputs = TS.nms_batch(sorted(TS.NMS_STREAMS), seed=3)
    if cycled:
        boxes = np.concatenate([boxes, boxes])
        scores = np.concatenate([scores, scores])
    got, want = _nms_both(cuda, boxes, scores, 0.5, outputs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("threshold", TS.NMS_SWEEP_THRESHOLDS)
def test_nms_kernel_random_sweep(cuda, threshold):
    """Seeded random problems of 1 to 1,024 boxes at each threshold, each
    alone and all in one launch padded with -inf scores."""
    problems = TS.nms_sweep(threshold)
    for boxes, scores, cap in problems:
        got, want = _nms_both(cuda, boxes[None], scores[None], threshold,
                              cap)
        assert torch.equal(got, want), f"N={len(scores)}"
    n = max(len(s) for _, s, _ in problems)
    boxes = np.zeros((len(problems), n, 4), np.float32)
    scores = np.full((len(problems), n), -np.inf, np.float32)
    for p, (b, s, _) in enumerate(problems):
        boxes[p, :len(s)], scores[p, :len(s)] = b, s
    got, want = _nms_both(cuda, boxes, scores, threshold,
                          [cap for _, _, cap in problems])
    assert torch.equal(got, want)


def test_nms_kernel_config(cuda):
    """A cluster of blocks a problem, no spills, and at N = 1,024 (128 KB
    of rows) a cluster still fits the card."""
    from mass_tpu_torch.ops import detection as D

    for n in (1, 500, TS.NMS_MAX_BOXES):
        config = D.nms_config(n)
        assert config["cluster_blocks"] > 1 and config["spill_bytes"] == 0
        assert config["resident_clusters"] >= 1, config
    with pytest.raises(RuntimeError):
        D.nms_config(TS.NMS_MAX_BOXES + 1)


def test_nms_kernel_wrapper_rejects_bad_inputs(cuda):
    from mass_tpu_torch.ops import detection as D

    boxes = torch.rand(1, 8, 4, device=cuda)
    scores = torch.rand(1, 8, device=cuda)
    before = D.LAUNCHES
    with pytest.raises(ValueError):
        D.nms(boxes.double(), scores, 0.5, 4)
    with pytest.raises(ValueError):
        D.nms(boxes, scores.cpu(), 0.5, 4)
    with pytest.raises(ValueError):
        D.nms(boxes, scores[:, :7], 0.5, 4)
    with pytest.raises(ValueError):
        D.nms(boxes, scores, 0.5, [4, 4, 4])
    wide = torch.rand(1, TS.NMS_MAX_BOXES + 1, 4, device=cuda)
    with pytest.raises(ValueError):
        D.nms(wide, torch.rand(1, TS.NMS_MAX_BOXES + 1, device=cuda), 0.5, 4)
    assert D.LAUNCHES == before


def test_detector_on_card_equals_cpu(cuda):
    """The small random detector (7 classes, 48 px) on two frames, on the
    card and on the CPU, by the margin rule; two NMS launches a call (the
    RPN's levels, the class-aware NMS)."""
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.perception import maskrcnn as TM
    from tests import torch_checkpoints as TC
    from tests import torch_margins

    cfg = TM.MaskRCNNConfig(num_classes=7, image_size=48, pre_nms_topk=64,
                            post_nms_topk=32, candidate_pool=64,
                            max_detections=8)
    sd = TC.random_maskrcnn_state_dict(0, 7)
    rgb = torch.from_numpy(np.random.RandomState(5).rand(
        2, 48, 48, 3).astype(np.float32))
    cpu_model = TM.from_state_dict(sd, cfg, "cpu")
    want, probs = TM.detect(cpu_model, rgb,
                                   TM.device_anchors(cfg, "cpu"),
                                   with_probs=True)
    before = D.LAUNCHES
    model = TM.from_state_dict(sd, cfg, cuda)
    got = TM.detect(model, rgb.to(cuda), TM.device_anchors(cfg, cuda))
    torch.cuda.synchronize()
    assert D.LAUNCHES == before + 2
    report = torch_margins.compare_detections(
        want, got, probs, thresholds=(cfg.score_threshold,))
    assert report["ok"] and report["live_slots"] > 0, report


# the trainers: one step on the card against the same step on the CPU in
# float64 (``python -m mass_tpu_torch.profile_training`` measures each
# device's float32 gradients against float64: a float32 CPU is not
# always the closer side).
TRAIN_TOL = 1e-4
LEARNING_RATE = 3e-4


def _policy_batch(seed=0, b=4, h=24, w=32, c=54):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w, c).astype(np.float32)
    x *= rng.rand(b, h, w, 1) < 0.3
    g = np.stack([rng.randint(0, w, b), rng.randint(0, h, b)], -1)
    return torch.from_numpy(x), torch.from_numpy(g.astype(np.int32))


def _adam_step(model, loss_fn, optimizer):
    """(loss, gradients, parameters after the step) of one step."""
    from mass_tpu_torch.utils.training import exact_convs

    with exact_convs():
        loss = loss_fn()
        optimizer.zero_grad()
        loss.backward()
    grads = {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()}
    optimizer.step()
    return loss.item(), grads, {k: v.detach().cpu().double()
                                for k, v in model.state_dict().items()}


def _check_first_adam_step(card, ref, grad_tol=TRAIN_TOL):
    """Loss within rtol TRAIN_TOL; every gradient within ``grad_tol`` of
    the largest one.  A first Adam step is lr * g / (|g| + eps), about
    lr * sign(g), so it is well defined only where a gradient outweighs
    the card's rounding: there the parameters agree within TRAIN_TOL;
    where |g| is under 100 times the card's gradient error (a tiny
    share) within the step's own bound, twice the learning rate."""
    (loss, grads, params), (loss64, grads64, params64) = card, ref
    np.testing.assert_allclose(loss, loss64, rtol=TRAIN_TOL)
    scale = max(float(g.abs().max()) for g in grads64.values())
    sensitive = total = 0
    for key, g64 in grads64.items():
        err = (grads[key] - g64).abs()
        assert float(err.max()) <= grad_tol * scale, (key, float(err.max()))
        loose = g64.abs() < 100 * err
        tol = torch.where(loose, torch.tensor(2 * LEARNING_RATE,
                                              dtype=torch.float64),
                          torch.tensor(TRAIN_TOL, dtype=torch.float64))
        diff = (params[key] - params64[key]).abs()
        assert (diff <= tol).all(), (key, float(diff.max()))
        sensitive += int(loose.sum())
        total += loose.numel()
    assert sensitive <= total // 100, (sensitive, total)


def test_policy_train_step_on_card_matches_cpu(cuda):
    """One AdamW step from one seeded initialisation (the last conv's
    bias has a zero gradient but for rounding: the softmax over cells
    ignores a shift of every logit, so it is among the sensitive
    entries)."""
    from mass_tpu_torch.search import train as ST

    x, g = _policy_batch()
    runs = []
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        state = ST.create_train_state(torch.Generator().manual_seed(0), 54,
                                      LEARNING_RATE, 1e-4, "cpu")
        state.policy.to(dev, dtype)
        runs.append(_adam_step(state.policy, lambda: ST.goal_cross_entropy(
            state.policy, x.to(dev, dtype), g.to(dev), 2.0),
            state.optimizer))
    _check_first_adam_step(*runs)


# The UNet's float32 gradients part from float64 by up to 1.6e-3 of the
# largest gradient on 32x32 frames, on the card with cuDNN and without it
# (``python -m mass_tpu_torch.profile_training``): the group norm's
# E[x^2] - E[x]^2 (flax's arithmetic) cancels.
UNET_GRAD_TOL = 2e-3


def test_unet_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of the UNet on 64x64 frames."""
    from mass_tpu_torch.perception import detector as PD
    from mass_tpu_torch.perception import train_detector as TD

    rng = np.random.RandomState(1)
    rgb = torch.from_numpy(rng.rand(2, 64, 64, 3))
    sem = rng.randint(0, 54, (2, 64, 64))
    sem[:, :32] = 0
    weights = torch.from_numpy(TD.class_weights(sem))
    sem = torch.from_numpy(sem)
    runs = []
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        model = PD.init_segmenter(torch.Generator().manual_seed(0)).to(
            dev, dtype)
        opt = torch.optim.AdamW(model.parameters(), LEARNING_RATE,
                                weight_decay=TD.WEIGHT_DECAY)
        runs.append(_adam_step(model, lambda: TD.weighted_cross_entropy(
            model, rgb.to(dev, dtype), sem.to(dev),
            weights.to(dev, dtype)), opt))
    _check_first_adam_step(*runs, grad_tol=UNET_GRAD_TOL)


def _search_dataset(d, n_tasks=4, size=24, c=54):
    rng = np.random.RandomState(0)
    d.mkdir()
    for tid in range(n_tasks):
        np.savez_compressed(
            d / f"task-{tid}.npz",
            tops0=rng.rand(2, size, size, c).astype(np.float16),
            cells0=rng.randint(0, size, (2, 2)).astype(np.int32),
            tops1=rng.rand(2, size, size, c).astype(np.float16),
            cells1=rng.randint(0, size, (1, 2)).astype(np.int32))


@pytest.mark.parametrize("conditioned", [False, True],
                         ids=["plain", "conditioned"])
def test_fit_twice_on_card_is_bit_equal(cuda, tmp_path, conditioned):
    """Two fits from one seed (forward and backward with deterministic
    cuDNN and no TF32) save equal parameters bit for bit."""
    from mass_tpu_torch.search import train as ST

    _search_dataset(tmp_path / "data")
    paths = [str(tmp_path / f"p{k}.pth") for k in range(2)]
    for path in paths:
        ST.fit(str(tmp_path / "data"), path, steps=30, batch_size=4,
               log_every=10, val_fraction=0.25, conditioned=conditioned)
    a, b = (torch.load(p, map_location="cpu", weights_only=True)
            for p in paths)
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_unet_steps_twice_on_card_are_bit_equal(cuda):
    from mass_tpu_torch.perception import detector as PD
    from mass_tpu_torch.perception import train_detector as TD

    rng = np.random.RandomState(2)
    rgb = rng.rand(4, 32, 32, 3).astype(np.float32)
    sem = rng.randint(0, 54, (4, 32, 32))
    runs = []
    for _ in range(2):
        model = PD.init_segmenter(torch.Generator().manual_seed(0)).to(cuda)
        opt = torch.optim.AdamW(model.parameters(), LEARNING_RATE,
                                weight_decay=TD.WEIGHT_DECAY)
        step = TD.make_train_step(model, opt, TD.class_weights(sem))
        for _ in range(3):
            step(rgb, sem)
        runs.append(model.state_dict())
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key


def test_collector_launches_one_kernel_per_frame(cuda, monkeypatch):
    """A tiny collector task on the card: every walkthrough frame one
    multi-map launch (occupancy + semantic0), every unshuffle frame one
    single-map launch (semantic1); cells equal the CPU's, snapshots within
    one float16 ulp."""
    import dataclasses

    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
    from mass_tpu_torch.maps import layers as L
    from mass_tpu_torch.search import dataset as SD

    calls = []
    update_group = L.MapSet.update_group

    def recording(maps, names, observation):
        calls.append(tuple(names))
        return update_group(maps, names, observation)
    monkeypatch.setattr(L.MapSet, "update_group", recording)
    cfg = dataclasses.replace(SD.small_scene_config(
        32, map_height=48, map_width=48, map_depth=12, map_slice_stop=6),
        exploration_budget_one=2, exploration_budget_two=2)

    def collect(device):
        sampler = GridWorldTaskSampler([7], camera=cfg.camera, max_steps=80,
                                       num_objects=2, num_misplaced=1,
                                       num_opened=0)
        return SD.collect_task(sampler, cfg, np.random.RandomState(0),
                               device)
    single, multi = SP.LAUNCHES, SP.MULTI_LAUNCHES
    got = collect(cuda)
    torch.cuda.synchronize()
    pairs = calls.count(("occupancy", "semantic0"))
    ones = calls.count(("semantic1",))
    assert pairs + ones == len(calls) and pairs > 0 and ones > 0
    assert SP.MULTI_LAUNCHES - multi == pairs
    assert SP.LAUNCHES - single == ones
    want = collect("cpu")
    for key in ("cells0", "cells1"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("tops0", "tops1"):
        a, b = got[key], want[key]
        assert a.shape == b.shape
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
        assert (np.abs(a.astype(np.float32) - b.astype(np.float32))
                <= ulp).all()


# the Mask R-CNN trainer at the JAX tests' size (64 px, 3 classes, their
# caps and sampling counts); chip_smoke.py runs the same checks at 224 px
def _maskrcnn_small():
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception import maskrcnn_train as TR

    cfg = TM.MaskRCNNConfig(num_classes=3, image_size=64, pre_nms_topk=32,
                            post_nms_topk=16, candidate_pool=32,
                            max_detections=8)
    tcfg = TR.TrainConfig(max_gt=4, rpn_pos_samples=8, rpn_neg_samples=24,
                          roi_fg_samples=8, roi_bg_samples=24)
    return cfg, tcfg


def _instance_scenes(seed, n, side=64, max_gt=4):
    """``n`` frames, each with two bright rectangles of classes 0 and 1
    (the JAX tests' scene): (images, boxes, classes, masks, valid)."""
    rng = np.random.RandomState(seed)
    images = np.full((n, side, side, 3), 0.1, np.float32)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    classes = np.zeros((n, max_gt), np.int32)
    masks = np.zeros((n, max_gt, side, side), np.float32)
    valid = np.zeros((n, max_gt), bool)
    for f in range(n):
        for i in range(2):
            w, h = rng.randint(12, 20, 2)
            x = rng.randint(2, side - w - 2)
            y = rng.randint(2, side - h - 2)
            images[f, y:y + h, x:x + w, i] = 0.9
            boxes[f, i] = (x, y, x + w, y + h)
            classes[f, i] = i
            masks[f, i, y:y + h, x:x + w] = 1.0
            valid[f, i] = True
    return images, boxes, classes, masks, valid


def test_maskrcnn_train_step_on_card_matches_float64(cuda):
    """One step from flax's initialisation: the card's targets against
    float64's by the margin rule and equal to the CPU's float32 sampling,
    the five losses within rtol 1e-4 and every gradient within 1e-4 of
    the largest of a float64 step on the card's targets."""
    import chip_smoke
    from mass_tpu_torch.perception import maskrcnn_train as TR
    from mass_tpu_torch.search import prng

    cfg, tcfg = _maskrcnn_small()
    model = TR.init_maskrcnn(torch.Generator().manual_seed(0), cfg)
    out = chip_smoke.maskrcnn_card_against_float64(
        model, _instance_scenes(0, 2), prng.PRNGKey(1), tcfg, cuda)
    assert out["margin"]["ok"], out["margin"]
    assert out["grad_err"] <= chip_smoke.MASKRCNN_TOL
    assert out["roi_foreground"] >= 2


def test_maskrcnn_train_steps_twice_on_card_are_bit_equal(cuda):
    """Three clipped SGD steps, twice from one seed: parameters, momentum
    and count equal bit for bit (the ROIAlign's backward sums its
    duplicates after a sort); one NMS launch a step."""
    from mass_tpu_torch.ops import detection as D
    from mass_tpu_torch.perception import maskrcnn_train as TR
    from mass_tpu_torch.search import prng

    cfg, tcfg = _maskrcnn_small()
    batch = _instance_scenes(1, 2)
    runs = []
    for _ in range(2):
        model = TR.init_maskrcnn(torch.Generator().manual_seed(0), cfg).to(
            cuda)
        opt = TR.SGD(model.named_parameters(), 0.0025, {1: 0.1, 2: 0.1})
        step = TR.make_train_step(model, opt, tcfg)
        key = prng.PRNGKey(3)
        before = D.LAUNCHES
        for _ in range(3):
            key, sub = prng.split(key)
            step(batch, sub)
        torch.cuda.synchronize()
        assert D.LAUNCHES == before + 3
        runs.append((model.state_dict(), opt.state_dict()))
    (a, opt_a), (b, opt_b) = runs
    assert opt_a["count"] == opt_b["count"] == 3
    for key in a:
        assert torch.equal(a[key], b[key]), key
    for key in opt_a["momentum"]:
        assert torch.equal(opt_a["momentum"][key], opt_b["momentum"][key]), key


def _sparse_map(device, seed: int, features: int = 54):
    """An 80x80x24 map of sparse seeded values (ties included)."""
    rng = np.random.RandomState(seed)
    grid = rng.rand(80, 80, 24, features).astype(np.float32)
    grid *= rng.rand(80, 80, 24, 1) < 0.1
    grid[5, 6, 3] = 0.5
    geo = MapGeometry(map_height=80, map_width=80, map_depth=24,
                      feature_size=features, grid_resolution=0.125)
    return VoxelMap.create(geo, (0.5, -1.0, 0.25), device).with_grid(
        torch.from_numpy(grid))


def test_renders_on_card_equal_cpu(cuda):
    """The video panels reduce the map on the card: the semantic render
    equals the CPU's, the density within 1e-6; the feature query within
    1e-5, its temperature of 100 scaling the cosines' rounding (1.2e-6
    seen on the card)."""
    from mass_tpu_torch.utils import visualization as V

    for features in (1, 54):
        cpu, card = _sparse_map("cpu", 0, features), _sparse_map(cuda, 0,
                                                                 features)
        kwargs = dict(position_cell=np.asarray([30, 41]), yaw=1.2,
                      path_cells=np.asarray([[3, 4], [30, 41]]),
                      z_start=2, z_stop=20)
        np.testing.assert_allclose(V.render_occupancy(card, **kwargs),
                                   V.render_occupancy(cpu, **kwargs),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(V.render_semantic(card, 0, 12),
                                  V.render_semantic(cpu, 0, 12))
    queries = np.random.RandomState(1).randn(2, 54).astype(np.float32)
    np.testing.assert_allclose(V.render_feature_query(card, queries),
                               V.render_feature_query(cpu, queries),
                               atol=1e-5, rtol=0)


def test_snapshot_of_card_map_equals_cpu(cuda, tmp_path):
    """write_map_snapshots casts a card map on the card: the npz equals
    the CPU map's bit for bit."""
    from mass_tpu_torch.agent import metrics as M

    paths = [M.write_map_snapshots(str(tmp_path / str(dev)), 3,
                                   {"semantic0": _sparse_map(dev, 2)})
             for dev in ("cpu", cuda)]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], key)


def test_replay_digest_on_card_equals_cpu(cuda, tmp_path):
    """A 12-frame capture replayed on the card and on the CPU: equal
    digests, two single-map launches a frame on the card."""
    from mass_tpu_torch.env import replay as R

    flags = ["--camera-size", "48", "--map-height", "80", "--map-width",
             "80", "--map-depth", "24", "--grid-resolution", "0.125",
             "--ground-truth-segmentation", "--start-task", "2"]
    path = str(tmp_path / "ep.npz")
    R.main(["capture", "--out", path, "--frames", "11"] + flags)
    SP.LAUNCHES = 0
    card = R.replay_digest(path, flags + ["--device", "cuda"])
    assert SP.LAUNCHES == 2 * card["frames"] == 24
    assert card == R.replay_digest(path, flags + ["--device", "cpu"])
