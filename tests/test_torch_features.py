"""Feature matching through the port (``--use-feature-matching``) held
against the JAX package: pooled instance features (rtol 1e-5) and the
matcher's classes, pairs (exact) and goals (atol 1e-5) on the same maps;
a small episode of the frozen feature-matching protocol
(``experiments/fm/run_arm.sh``) through both agents, results and actions
equal; and, marked slow, tasks 0 and 2 of that protocol through both
CLIs and against the committed record, and a B = 2 feature fleet against
the sequential agent."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mass_tpu import taxonomy
from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.config import MatchConfig as JMatchConfig
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.match import differences as JD
from mass_tpu.match import find as JF
from mass_tpu_torch import convert
from mass_tpu_torch.config import MapGeometry, MatchConfig
from mass_tpu_torch.match import differences as TD
from mass_tpu_torch.match import find as TF
from tests import torch_checkpoints as TC
from tests.test_torch_agent import jax_node_memo_held

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE_PTH = TC.pth_path(TC.BACKBONE)
GEO = dict(map_height=40, map_width=48, map_depth=8, grid_resolution=0.1)
F = 16
PICK = taxonomy.ID_TO_PICKABLE.index(True)
OPEN = taxonomy.ID_TO_OPENABLE.index(True)

# two same-class, same-shape instances (A and B) in each map, each with
# its own embedding; A and B swap places between the maps, and their
# class mass swaps too (as partial views make it), so the size cost pairs
# A with B while the feature cost pairs A with A
BLOBS0 = [(4, 9, 4, 9, 2, 5, PICK, 0.9, 0), (20, 25, 30, 35, 1, 4, PICK,
                                             0.7, 1),
          (30, 35, 5, 12, 0, 6, OPEN, 0.8, 2)]
BLOBS1 = [(22, 27, 31, 36, 1, 4, PICK, 0.7, 0), (4, 9, 6, 11, 2, 5, PICK,
                                                 0.9, 1),
          (30, 35, 5, 12, 0, 6, OPEN, 0.8, 2)]
# world (x, y) of A and B in map 0 and map 1
A0, B0, A1, B1 = (-1.5, 1.1), (1.1, -0.5), (1.2, -0.7), (-1.3, 1.1)


def _maps(blobs0, blobs1):
    """The same semantic and feature maps in both packages: each blob a
    box of class mass and of its embedding (plus a little texture)."""
    out = []
    codes = np.random.RandomState(5).randn(3, F).astype(np.float32)
    for seed, blobs in enumerate((blobs0, blobs1)):
        rng = np.random.RandomState(20 + seed)
        sem = np.zeros((40, 48, 8, 54), np.float32)
        feat = np.zeros((40, 48, 8, F), np.float32)
        for y0, y1, x0, x1, z0, z1, cls, m, code in blobs:
            shape = (y1 - y0, x1 - x0, z1 - z0)
            sem[y0:y1, x0:x1, z0:z1, cls] = m * (0.9 + 0.1 * rng.rand(*shape))
            feat[y0:y1, x0:x1, z0:z1] = codes[code] + 0.05 * rng.randn(
                *shape, F)
        pair = []
        for grid, f in ((sem, 54), (feat, F)):
            jvm = JVoxelMap.create(
                JMapGeometry(feature_size=f, layout="vmajor", **GEO),
                (0.3, -0.2, 0.1)).with_grid(jnp.asarray(grid))
            tvm = convert.voxelmap_from_jax(
                np.asarray(jvm.data), np.asarray(jvm.bins_x),
                np.asarray(jvm.bins_y), np.asarray(jvm.bins_z),
                MapGeometry(feature_size=f, **GEO), device="cpu")
            pair.append((jvm, tvm))
        out.append(pair)
    return out


def test_pooled_features_match_jax():
    ((jsem, tsem), (jfeat, tfeat)), _ = _maps(BLOBS0, BLOBS1)
    kw = dict(confidence_threshold=0.1, contour_padding=0,
              contour_threshold=0.0, max_instances=4)
    ref = JF.find_class_instances(jsem, PICK, feature_map=jfeat, **kw)
    out = TF.find_class_instances(tsem, PICK, feature_map=tfeat, **kw)
    np.testing.assert_array_equal(out.present.numpy(),
                                  np.asarray(ref.present))
    assert out.features.shape == (4, F)
    np.testing.assert_allclose(out.features.numpy(),
                               np.asarray(ref.features), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(np.asarray(ref.features)[:2]).max() > 0.1
    # without a feature map nothing is pooled, as before
    assert TF.find_class_instances(tsem, PICK, **kw).features is None


def test_pooled_features_make_no_map_sized_temporary():
    """The pooling reads the feature map as a view and keeps only
    ``[H*W, F]`` of its own: a product over the ``[H, W, D]`` columns."""
    volume = torch.rand(5, 6, 7)
    feats = torch.rand(5 * 6 * 7, 3)
    roi = (torch.rand(2, 5, 6) > 0.5).float()
    denom = torch.tensor([2.0, 3.0])
    got = TF.pooled_features(volume, feats.view(5, 6, 7, 3), roi, denom)
    want = torch.einsum("khw,hwf->kf", roi, torch.einsum(
        "hwdf,hwd->hwf", feats.view(5, 6, 7, 3), volume)) / denom[:, None]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("features", [False, True])
def test_predict_scene_differences_with_features_matches_jax(features):
    """Size matching pairs the twins wrongly, feature matching rightly;
    the port makes the JAX package's choice either way."""
    ((j0, t0), (jf0, tf0)), ((j1, t1), (jf1, tf1)) = _maps(BLOBS0, BLOBS1)
    cfg = dict(contour_padding=0, confidence_threshold=0.1,
               distance_threshold=0.05, max_instances=4)
    cands = range(taxonomy.NUM_CLASSES)
    jc, jg0, jg1 = JD.predict_scene_differences(
        j0, j1, jf0 if features else None, jf1 if features else None,
        set(), cands, JMatchConfig(**cfg))
    tc, tg0, tg1 = TD.predict_scene_differences(
        t0, t1, tf0 if features else None, tf1 if features else None,
        set(), cands, MatchConfig(**cfg))
    assert tc == jc == PICK
    assert len(tg0) == len(jg0) and len(tg1) == len(jg1) and tg0
    np.testing.assert_allclose(np.stack(tg0), np.stack(jg0), atol=1e-5)
    np.testing.assert_allclose(np.stack(tg1), np.stack(jg1), atol=1e-5)
    pairs = {(tuple(round(float(v), 1) for v in a[:2]),
              tuple(round(float(v), 1) for v in b[:2]))
             for a, b in zip(tg0, tg1)}
    if features:
        assert pairs == {(A0, A1), (B0, B1)}
    else:
        assert pairs == {(A0, B1), (B0, A1)}


# experiments/fm/run_arm.sh, the frozen feature-matching protocol
FM_FLAGS = [
    "--backend", "gridworld", "--camera-size", "48", "--map-height", "80",
    "--map-width", "80", "--map-depth", "24", "--grid-resolution", "0.125",
    "--step-size", "2", "--obstacle-padding", "2", "--map-slice-start", "0",
    "--map-slice-stop", "12", "--room-size", "6", "--num-objects", "1",
    "--num-misplaced", "0", "--num-opened", "0",
    "--duplicate-class-pairs", "1", "--exploration-budget-one", "3",
    "--exploration-budget-two", "2", "--max-goal-steps", "60",
    "--max-steps", "500", "--ground-truth-segmentation",
    "--ground-truth-disagreement", "--ground-truth-semantic-search",
    "--use-feature-matching", "--total-tasks", "1"]


def _fm_episode(pkg: str, task: int):
    """Task ``task`` of the feature-matching protocol through the
    package's agent, with ``init_backbone()``'s weights; returns
    (results, actions)."""
    if pkg == "jax":
        from mass_tpu.agent import cli
        from mass_tpu.agent.loop import RearrangementAgent
        from mass_tpu.perception.resnet import make_backbone
        backbone = make_backbone(TC.backbone_variables())
        extra = {}
    else:
        from mass_tpu_torch.agent import cli
        from mass_tpu_torch.agent.loop import RearrangementAgent
        from mass_tpu_torch.perception.resnet import \
            load_backbone_checkpoint
        backbone = load_backbone_checkpoint(BACKBONE_PTH, "cpu")[0]
        extra = {"device": "cpu"}
    args = cli.build_parser().parse_args(
        FM_FLAGS + ["--start-task", str(task), "--logdir", ""])
    config = cli.config_from_args(args)
    sampler = cli.make_sampler(args, config)
    actions = []
    next_task = sampler.next_task

    def recording_next_task():
        t = next_task()
        step = t.step

        def recorded(action):
            actions.append(int(action))
            return step(action)
        t.step = recorded
        return t
    sampler.next_task = recording_next_task
    agent = RearrangementAgent(config, sampler,
                               rng=np.random.RandomState(0),
                               feature_backbone=backbone, **extra)
    with jax_node_memo_held():
        return agent.run_task(task), actions


def test_fm_episode_matches_jax_agent():
    """Task 0 of the feature-matching protocol: the port's agent takes
    the JAX agent's actions and reaches its results; its two feature
    maps were built (one backbone call and one dense splat per map
    update, here the plain version) and read by the matcher."""
    from mass_tpu_torch.ops import splat as SP

    got, got_actions = _fm_episode("torch", 0)
    assert SP.DENSE_LAUNCHES == 0              # CPU maps: plain version
    ref, ref_actions = _fm_episode("jax", 0)
    assert got_actions == ref_actions and len(got_actions) > 20
    drift = {k: (ref[k], got.get(k)) for k in ref
             if k != "timing" and ref[k] != got.get(k)}
    assert not drift
    assert got["unshuffle/success"] == 1.0
    assert got["timing"]["matching"]["count"] >= 1


def _cli_results(pkg: str, task: int, logdir: str, backbone: str) -> dict:
    if pkg == "jax":
        from mass_tpu.agent import cli
        flags = ["--platform", "cpu"]
    else:
        from mass_tpu_torch.agent import cli
        flags = ["--device", "cpu"]
    cli.main(FM_FLAGS + flags + ["--start-task", str(task), "--logdir",
                                 logdir, "--backbone-checkpoint", backbone])
    with open(os.path.join(logdir, "results", f"{task}.json")) as f:
        return json.load(f)


@pytest.fixture
def jax_backbone_dir(tmp_path):
    """``init_backbone()`` saved as the orbax tree the JAX CLI reads
    (experiments/fm/queue_r5b.sh's /tmp/backbone-rand)."""
    from mass_tpu.utils.checkpoint import save_pytree

    path = str(tmp_path / "backbone-rand")
    save_pytree(path, TC.backbone_variables())
    return path


@pytest.mark.slow
@pytest.mark.parametrize("task", [0, 2])
def test_fm_protocol_through_port_cli_matches_jax_cli(task, tmp_path,
                                                      jax_backbone_dir):
    """Tasks 0 and 2 of the protocol through the port's CLI equal the
    JAX CLI at HEAD on every field but timing (task 2: features fix the
    scene where size fails)."""
    got = _cli_results("torch", task, str(tmp_path / "torch"), BACKBONE_PTH)
    ref = _cli_results("jax", task, str(tmp_path / "jax"),
                       jax_backbone_dir)
    drift = {k: (ref[k], got.get(k)) for k in ref
             if k != "timing" and got.get(k) != ref[k]}
    assert not drift
    assert got["unshuffle/success"] == 1.0


@pytest.mark.slow
def test_fm_protocol_task0_through_port_equals_committed_record(tmp_path):
    with open(os.path.join(REPO, "experiments", "fm", "fm-features",
                           "results", "0.json")) as f:
        committed = json.load(f)
    got = _cli_results("torch", 0, str(tmp_path), BACKBONE_PTH)
    drift = {k: (committed[k], got.get(k)) for k in committed
             if k != "timing" and got.get(k) != committed[k]}
    assert not drift


def _pair_sampler(seed: int, actions: list):
    """A duplicate-pair scene of task ``seed`` (tests/test_evaluator.py's
    feature-fleet scenes) whose tasks append every action taken."""
    from mass_tpu_torch.config import CameraConfig
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    sampler = GridWorldTaskSampler(
        [seed], camera=CameraConfig(height=48, width=48), max_steps=250,
        num_objects=1, num_misplaced=0, num_opened=0,
        duplicate_class_pairs=1)
    next_task = sampler.next_task

    def recording_next_task():
        task = next_task()
        step = task.step

        def recorded(action):
            actions.append(int(action))
            return step(action)
        task.step = recorded
        return task
    sampler.next_task = recording_next_task
    return sampler


@pytest.mark.slow
def test_feature_fleet_matches_sequential_agent():
    """A B = 2 feature fleet (dense slabs, one batched backbone call per
    tick) reproduces the port's sequential agent task for task on
    duplicate-pair scenes (the port of tests/test_evaluator.py's
    feature-fleet check), results and actions equal."""
    from mass_tpu_torch.agent.loop import RearrangementAgent
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator
    from mass_tpu_torch.perception.resnet import load_backbone_checkpoint
    from tests.test_torch_evaluator import _config

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        backbone = load_backbone_checkpoint(BACKBONE_PTH, "cpu")[0]
        cfg = _config("torch", use_feature_matching=True)
        seeds = [5, 7]
        actions = [[] for _ in seeds]
        fleet = FleetEvaluator(
            cfg, [_pair_sampler(s, a) for s, a in zip(seeds, actions)],
            seeds=[100 + s for s in seeds], feature_backbone=backbone,
            device="cpu")
        fleet_results = fleet.run()
        for name in ("feature0", "feature1"):
            assert fleet.fleet.buffers[name].any()
        for k, s in enumerate(seeds):
            seq_actions = []
            agent = RearrangementAgent(
                cfg, _pair_sampler(s, seq_actions),
                rng=np.random.RandomState(100 + s), device="cpu",
                feature_backbone=backbone)
            want = agent.run_task(0)
            got = {k2: v for k2, v in fleet_results[k].items()
                   if k2 != "fleet_timing"}
            drift = {k2: (want[k2], got.get(k2)) for k2 in want
                     if k2 != "timing" and got.get(k2) != want[k2]}
            assert not drift, s
            assert actions[k] == seq_actions, s
    finally:
        torch.set_num_threads(threads)

