"""Learned-segmentation episodes through the port: the semantic image of
every step comes from a Mask R-CNN on random detectron2-layout weights
(``tests/torch_checkpoints.random_maskrcnn_state_dict``, 7 classes,
``tests/test_maskrcnn.py``'s small caps at a 48 px camera, detector
classes offset by 1 into the taxonomy, fusion threshold 0.2, at which
detections survive).  The port's agent is held against the JAX
package's ``RearrangementAgent`` on the same weights (results and every
action), and a B = 2 fleet, whose sensor sees both frames in one call,
against the sequential agent.  Tier-1 runs a few steps a phase; the
``slow`` tests run whole episodes."""

import dataclasses

import numpy as np
import pytest
import torch

from tests import torch_checkpoints as TC
from tests.test_maskrcnn import SMALL
from tests.test_torch_agent import jax_node_memo_held
from tests.test_torch_evaluator import GEO, _drift, _recording_sampler

THRESHOLD = 0.2
SEEDS = [2, 4]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small episodes run faster on one CPU thread (and several test
    workers share the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    return TC.random_maskrcnn_state_dict(0, SMALL.num_classes)


def _sensor(pkg: str, sd):
    cfg = dataclasses.replace(SMALL, image_size=48)
    if pkg == "jax":
        from mass_tpu.perception import maskrcnn as JM
        from mass_tpu.perception.segmentation import DetectorSegmentation
        model = JM.make_detector(JM.params_from_detectron2(sd, cfg), cfg,
                                 class_offset=1)
        return DetectorSegmentation(model, THRESHOLD)
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception.segmentation import DetectorSegmentation
    port = TM.MaskRCNNConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})
    model = TM.from_state_dict(sd, port, "cpu")
    return DetectorSegmentation(TM.make_detector(model, class_offset=1),
                                THRESHOLD)


def _config(pkg: str):
    if pkg == "jax":
        from mass_tpu.config import AgentConfig, CameraConfig, MatchConfig, \
            NavConfig
    else:
        from mass_tpu_torch.config import AgentConfig, CameraConfig, \
            MatchConfig, NavConfig
    return AgentConfig(
        camera=CameraConfig(height=48, width=48), **GEO,
        nav=NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                      map_slice_stop=12, graph_update_interval=5,
                      max_goal_steps=60),
        match=MatchConfig(contour_padding=0, confidence_threshold=0.1,
                          distance_threshold=0.2, max_instances=8),
        exploration_budget_one=1, exploration_budget_two=1,
        ground_truth_segmentation=False, ground_truth_disagreement=True,
        detection_threshold=THRESHOLD, start_task=0, total_tasks=1)


def _sequential(pkg: str, sd, seed: int, max_steps: int):
    """(results, actions) of one learned episode on task ``seed``, rng
    seed 100 + seed."""
    if pkg == "jax":
        from mass_tpu.agent.loop import RearrangementAgent
        from mass_tpu.perception.segmentation import SegmentationSampler
        kw = {}
    else:
        from mass_tpu_torch.agent.loop import RearrangementAgent
        from mass_tpu_torch.perception.segmentation import \
            SegmentationSampler
        kw = {"device": "cpu"}
    actions = []
    sampler = SegmentationSampler(
        _recording_sampler(pkg, seed, actions, max_steps), _sensor(pkg, sd))
    agent = RearrangementAgent(_config(pkg), sampler,
                               rng=np.random.RandomState(100 + seed), **kw)
    with jax_node_memo_held():
        return agent.run_task(0), actions


def _fleet(sd, max_steps: int):
    """(results, actions, evaluator) of a B = 2 port fleet over SEEDS with
    the learned sensor."""
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    actions = [[] for _ in SEEDS]
    samplers = [_recording_sampler("torch", s, a, max_steps)
                for s, a in zip(SEEDS, actions)]
    evaluator = FleetEvaluator(_config("torch"), samplers,
                               seeds=[100 + s for s in SEEDS],
                               sensor=_sensor("torch", sd), device="cpu")
    return evaluator.run(), actions, evaluator


def _check_against_jax(sd, max_steps):
    got, got_actions = _sequential("torch", sd, 2, max_steps)
    want, want_actions = _sequential("jax", sd, 2, max_steps)
    assert got_actions == want_actions and len(got_actions) > 10
    assert not _drift(got, want)
    return got


def _check_fleet(sd, max_steps):
    results, actions, evaluator = _fleet(sd, max_steps)
    assert evaluator.timer.counts["segmentation"] == \
        evaluator.timer.counts["mapping"]
    for s, got, got_actions in zip(SEEDS, results, actions):
        want, want_actions = _sequential("torch", sd, s, max_steps)
        assert got_actions == want_actions and len(got_actions) > 10
        assert not _drift(got, want), s
    return results


def test_learned_steps_match_jax_agent(weights):
    """A few steps a phase (the task's step budget cut to 12)."""
    _check_against_jax(weights, 12)


def test_learned_fleet_steps_equal_sequential(weights):
    _check_fleet(weights, 12)


@pytest.mark.slow
def test_learned_episode_matches_jax_agent(weights):
    got = _check_against_jax(weights, 250)
    assert got["timing"]["mapping"]["count"] > 30


@pytest.mark.slow
def test_learned_fleet_equals_sequential(weights):
    _check_fleet(weights, 250)
