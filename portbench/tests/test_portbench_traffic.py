"""The traffic generator: the same seed gives the same inputs, any whole
seed works, and the frames are renders of a closed room."""

import json
import os

import numpy as np
import pytest
import torch

from portbench.traffic import generator
from portbench.tests.tiny import BENCH, TINY_CONFIG, TINY_TRAFFIC

CONFIG = {**TINY_CONFIG, "vertical_fov": 90.0, "num_classes": 54,
          "sensor": {"image_size": 64}}
with open(os.path.join(BENCH, "traffic", "fleet8.json")) as f:
    TRAFFIC = {**json.load(f), **TINY_TRAFFIC}


def _same(a, b):
    for x, y in zip(a[:-1], b[:-1]):
        assert np.array_equal(x, y)
    assert a.weights.keys() == b.weights.keys()
    for k in a.weights:
        assert torch.equal(a.weights[k], b.weights[k]), k


@pytest.mark.parametrize("seed", [0, -5, 2 ** 31 + 17, 3_000_000_001,
                                  2 ** 63 + 9])
def test_the_same_seed_gives_the_same_inputs(seed):
    _same(generator.generate(TRAFFIC, CONFIG, seed, "cpu"),
          generator.generate(TRAFFIC, CONFIG, seed, "cpu"))


def _walks(inputs, episodes):
    """The episodes' frames, as a set."""
    return sorted(inputs.depth[:, e].tobytes() for e in episodes)


def test_seeds_deal_the_same_walks_to_each_phase_in_another_order():
    a = generator.generate(TRAFFIC, CONFIG, 1, "cpu")
    b = generator.generate(TRAFFIC, CONFIG, 5, "cpu")
    assert not np.array_equal(a.depth, b.depth)
    families = np.asarray(TRAFFIC["families"])
    for family in sorted(set(TRAFFIC["families"])):
        group = np.flatnonzero(families == family)
        assert _walks(a, group) == _walks(b, group)
    key = "roi_heads.box_head.fc1.weight"
    assert not torch.equal(a.weights[key], b.weights[key])
    c = generator.generate(TRAFFIC, CONFIG, 1, "cpu", world_seed=7)
    assert _walks(a, range(4)) != _walks(c, range(4))


def test_frames_render_a_closed_house():
    inp = generator.generate(TRAFFIC, CONFIG, 11, "cpu")
    T, B = TRAFFIC["frames_per_episode"], TRAFFIC["batch"]
    size = CONFIG["camera_size"]
    assert inp.rgb.shape == (T, B, size, size, 3)
    assert inp.rgb.dtype == np.uint8
    # a ceiling closes the house: every ray hits within its diagonal
    assert inp.depth.min() > 0 and inp.depth.max() < 9.0
    assert inp.classes.min() == 0 and inp.classes.max() < 54
    assert len(np.unique(inp.classes)) > 2
    # the walk stays inside the house and moves
    xy = inp.position[..., :2]
    assert xy.min() >= 0.2 and xy.max() <= 5.8
    assert len(np.unique(xy.reshape(-1, 2), axis=0)) > B
    assert np.array_equal(inp.origin, inp.position[0])
    assert inp.goals.shape == (T, B, 2) and inp.calls.shape == (T, B)


def test_the_walk_pursues_each_missions_goal():
    """Plans count up from a mission's start; the agent turns or moves one
    THOR step down the breadth-first field to the goal, and a mission ends
    on arrival or after ``max_goal_steps`` plans, without a step."""
    traffic = {**TRAFFIC, "frames_per_episode": 150, "max_goal_steps": 60}
    rng = generator._streams(3, 0)
    house = generator._house(rng, traffic, 54)
    poses, goals, calls = generator._walk(rng, traffic, house)
    assert calls[0] == 0 and calls.max() <= 59
    starts = np.flatnonzero(calls == 0)
    assert len(starts) >= 3
    for f in range(1, len(calls)):
        step = np.abs(poses[f, :2] - poses[f - 1, :2]).sum()
        turn = (poses[f, 2] - poses[f - 1, 2]) % 360
        if calls[f] == 0:
            # the last plan of a mission takes no step
            assert step == 0 and turn == 0
            continue
        assert calls[f] == calls[f - 1] + 1
        assert np.array_equal(goals[f], goals[f - 1])
        # one move of 0.25 m or one turn of 90 degrees
        assert (abs(step - 0.25) < 1e-9 and turn == 0) or \
            (step == 0 and turn in (90, 270))
        assert poses[f, 3] == traffic["horizon"]
    # arrivals: the agent stands within a move of the goal it ends on
    for f in starts[1:]:
        if calls[f - 1] < 59:
            assert np.abs(poses[f, :2] - goals[f - 1]).max() <= 0.1 + 1e-9
