"""B = 2 fleets of the goal heads' episodes (tests/test_torch_heads.py's
configurations A, B and C) against the port's sequential agent on the
same seeds."""

import pytest

from tests.test_torch_heads import HEADS, _config, _drift, _episode, \
    _policy, _sampler, one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_fleet_equals_sequential_agent(head, monkeypatch):
    """B = 2 fleets (tasks 2 and 4, rng seeds 102 and 104) equal the
    sequential port agent on each seed: results apart from timing, every
    action and the number of map updates.  A one-phase tick makes a
    second batched update for the goal-fed map while it explores."""
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator
    from mass_tpu_torch.parallel.fleet import FleetMaps

    batches = []
    update_batch = FleetMaps.update_batch

    def counted(fleet, *args, **kwargs):
        batches.append(1)
        return update_batch(fleet, *args, **kwargs)
    monkeypatch.setattr(FleetMaps, "update_batch", counted)
    heads, policy = HEADS[head]
    one_phase = heads.get("one_phase", False)
    seeds = (2, 4)
    actions = [[] for _ in seeds]
    evaluator = FleetEvaluator(
        _config("torch", heads),
        [_sampler("torch", s, a, one_phase) for s, a in zip(seeds, actions)],
        seeds=[100 + s for s in seeds], device="cpu",
        **_policy("torch", policy))
    results = evaluator.run()
    ticks = evaluator.timer.counts["mapping"]
    assert len(batches) >= ticks
    assert (len(batches) > ticks) == one_phase
    for s, got, got_actions, ep in zip(seeds, results, actions,
                                       evaluator.episodes):
        want, want_actions = _episode("torch", head, seed=s,
                                      rng_seed=100 + s)
        assert not _drift(got, want), s
        assert got_actions == want_actions and len(got_actions) > 10
        assert ep.map_updates == want["timing"]["mapping"]["count"]
