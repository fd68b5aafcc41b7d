"""The port's results tools (``mass_tpu_torch.tools.analyze``,
``submission``, ``color_mappings`` and ``visualize_dataset``) against
the JAX package's on the same logdirs: the cases of
``tests/test_tools.py`` (its labels, dataset and snapshot cases are
mirrored in ``test_torch_search_data.py``, ``test_torch_train_detector.py``
and ``test_torch_snapshots.py``), each table equal to the JAX tool's."""

import csv
import gzip
import json
import os

import numpy as np

from mass_tpu.tools import analyze as JA
from mass_tpu.tools import submission as JS
from mass_tpu_torch.tools import analyze, submission


def _fake_results(tmp_path, name, records):
    d = tmp_path / name / "results"
    d.mkdir(parents=True)
    for i, rec in enumerate(records):
        with open(d / f"{i}.json", "w") as f:
            json.dump(rec, f)
    return str(tmp_path / name)


def _equal(got, want):
    """Nested tables equal (numpy arrays element for element)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want or (got != got and want != want), (got, want)


def test_submission_and_analysis(tmp_path):
    records = [
        {"unshuffle/prop_fixed_strict": 1.0, "unshuffle/success": 1.0,
         "unshuffle/num_initially_misplaced": 2,
         "unshuffle/num_newly_misplaced": 0,
         "unshuffle/objects_moved": ["Mug"],
         "unshuffle/objects_moved_accuracy": [1],
         "unshuffle/objects_to_move": ["Mug"],
         "unshuffle/objects_to_move_accuracy": [1],
         "unshuffle/ep_length": 80, "task_id": 0},
        {"unshuffle/prop_fixed_strict": 0.0, "unshuffle/success": 0.0,
         "unshuffle/num_initially_misplaced": 1,
         "unshuffle/num_newly_misplaced": 1,
         "unshuffle/objects_moved": ["Pen"],
         "unshuffle/objects_moved_accuracy": [0],
         "unshuffle/objects_to_move": ["Mug"],
         "unshuffle/objects_to_move_accuracy": [0],
         "unshuffle/ep_length": 250, "task_id": 1,
         "walkthrough_actions": ["move_ahead"],
         "walkthrough_actions_taken": [True]},
    ]
    logdir = _fake_results(tmp_path, "run-a", records)

    packed = {}
    for name, tool in (("port", submission), ("jax", JS)):
        out = tmp_path / f"{name}.json.gz"
        tool.main(["--logdirs", logdir, "--output", str(out)])
        with gzip.open(out, "rt") as f:
            packed[name] = json.load(f)
    assert len(packed["port"]) == 2
    assert packed["port"]["1"]["walkthrough_actions"][-1] == "done"
    assert packed["port"] == packed["jax"]

    table = analyze.metrics_table([logdir])
    mean, ci = table[logdir]["unshuffle/prop_fixed_strict"]
    assert abs(mean - 0.5) < 1e-6 and ci > 0
    _equal(table, JA.metrics_table([logdir]))

    pr = analyze.precision_recall([logdir])
    assert pr["Mug"]["tp"] == 1 and pr["Mug"]["fn"] == 1
    assert pr["Pen"]["fp"] == 1
    _equal(pr, JA.precision_recall([logdir]))

    modes = analyze.failure_modes([logdir])
    assert modes["TaskSolved"] == 1
    assert modes["IncorrectObjectRearranged"] == 1
    _equal(modes, JA.failure_modes([logdir]))


def _rec(fixed):
    return {"unshuffle/prop_fixed_strict": fixed,
            "unshuffle/success": float(fixed == 1.0),
            "unshuffle/num_initially_misplaced": 1,
            "unshuffle/num_newly_misplaced": 0}


def test_ablation_sweep(tmp_path):
    """ablation groups logdirs by a swept params-*.json value and
    aggregates metric curves; the plots render from the same logdirs."""
    dirs = []
    for name, budget, recs in (
            ("b2-a", 2, [_rec(0.0), _rec(0.5)]),
            ("b2-b", 2, [_rec(0.5)]),
            ("b6", 6, [_rec(1.0), _rec(1.0)])):
        d = _fake_results(tmp_path, name, recs)
        with open(os.path.join(d, "params-0-1.json"), "w") as f:
            json.dump({"exploration_budget_one": budget}, f)
        dirs.append(d)

    tables = analyze.ablation_table(dirs, "exploration_budget_one")
    table = tables[None]
    assert list(table) == [2, 6]
    assert table[2]["_n"] == 3
    m2, _ = table[2]["unshuffle/prop_fixed_strict"]
    m6, _ = table[6]["unshuffle/prop_fixed_strict"]
    assert abs(m2 - 1.0 / 3) < 1e-6 and m6 == 1.0
    _equal(tables, JA.ablation_table(dirs, "exploration_budget_one"))

    out = tmp_path / "curves.png"
    analyze._plot_curves(tables, "exploration_budget_one", str(out))
    assert out.exists() and out.stat().st_size > 0

    for d, ckpt in zip(dirs, ("p.pth", "p.pth", None)):
        with open(os.path.join(d, "params-0-1.json")) as f:
            params = json.load(f)
        params["policy_checkpoint"] = ckpt
        with open(os.path.join(d, "params-0-1.json"), "w") as f:
            json.dump(params, f)
    grouped = analyze.ablation_table(dirs, "exploration_budget_one",
                                     group_by="policy_checkpoint")
    assert set(grouped) == {"p.pth", "off"}
    assert list(grouped["p.pth"]) == [2] and list(grouped["off"]) == [6]
    _equal(grouped, JA.ablation_table(dirs, "exploration_budget_one",
                                      group_by="policy_checkpoint"))
    out2 = tmp_path / "curves2.png"
    analyze._plot_curves(grouped, "exploration_budget_one", str(out2))
    assert out2.exists() and out2.stat().st_size > 0

    fail_png = tmp_path / "failures.png"
    analyze._plot_failure_modes(
        {d: analyze.failure_modes([d]) for d in dirs}, str(fail_png))
    assert fail_png.exists() and fail_png.stat().st_size > 0
    pr_png = tmp_path / "pr.png"
    stats = {"Mug": dict(precision=0.5, recall=1.0, tp=1, fp=1, fn=0)}
    analyze._plot_precision_recall(stats, str(pr_png))
    assert pr_png.exists() and pr_png.stat().st_size > 0


DIST = np.asarray([[3.0, 2.0, 0.5, 0.4], [5.0, 4.0, 3.0, 0.9]])


def test_found_objects_curve(tmp_path, capsys):
    d = tmp_path / "results"
    d.mkdir()
    np.save(d / "objects-found-walkthrough-0.npy", DIST)
    curves = analyze.found_objects_curves(str(tmp_path))
    np.testing.assert_allclose(curves["walkthrough"], [0, 0, 0.5, 1.0])
    _equal(curves, JA.found_objects_curves(str(tmp_path)))
    d2 = tmp_path / "arm-b" / "results"
    d2.mkdir(parents=True)
    np.save(d2 / "objects-found-walkthrough-0.npy", DIST)
    np.save(d2 / "objects-found-walkthrough-1.npy", DIST * 0.25)
    stats = analyze.found_objects_stats(str(tmp_path / "arm-b"))
    mean, sem, n = stats["walkthrough"]
    assert n == 2 and sem.shape == mean.shape
    np.testing.assert_allclose(mean, [0.25, 0.5, 0.75, 1.0])
    np.testing.assert_allclose(sem[0], 0.25)
    _equal(stats, JA.found_objects_stats(str(tmp_path / "arm-b")))
    out = tmp_path / "found.png"
    argv = ["found", str(tmp_path), str(tmp_path / "arm-b")]
    analyze.main(argv + ["--out", str(out)])
    assert out.exists() and out.stat().st_size > 0
    capsys.readouterr()
    analyze.main(argv)
    port = capsys.readouterr().out
    JA.main(argv)
    assert port == capsys.readouterr().out


def test_found_objects_radius_sweep(tmp_path, capsys):
    d = tmp_path / "results"
    d.mkdir()
    np.save(d / "objects-found-unshuffle-0.npy", DIST)
    np.save(d / "objects-found-unshuffle-1.npy", DIST * 4)
    sweep = analyze.final_found_rate_by_radius(
        str(tmp_path), [0.5, 1.0, 2.0])
    rates = {r: mean for r, mean, _, n in sweep["unshuffle"]}
    assert all(n == 2 for *_, n in sweep["unshuffle"])
    assert (rates[0.5], rates[1.0], rates[2.0]) == (0.25, 0.5, 0.75)
    _equal(sweep, JA.final_found_rate_by_radius(str(tmp_path),
                                                [0.5, 1.0, 2.0]))
    out = tmp_path / "sweep.png"
    analyze.main(["found", str(tmp_path), "--radii", "0.5,1,2",
                  "--out", str(out)])
    assert out.exists() and out.stat().st_size > 0
    capsys.readouterr()


def test_found_objects_per_class(tmp_path):
    d = tmp_path / "results"
    d.mkdir()
    np.save(d / "objects-found-unshuffle-0.npy", DIST)
    with open(d / "objects-found-unshuffle-0-types.json", "w") as f:
        json.dump(["Mug", "Spoon"], f)
    np.save(d / "objects-found-unshuffle-1.npy",
            np.asarray([[9.0, 9.0, 9.0]]))
    with open(d / "objects-found-unshuffle-1-types.json", "w") as f:
        json.dump(["Mug"], f)
    np.save(d / "objects-found-unshuffle-2.npy", DIST)  # no sidecar
    stats = analyze.found_objects_stats_by_class(str(tmp_path))
    mug_mean, _, mug_n = stats["unshuffle"]["Mug"]
    spoon_mean, _, spoon_n = stats["unshuffle"]["Spoon"]
    assert mug_n == 2 and spoon_n == 1
    np.testing.assert_allclose(spoon_mean, [0, 0, 0, 1.0])
    np.testing.assert_allclose(mug_mean, [0, 0, 0.5, 0.5])
    _equal(stats, JA.found_objects_stats_by_class(str(tmp_path)))
    out = tmp_path / "classes.png"
    analyze.main(["found", str(tmp_path), "--per-class", "--out",
                  str(out)])
    assert out.exists() and out.stat().st_size > 0


def _write_analytics(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[""] + list(rows[0]))
        w.writeheader()
        for i, r in enumerate(rows):
            w.writerow({"": i, **r})


def test_object_analytics_aggregation(tmp_path):
    d = tmp_path / "results"
    d.mkdir()
    _write_analytics(d / "analytics-0.csv", [
        dict(type="Mug", initial_correct=False, final_correct=True,
             initial_distance=1.0, final_distance=0.05),
        dict(type="Mug", initial_correct=False, final_correct=False,
             initial_distance=2.0, final_distance=1.9),
        dict(type="Pen", initial_correct=True, final_correct=True,
             initial_distance=0.0, final_distance=0.0)])
    table = analyze.object_analytics([str(tmp_path)])
    assert table.loc["Mug", "count"] == 2
    assert abs(table.loc["Mug", "fixed_rate"] - 0.5) < 1e-9
    assert "Pen" not in table.index
    assert table.equals(JA.object_analytics([str(tmp_path)]))


def test_analytics_fix_rate_plot(tmp_path):
    d = tmp_path / "results"
    d.mkdir()
    rng = np.random.RandomState(0)
    _write_analytics(d / "analytics-0.csv", [
        dict(type="Mug", initial_correct=False, final_correct=bool(i % 2),
             initial_distance=float(rng.uniform(0.5, 3.0)),
             final_distance=0.1, size=float(rng.uniform(0.01, 0.2)),
             initial_min_distance_type="") for i in range(12)])
    out = tmp_path / "analytics.png"
    analyze._plot_analytics([str(tmp_path)], str(out), bins=4)
    assert out.exists() and out.stat().st_size > 0


def test_paired_compare(tmp_path):
    a = _fake_results(tmp_path, "arm-a",
                      [_rec(v) for v in (1, 1, 1, 1, 1, 0, 1, 0)])
    b = _fake_results(tmp_path, "arm-b",
                      [_rec(v) for v in (0, 0, 0, 0, 0, 1, 1, 0)])
    with open(os.path.join(a, "results", "99.json"), "w") as f:
        json.dump(_rec(1.0), f)
    with open(os.path.join(a, "results",
                           "objects-found-unshuffle-0-types.json"),
              "w") as f:
        json.dump(["Mug", "Laptop"], f)

    out = analyze.paired_compare(a, b)
    assert out["n"] == 8
    assert out["wins"] == 5 and out["losses"] == 1 and out["ties"] == 2
    assert abs(out["mcnemar_p"] - 2 * 7 / 64) < 1e-9
    assert abs(out["mean_a"][0] - 6 / 8) < 1e-9
    assert abs(out["mean_b"][0] - 2 / 8) < 1e-9
    _equal(out, JA.paired_compare(a, b))


def test_paired_found_compare(tmp_path):
    for arm, scale in (("arm-a", 1.0), ("arm-b", 4.0)):
        d = tmp_path / arm / "results"
        d.mkdir(parents=True)
        dist = np.asarray([[3.0, 0.5], [5.0, 0.8]]) * scale
        np.save(d / "objects-found-unshuffle-0.npy", dist)
        np.save(d / "objects-found-unshuffle-1.npy", dist * 0.1)
    np.save(tmp_path / "arm-a" / "results"
            / "objects-found-unshuffle-9.npy", np.asarray([[0.1, 0.1]]))
    a, b = str(tmp_path / "arm-a"), str(tmp_path / "arm-b")

    out = analyze.paired_found_compare(a, b, radius=1.0)
    assert out["n"] == 2
    assert abs(out["mean_a"][0] - 1.0) < 1e-9
    assert abs(out["mean_b"][0] - 0.5) < 1e-9
    assert abs(out["delta"] - 0.5) < 1e-9
    assert 0.0 < out["p"] <= 1.0
    _equal(out, JA.paired_found_compare(a, b, radius=1.0))
    tie = analyze.paired_found_compare(a, a, radius=1.0)
    assert tie["delta"] == 0.0 and tie["p"] == 1.0
    analyze.main(["compare", a, b, "--metric", "found:unshuffle",
                  "--radius", "1.0"])


def test_timing_aggregation(tmp_path, capsys):
    rdir = tmp_path / "results"
    rdir.mkdir()
    for tid, ms in ((0, 2.0), (1, 4.0)):
        (rdir / f"{tid}.json").write_text(json.dumps({
            "unshuffle/prop_fixed_strict": 1.0,
            "timing": {"mapping": {"total_s": ms / 1e3 * 10,
                                   "count": 10, "mean_ms": ms}}}))
    table = analyze.timing_table([str(tmp_path)])
    stages = table[tmp_path.name]
    assert stages["_tasks"] == 2
    assert stages["mapping"]["count"] == 20
    np.testing.assert_allclose(stages["mapping"]["mean_ms"], 3.0)
    np.testing.assert_allclose(stages["mapping"]["s_per_task"], 0.03)
    _equal(table, JA.timing_table([str(tmp_path)]))
    for command in ("timing", "metrics", "failures", "pr"):
        capsys.readouterr()
        analyze.main([command, str(tmp_path)])
        port = capsys.readouterr().out
        JA.main([command, str(tmp_path)])
        assert port == capsys.readouterr().out, command


def test_color_mappings_gridworld_and_thor(tmp_path):
    """The grid world's table is the taxonomy's, as JAX writes it; the
    THOR harvest reads each scene's object colours through the port's
    gateway (the contract fake's tasks carry none: an empty table)."""
    from mass_tpu.tools import color_mappings as JC
    from mass_tpu_torch.tools import color_mappings
    from tests import torch_fake_thor as F

    for tool, name in ((color_mappings, "port"), (JC, "jax")):
        tool.main(["--out", str(tmp_path / f"{name}.json")])
    with open(tmp_path / "port.json") as f, \
            open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)

    class _Colored(F.ContractSampler):
        def next_task(self):
            task = F.ContractTask()
            task.env.last_event.object_id_to_color = {
                "Mug|1|2|3": (1, 2, 3), "Nope|0": (0, 0, 0),
                "Mug|9": (7, 7, 7)}
            return task

    with F.installed(_Colored):
        got = color_mappings.harvest_thor(2)
        want = JC.harvest_thor(2)
    assert got == want == {"Mug": (1, 2, 3)}


def test_visualize_dataset_draws_records(tmp_path):
    """Annotations over a generated dataset's images, read through cv2."""
    from mass_tpu_torch.tools import detector_dataset, visualize_dataset

    detector_dataset.generate(str(tmp_path), total_tasks=1,
                              poses_per_scene=2, camera_size=32)
    detector_dataset.format_dataset(str(tmp_path), validation_fraction=0.2)
    out = tmp_path / "viz"
    visualize_dataset.main(["--dataset", str(tmp_path), "--out", str(out),
                            "--limit", "2"])
    pngs = sorted(os.listdir(out))
    assert pngs and all(p.startswith("viz-") for p in pngs)
    assert all((out / p).stat().st_size > 0 for p in pngs)
