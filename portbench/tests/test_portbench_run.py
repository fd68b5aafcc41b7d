"""Whole runs at the tiny size on the CPU: a well-formed result line, a
refusal without a card, and ``correct`` false when the timed path is
broken underneath or the control stands in its place."""

import json

import pytest
import torch

from portbench import run
from portbench.bench import Bench
from portbench.control import ControlSystem
from portbench.tests import faults
from portbench.tests.tiny import tiny_root

SEMANTIC, LEARNED = "semantic-384.fleet8", "learned-384.fleet8"
FEATURES = "features-384.fleet2"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    return Bench(tiny_root(str(tmp_path_factory.mktemp("tiny"))))


def test_without_a_card_the_run_exits_nonzero_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = run.main(["--workload", SEMANTIC, "--seed", "1", "--seconds",
                     "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload, traced", [(SEMANTIC, 0), (SEMANTIC, 1),
                                              (LEARNED, 1), (FEATURES, 1)])
def test_a_tiny_run_prints_a_well_formed_correct_result(bench, workload,
                                                        traced):
    result, checks = run.run_cell(bench, workload, 2 ** 31 + 99, 0.5,
                                  bool(traced), "cpu")
    line = json.loads(json.dumps(result, default=run._plain))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 4
    counts = line["counts"]
    assert counts["plans"] > 0 and counts["meshes"] > 0
    names = {m["name"] for m in bench.metrics(workload, bool(traced))}
    assert set(line["metrics"]) <= names
    if traced:
        assert "planning.host_ms" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"agent_steps_per_s", "setup_s", "peak_mem_gib"} \
            <= set(line["metrics"])
    if workload == LEARNED:
        assert counts["frames"] > 0 and "score_gap" in checks
    if workload == FEATURES:
        assert counts["feature_frames"] > 0
        assert counts["reference_feature_voxels"] > 0
        assert {"feature_gap", "feature_map_gap"} <= set(checks)
        assert "mfu" in line["metrics"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(bench, fault, monkeypatch):
    # one card: no exchange between chips to leave out
    faults.plant(fault, monkeypatch)
    result, _ = run.run_cell(bench, SEMANTIC, 21, 0.3, False, "cpu")
    assert result["correct"] is False and result["failed"] >= 1


def test_a_class_altered_where_the_sensor_produces_it_is_not_correct(
        bench, monkeypatch):
    faults.plant("class_altered", monkeypatch)
    result, checks = run.run_cell(bench, LEARNED, 22, 0.3, False, "cpu")
    assert result["correct"] is False
    assert checks["class_pixels"]["value"] > checks["class_pixels"]["limit"]


@pytest.mark.parametrize("fault", ["dense_voxel_altered",
                                   "backbone_weight_perturbed"])
def test_a_broken_dense_path_is_not_correct(bench, fault, monkeypatch):
    faults.plant(fault, monkeypatch)
    result, checks = run.run_cell(bench, FEATURES, 24, 0.3, False, "cpu")
    assert result["correct"] is False
    assert checks["feature_map_gap"]["value"] \
        > checks["feature_map_gap"]["limit"]
    if fault == "backbone_weight_perturbed":
        assert checks["feature_gap"]["value"] > checks["feature_gap"]["limit"]


def test_the_dense_control_is_not_correct(bench):
    result, checks = run.run_cell(bench, FEATURES, 25, 0.3, False, "cpu",
                                  system_class=ControlSystem)
    assert result["correct"] is False
    assert checks["feature_map_gap"]["value"] \
        > checks["feature_map_gap"]["limit"]


def test_the_control_is_not_correct(bench):
    result, checks = run.run_cell(bench, SEMANTIC, 23, 0.3, False, "cpu",
                                  system_class=ControlSystem)
    assert result["correct"] is False
    assert checks["map_gap"]["value"] > checks["map_gap"]["limit"]
