"""On the card: the tiny cells through the port's kernels are correct and
the control (TF32 detector, bfloat16 maps) is not; at the cells' own
sizes and check rate, each fault planted in the timed path comes out not
correct.  Run on the card with ``python -m pytest -s -m gpu
portbench/tests``: the full-size tests print each compared number beside
its limit."""

import gc
import json

import pytest
import torch

from portbench import run
from portbench.bench import Bench
from portbench.control import ControlSystem
from portbench.tests import faults
from portbench.tests.tiny import ROOT, tiny_root


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # a full-size run before this one may still hold the card's memory
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["semantic-384.fleet8",
                                      "learned-384.fleet8",
                                      "features-384.fleet2"])
def test_tiny_cells_on_the_card(tmp_path, workload):
    _card()
    bench = Bench(tiny_root(str(tmp_path)))
    result, _ = run.run_cell(bench, workload, 2 ** 31 + 5, 1.0, True,
                             "cuda:0")
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
    control, _ = run.run_cell(bench, workload, 2 ** 31 + 5, 1.0, False,
                              "cuda:0", system_class=ControlSystem)
    assert control["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("workload, fault", [
    ("semantic-384.fleet8", "answer_altered"),
    ("semantic-384.fleet8", "state_unchanged"),
    ("semantic-384.fleet8", "half_batch_left_out"),
    ("learned-384.fleet8", "class_altered"),
    ("features-384.fleet2", "dense_voxel_altered"),
    ("features-384.fleet2", "backbone_weight_perturbed")])
def test_a_fault_at_the_cells_own_size_is_not_correct(workload, fault,
                                                      monkeypatch):
    _card()
    faults.plant(fault, monkeypatch)
    result, checks = run.run_cell(Bench(ROOT), workload, 2 ** 32 + 77, 5.0,
                                  False, "cuda:0")
    print(json.dumps({"workload": workload, "fault": fault,
                      "counts": result["counts"], "checks": checks},
                     default=run._plain))
    assert result["correct"] is False
