"""The port's search-data tooling against the JAX package on the CPU:
``tools/search_labels.dump_labels`` (files equal) and
``search/dataset.collect_task`` (cells and counts exact, snapshots within
one float16 ulp), plus the collector's map groups and its entry point."""

import dataclasses
import os

import numpy as np
import pytest

from mass_tpu.config import CameraConfig as JCamera, MapGeometry as JGeometry
from mass_tpu.env.rearrange import GridWorldTaskSampler as JSampler
from mass_tpu.search import dataset as JD
from mass_tpu.tools.search_labels import dump_labels as jax_dump_labels
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
from mass_tpu_torch.maps import layers as L
from mass_tpu_torch.ops import splat as SP
from mass_tpu_torch.search import dataset as TD
from mass_tpu_torch.tools import search_labels as TL


def test_dump_labels_files_equal_jax(tmp_path):
    """At the JAX test's geometry (64x64x16 at 0.2 m, camera 32, tasks
    0-1): the same files, arrays and dtypes."""
    n = TL.dump_labels(
        GridWorldTaskSampler([0, 1], camera=CameraConfig(32, 32)),
        MapGeometry(64, 64, 16, grid_resolution=0.2), str(tmp_path / "port"),
        0, 2, device="cpu")
    m = jax_dump_labels(JSampler([0, 1], camera=JCamera(32, 32)),
                        JGeometry(64, 64, 16, grid_resolution=0.2),
                        str(tmp_path / "jax"), 0, 2)
    assert n == m >= 1
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert any(f.startswith("walkthrough-labels") for f in files)
    for name in files:
        got = np.load(tmp_path / "port" / name)
        want = np.load(tmp_path / "jax" / name)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.ndim == 2 and got.shape[1] == 3
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_search_labels_refuses_thor(tmp_path):
    """``--backend thor`` (no longer refused) labels THOR's own task specs:
    on the grid-backed fake of the THOR stack, the files of the grid
    world's tasks 0-1 of the same scenes."""
    from tests import torch_fake_thor

    geo = ["--map-height", "64", "--map-width", "64", "--map-depth", "16",
           "--grid-resolution", "0.2", "--camera-size", "32", "--device",
           "cpu", "--total-tasks", "2"]
    with torch_fake_thor.installed(torch_fake_thor.GridBackedSampler):
        TL.main(["--logdir", str(tmp_path / "thor"), "--backend", "thor"]
                + geo)
    n = TL.dump_labels(
        GridWorldTaskSampler([0, 1], camera=CameraConfig(32, 32),
                             **torch_fake_thor.SCENE_KW),
        MapGeometry(64, 64, 16, grid_resolution=0.2),
        str(tmp_path / "grid"), 0, 2, device="cpu")
    files = sorted(os.listdir(tmp_path / "thor"))
    assert n >= 1 and files == sorted(os.listdir(tmp_path / "grid"))
    for name in files:
        np.testing.assert_array_equal(np.load(tmp_path / "thor" / name),
                                      np.load(tmp_path / "grid" / name))


TINY = dict(map_height=48, map_width=48, map_depth=12, grid_resolution=0.125,
            step_size=2, obstacle_padding=2, map_slice_start=0,
            map_slice_stop=6)


def _config(module, camera=32, budget=2, **geometry):
    return dataclasses.replace(
        module.small_scene_config(camera, **(geometry or TINY)),
        exploration_budget_one=budget, exploration_budget_two=budget)


def _sampler(cls, config, task, max_steps=80):
    return cls([task], camera=config.camera, max_steps=max_steps,
               num_objects=2, num_misplaced=1, num_opened=0)


def _within_one_ulp(got, want):
    """Float16 snapshots equal but for one float16 ulp of the larger."""
    assert got.dtype == want.dtype == np.float16
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(
        np.float32)
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (diff <= ulp).all(), float(diff.max())


@pytest.mark.parametrize("task", [7, 3])
def test_collect_task_matches_jax(task):
    """A 48x48x12 map, camera 32, budgets 2+2, as the JAX collector runs
    it: the same snapshot counts and label cells, each snapshot within
    one float16 ulp (the splat sums in another order)."""
    want = JD.collect_task(_sampler(JSampler, _config(JD), task),
                           _config(JD), np.random.RandomState(0))
    got = TD.collect_task(_sampler(GridWorldTaskSampler, _config(TD), task),
                          _config(TD), np.random.RandomState(0), "cpu")
    assert sorted(got) == sorted(want) == ["cells0", "cells1", "tops0",
                                           "tops1"]
    for key in ("cells0", "cells1"):
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("tops0", "tops1"):
        assert got[key].shape == want[key].shape
        assert (want[key] != 0).any()
        _within_one_ulp(got[key], want[key])


def test_collect_task_structure_and_map_groups(monkeypatch):
    """Port only, tiny: shapes and dtypes, ``tops1`` led by the empty
    decision-time map, cells inside the map; every walkthrough frame
    folds into occupancy and semantic0 in one group, every unshuffle
    frame into semantic1 alone; on the CPU no kernel launches."""
    calls = []
    update_group = L.MapSet.update_group

    def recording(maps, names, observation):
        calls.append(tuple(names))
        return update_group(maps, names, observation)
    monkeypatch.setattr(L.MapSet, "update_group", recording)
    before = (SP.LAUNCHES, SP.MULTI_LAUNCHES)
    geometry = dict(TINY, map_height=24, map_width=24, map_depth=8,
                    map_slice_stop=4)
    cfg = _config(TD, camera=16, budget=1, **geometry)
    data = TD.collect_task(_sampler(GridWorldTaskSampler, cfg, 2, 30), cfg,
                           np.random.RandomState(0), "cpu")
    assert data["tops0"].shape == (1, 24, 24, 54)
    assert data["tops1"].shape == (2, 24, 24, 54)
    assert data["tops0"].dtype == data["tops1"].dtype == np.float16
    assert not data["tops1"][0].any() and data["tops0"].any()
    for key in ("cells0", "cells1"):
        assert data[key].dtype == np.int32 and data[key].shape[1] == 2
        assert (data[key] >= 0).all() and (data[key] < 24).all()
    assert set(calls) == {("occupancy", "semantic0"), ("semantic1",)}
    walk = calls.index(("semantic1",))
    assert all(c == ("occupancy", "semantic0") for c in calls[:walk])
    assert all(c == ("semantic1",) for c in calls[walk:])
    assert (SP.LAUNCHES, SP.MULTI_LAUNCHES) == before


def test_collector_main_writes_tasks_on_the_cpu(tmp_path, capsys):
    args = ["--logdir", str(tmp_path), "--total-tasks", "2",
            "--camera-size", "16", "--map-height", "24", "--map-width", "24",
            "--map-depth", "8", "--map-slice-stop", "4", "--max-steps", "20",
            "--exploration-goals", "1", "--platform", "cpu"]
    TD.main(args)
    assert sorted(os.listdir(tmp_path)) == ["task-0.npz", "task-1.npz"]
    with np.load(tmp_path / "task-0.npz") as z:
        assert z["tops0"].shape[1:] == (24, 24, 54)
        assert len(z["tops1"]) == 2
    assert "task 0: " in capsys.readouterr().out
    TD.main(args)                          # done tasks are skipped
    assert capsys.readouterr().out == ""
