"""``--snapshot-maps`` on the port against the JAX package on the CPU:
``write_map_snapshots`` on the same grid (the npz equal), the CLI's npz
against the JAX CLI's (float16 grids within one float16 ulp: the splat
sums in another order; bins equal), and a B = 2 fleet's npz equal bit
for bit to the sequential port's."""

import numpy as np
import torch

from tests.test_torch_agent import SMALL, jax_node_memo_held
from tests.torch_one_thread import one_thread  # noqa: F401


def _within_one_ulp(got, want):
    """Float16 grids equal but for one float16 ulp of the larger."""
    assert got.dtype == want.dtype == np.float16
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(
        np.float32)
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (diff <= ulp).all(), float(diff.max())


def test_map_snapshots(tmp_path):
    """The JAX test's snapshot (``tests/test_tools.py::
    test_map_snapshots``) on the port, beside JAX's file of the same map:
    the same arrays, dtypes and shapes."""
    from mass_tpu.agent import metrics as JM
    from mass_tpu.config import MapGeometry as JGeometry
    from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
    from mass_tpu_torch.agent import metrics as M
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core.voxelmap import VoxelMap

    geo = dict(map_height=16, map_width=16, map_depth=4,
               grid_resolution=0.25, feature_size=8)
    grid = np.zeros((16, 16, 4, 8), np.float32)
    grid[3, 5, 1, 2] = 0.75
    # values that round differently to float16: ties to even, subnormals,
    # overflow to inf
    grid[0, 0, 0, :5] = [1 + 2 ** -11, 1 + 3 * 2 ** -11, 3e-6, 7e4, -1e5]
    vm = VoxelMap.create(MapGeometry(**geo), (1.0, 1.0, 0.5),
                         "cpu").with_grid(torch.from_numpy(grid))
    jvm = JVoxelMap.create(JGeometry(**geo), (1.0, 1.0, 0.5)).with_grid(
        grid)

    path = M.write_map_snapshots(str(tmp_path / "port"), 7,
                                 {"semantic0": vm})
    jpath = JM.write_map_snapshots(str(tmp_path / "jax"), 7,
                                   {"semantic0": jvm})
    assert path.endswith("maps-7.npz")
    with np.load(path) as z, np.load(jpath) as j:
        assert z["semantic0"].shape == (16, 16, 4, 8)
        assert z["semantic0"].dtype == np.float16
        np.testing.assert_allclose(z["semantic0"][3, 5, 1, 2], 0.75)
        assert z["semantic0_bins_x"].shape == vm.bins_x.shape
        assert sorted(z.files) == sorted(j.files)
        for name in z.files:
            assert z[name].dtype == j[name].dtype, name
            np.testing.assert_array_equal(z[name], j[name], err_msg=name)


def _cli(pkg: str, logdir, flags):
    if pkg == "jax":
        from mass_tpu.agent import cli
        flags = [f if f != "--device" else "--platform" for f in flags]
        with jax_node_memo_held():
            return cli.main(flags + ["--logdir", str(logdir)])
    from mass_tpu_torch.agent import cli
    return cli.main(flags + ["--logdir", str(logdir)])


def test_cli_snapshots_match_jax(tmp_path):
    """The CLI's tiny episode of task 2 (and under --reference-compat its
    occupancy map too) with --snapshot-maps: the port's npz holds JAX's
    arrays, grids within one float16 ulp, bins equal."""
    flags = SMALL + ["--snapshot-maps", "--start-task", "2",
                     "--total-tasks", "1"]
    for name, extra in (("default", []), ("compat", ["--reference-compat"])):
        _cli("torch", tmp_path / f"port-{name}", flags + extra)
        _cli("jax", tmp_path / f"jax-{name}", flags + extra)
        with np.load(tmp_path / f"port-{name}" / "results" / "maps-2.npz") \
                as z, np.load(tmp_path / f"jax-{name}" / "results"
                              / "maps-2.npz") as j:
            assert sorted(z.files) == sorted(j.files), name
            assert ("occupancy" in z.files) == bool(extra)
            for key in z.files:
                assert z[key].shape == j[key].shape, key
                if key.split("_bins_")[0] == key:
                    _within_one_ulp(z[key], j[key])
                    assert np.count_nonzero(z[key]) > 0, key
                else:
                    np.testing.assert_array_equal(z[key], j[key], key)


def test_fleet_snapshots_equal_sequential(tmp_path):
    """A --fleet-size 2 run of tasks 2-3 (rng seeds 0 and 1) writes the
    npz files of the sequential runs of task 2 with --seed 0 and task 3
    with --seed 1, bit for bit, under --reference-compat as well; its
    results carry task_id."""
    import json

    from mass_tpu_torch.agent import cli

    for name, extra in (("default", []), ("compat", ["--reference-compat"])):
        flags = SMALL + ["--snapshot-maps"] + extra
        fleet = tmp_path / f"fleet-{name}"
        cli.main(flags + ["--fleet-size", "2", "--start-task", "2",
                          "--total-tasks", "2", "--seed", "-2",
                          "--logdir", str(fleet)])
        for task in (2, 3):
            seq = tmp_path / f"seq-{name}-{task}"
            cli.main(flags + ["--start-task", str(task), "--total-tasks",
                              "1", "--seed", str(task - 2),
                              "--logdir", str(seq)])
            with np.load(fleet / "results" / f"maps-{task}.npz") as f, \
                    np.load(seq / "results" / f"maps-{task}.npz") as s:
                assert sorted(f.files) == sorted(s.files)
                for key in f.files:
                    assert f[key].dtype == s[key].dtype, key
                    np.testing.assert_array_equal(f[key], s[key], key)
            with open(fleet / "results" / f"{task}.json") as fh:
                assert json.load(fh)["task_id"] == task
