"""The BFS distance field of ``nav.grid`` on the CPU: the plain
relaxation equals a breadth-first search over a deque on random batched,
ragged and degenerate meshes (exactly ``INF`` where no seed reaches), a
batch equals its meshes alone, a CPU mesh never loads or counts the CUDA
kernel (``csrc/bfs.cu``), and the kernel's wrapper refuses bad masks
before it reaches a card.  The kernel itself is held against the plain
relaxation in ``tests/test_torch_gpu.py``."""

from collections import deque

import numpy as np
import pytest
import torch

from mass_tpu_torch.nav import grid as NG
from mass_tpu_torch.ops import splat as SP

INF = NG.INF


def _deque_bfs(alive, er, ed, seeds):
    """Hop counts from the alive seeds over alive nodes, an edge joining
    two alive nodes inside the mesh; ``INF`` elsewhere."""
    ny, nx = alive.shape
    dist = np.full((ny, nx), INF, np.int32)
    queue = deque()
    for i, j in zip(*np.nonzero(seeds & alive)):
        dist[i, j] = 0
        queue.append((i, j))
    while queue:
        i, j = queue.popleft()
        for ni, nj, ok in ((i, j + 1, j + 1 < nx and er[i, j]),
                           (i, j - 1, j > 0 and er[i, j - 1]),
                           (i + 1, j, i + 1 < ny and ed[i, j]),
                           (i - 1, j, i > 0 and ed[i - 1, j])):
            if ok and alive[ni, nj] and dist[ni, nj] == INF:
                dist[ni, nj] = dist[i, j] + 1
                queue.append((ni, nj))
    return dist


def _random_masks(rng, shape, seed_share=0.03):
    """Random alive, edge and seed masks; edges leaving the mesh set too."""
    p_alive, p_edge = rng.uniform(0.4, 1.0), rng.uniform(0.4, 1.0)
    return (rng.rand(*shape) < p_alive, rng.rand(*shape) < p_edge,
            rng.rand(*shape) < p_edge, rng.rand(*shape) < seed_share)


def _field(masks):
    grid = NG.NavGrid(*(torch.from_numpy(m) for m in masks[:3]), off_x=0,
                      off_y=0, pruned=torch.zeros(masks[0].shape,
                                                  dtype=torch.bool))
    return NG.distance_field_from_seeds(
        grid, torch.from_numpy(masks[3])).numpy()


def _assert_equals_deque(masks):
    out = _field(masks)
    assert out.dtype == np.int32
    want = np.stack([_deque_bfs(*(m[g] for m in masks))
                     for g in range(masks[0].shape[0])]) \
        if masks[0].ndim == 3 else _deque_bfs(*masks)
    np.testing.assert_array_equal(out, want)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_plain_field_equals_a_deque_bfs_on_random_batches(seed):
    rng = np.random.RandomState(seed)
    shape = (int(rng.randint(1, 5)), int(rng.randint(2, 30)),
             int(rng.randint(2, 30)))
    out = _assert_equals_deque(_random_masks(rng, shape))
    assert ((out == INF) | (out < shape[1] * shape[2])).all()


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (13, 77),
                                   (3, 1, 40), (2, 40, 1)])
def test_plain_field_equals_a_deque_bfs_on_ragged_meshes(shape):
    _assert_equals_deque(_random_masks(np.random.RandomState(len(shape)),
                                       shape, seed_share=0.1))


def _walled(shape):
    """All alive and joined, but a dead wall down column 5: two
    components."""
    ones = np.ones(shape, bool)
    alive = ones.copy()
    alive[:, 5] = False
    return alive, ones.copy(), ones.copy()


def test_no_seed_reaches_nothing():
    alive, er, ed = _walled((6, 11))
    out = _assert_equals_deque((alive, er, ed, np.zeros((6, 11), bool)))
    assert (out == INF).all()


def test_seeds_on_dead_nodes_seed_nothing():
    alive, er, ed = _walled((6, 11))
    seeds = ~alive
    out = _assert_equals_deque((alive, er, ed, seeds))
    assert (out == INF).all()


def test_an_all_dead_mesh_is_all_inf():
    shape = (2, 7, 9)
    out = _assert_equals_deque((np.zeros(shape, bool), np.ones(shape, bool),
                                np.ones(shape, bool), np.ones(shape, bool)))
    assert (out == INF).all()


def test_disconnected_components_read_exactly_inf():
    alive, er, ed = _walled((6, 11))
    seeds = np.zeros((6, 11), bool)
    seeds[2, 1] = True
    out = _assert_equals_deque((alive, er, ed, seeds))
    assert (out[:, 5:] == INF).all()
    assert out[:, :5].max() == 3 + 3 and out[0, 0] == 2 + 1


def test_edges_leaving_the_mesh_join_nothing():
    shape = (4, 6)
    alive, er, ed = (np.ones(shape, bool) for _ in range(3))
    seeds = np.zeros(shape, bool)
    seeds[1, 0] = True
    out = _assert_equals_deque((alive, er, ed, seeds))
    # a wrap-around edge would put (1, 5) one hop from (1, 0)
    assert out[1, 5] == 5 and out[3, 0] == 2


@pytest.mark.parametrize("step", [2, 5])
def test_plain_field_of_built_and_refreshed_meshes(step):
    rng = np.random.RandomState(step)
    nav = rng.rand(60, 50) > 0.05
    nav[:, 25] = False
    nav[30:36, 25] = True
    grid = NG.build_nav_grid(torch.from_numpy(nav), 1, 0, step=step)
    nav[40, :] = False
    grid = NG.refresh_nav_grid(grid, torch.from_numpy(nav), step=step)
    seeds = NG.seeds_near_cell(grid, torch.tensor([3, 4]), step, 2 * step)
    assert bool(seeds.any())
    _assert_equals_deque(tuple(t.numpy() for t in (
        grid.alive, grid.edge_right, grid.edge_down, seeds)))


def test_a_batch_equals_its_meshes_alone():
    masks = _random_masks(np.random.RandomState(9), (4, 17, 23), 0.02)
    out = _field(masks)
    for g in range(4):
        np.testing.assert_array_equal(out[g], _field(tuple(m[g]
                                                           for m in masks)))


def test_a_cpu_mesh_never_touches_the_kernel(monkeypatch):
    def refuse(name):
        raise AssertionError(f"library {name} loaded for a CPU mesh")
    monkeypatch.setattr(SP, "_library", refuse)
    before = NG.BFS_LAUNCHES
    _assert_equals_deque(_random_masks(np.random.RandomState(3),
                                       (2, 12, 12), 0.05))
    grid = NG.build_nav_grid(torch.ones(20, 20, dtype=torch.bool), 0, 0,
                             step=2)
    NG.distance_field(grid, 3, 4)
    assert NG.BFS_LAUNCHES == before


def _meta(shape=(5, 6), dtype=torch.bool):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["dtype", "shape", "one_dim", "four_dims",
                                  "not_cuda", "mixed_devices"])
def test_kernel_wrapper_refuses_bad_masks(case, monkeypatch):
    def refuse(name):
        raise AssertionError("the library was loaded for bad masks")
    monkeypatch.setattr(SP, "_library", refuse)
    masks = [_meta() for _ in range(4)]
    if case == "dtype":
        masks[3] = _meta(dtype=torch.uint8)
    elif case == "shape":
        masks[1] = _meta((5, 7))
    elif case == "one_dim":
        masks = [_meta((30,)) for _ in range(4)]
    elif case == "four_dims":
        masks = [_meta((1, 2, 5, 6)) for _ in range(4)]
    elif case == "mixed_devices":
        masks[2] = torch.zeros((5, 6), dtype=torch.bool)
    before = NG.BFS_LAUNCHES
    with pytest.raises(ValueError, match="bfs kernel"):
        NG._bfs_kernel(*masks)
    assert NG.BFS_LAUNCHES == before


def test_a_mixed_cpu_mesh_goes_to_the_kernel_and_is_refused():
    masks = _random_masks(np.random.RandomState(1), (5, 6))
    grid = NG.NavGrid(*(torch.from_numpy(m) for m in masks[:3]), off_x=0,
                      off_y=0, pruned=torch.zeros(5, 6, dtype=torch.bool))
    with pytest.raises(ValueError, match="one CUDA device"):
        NG.distance_field_from_seeds(grid, _meta())



@pytest.mark.parametrize("step,off", [(1, 0), (2, 1), (5, 0), (5, 4)])
def test_built_meshes_have_no_edge_leaving_the_mesh(step, off):
    """No mesh the port builds or refreshes has an edge out of its last
    column or last row, even on a map navigable everywhere.  So the plain
    field, which drops such an edge, equals the JAX package's, whose
    roll would join it to the first node of its row or column."""
    nav = torch.ones(37, 41, dtype=torch.bool)
    built = NG.build_nav_grid(nav, off, off, step=step)
    for grid in (built, NG.refresh_nav_grid(built, nav, step=step),
                 NG.refresh_nav_grid(built, nav, step=step, monotone=True)):
        assert bool(grid.edge_right.any()) and bool(grid.edge_down.any())
        assert not bool(grid.edge_right[..., -1].any())
        assert not bool(grid.edge_down[..., -1, :].any())
