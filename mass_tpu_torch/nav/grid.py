"""Grid navigation mesh as device masks + BFS distance fields (port of
``mass_tpu.nav.grid``).

Nodes sit every ``step`` cells of the navigation map (offset so the map
origin's cell owns a node); an edge joins two adjacent nodes when the
corridor between them is fully navigable; planning is breadth-first
search as a min-plus relaxation over three boolean masks.  Map-derived
state recomputes from the current navigable mask on refresh, while
failed-action prunes stay sticky in ``NavGrid.pruned``; ``monotone=True``
keeps the reference's only-ever-remove rule.  Path extraction backtracks
the distance field on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.ops.pool import max_pool2d_same

INF = 1 << 28


def navigable_area(vm: VoxelMap, padding: int = 3, z_start: int = 0,
                   z_stop: int = 32, obstacle_threshold: float = 0.0,
                   blocked: torch.Tensor = None) -> torch.Tensor:
    """``[H, W]`` bool — cells with no occupied voxel in the z slice,
    eroded by ``padding`` cells around obstacles; ``blocked`` cells
    (collision evidence) count as obstacles."""
    occ = vm.occupancy_mask(z_start, z_stop, obstacle_threshold)
    if blocked is not None:
        occ = occ | blocked
    if padding > 0:
        occ = max_pool2d_same(occ, padding)
    return ~occ


class NavGrid(NamedTuple):
    """Navigation mesh state.  Node ``(i, j)`` sits at map cell
    ``(y, x) = (off_y + i*step, off_x + j*step)``; ``edge_right[i, j]``
    joins (i, j)-(i, j+1) and ``edge_down[i, j]`` joins (i, j)-(i+1, j).
    The masks are ``[ny, nx]`` bool tensors; the offsets host ints."""

    alive: torch.Tensor
    edge_right: torch.Tensor
    edge_down: torch.Tensor
    off_x: int
    off_y: int
    pruned: torch.Tensor   # sticky failed-action node removals


def _node_cells(nav_h: int, nav_w: int, ny: int, nx: int, off_x: int,
                off_y: int, step: int, device):
    ys = off_y + torch.arange(ny, dtype=torch.int64, device=device) * step
    xs = off_x + torch.arange(nx, dtype=torch.int64, device=device) * step
    in_bounds = (ys[:, None] < nav_h) & (xs[None, :] < nav_w)
    return ys, xs, in_bounds


def _corridor_masks(navigable: torch.Tensor, ys, xs, in_bounds,
                    step: int):
    """Edge masks: the (step+1)-cell corridor between adjacent nodes
    must be fully navigable (window-all tests via integer cumsums)."""
    nav = navigable.to(torch.int32)
    h, w = navigable.shape
    cs_x = torch.nn.functional.pad(torch.cumsum(nav, dim=1), (1, 0))
    cs_y = torch.nn.functional.pad(torch.cumsum(nav, dim=0), (0, 0, 1, 0))

    def window_all_x(y_idx, x_idx):
        x0 = x_idx[None, :]
        hi = (x0 + step + 1).clamp(0, w)
        lo = x0.clamp(0, w)
        rows = y_idx[:, None]
        total = cs_x[rows, hi] - cs_x[rows, lo]
        return total >= hi - lo

    def window_all_y(y_idx, x_idx):
        y0 = y_idx[:, None]
        hi = (y0 + step + 1).clamp(0, h)
        lo = y0.clamp(0, h)
        cols = x_idx[None, :]
        total = cs_y[hi, cols] - cs_y[lo, cols]
        return total >= hi - lo

    ny, nx = ys.shape[0], xs.shape[0]
    right_ok = window_all_x(ys.clamp(0, h - 1), xs)
    down_ok = window_all_y(ys, xs.clamp(0, w - 1))
    has_right = in_bounds & torch.roll(in_bounds, -1, dims=1)
    has_right[:, nx - 1] = False
    has_down = in_bounds & torch.roll(in_bounds, -1, dims=0)
    has_down[ny - 1, :] = False
    return right_ok & has_right, down_ok & has_down


def grid_shape(map_height: int, map_width: int,
               step: int) -> Tuple[int, int]:
    return (map_height + step - 1) // step, \
        (map_width + step - 1) // step


def build_nav_grid(navigable: torch.Tensor, off_x: int, off_y: int,
                   step: int = 5) -> NavGrid:
    """Fresh mesh from a navigable-area mask; isolated nodes simply stay
    unreachable."""
    h, w = navigable.shape
    ny, nx = grid_shape(h, w, step)
    ys, xs, in_bounds = _node_cells(h, w, ny, nx, off_x, off_y, step,
                                    navigable.device)
    er, ed = _corridor_masks(navigable, ys, xs, in_bounds, step)
    return NavGrid(alive=in_bounds, edge_right=er, edge_down=ed,
                   off_x=int(off_x), off_y=int(off_y),
                   pruned=torch.zeros_like(in_bounds))


def refresh_nav_grid(grid: NavGrid, navigable: torch.Tensor,
                     step: int = 5, monotone: bool = False) -> NavGrid:
    """Refresh the mesh from the current navigable mask: node cells and
    corridors recompute (the EMA map can clear), failed-action prunes
    stay.  ``monotone=True`` only ever removes nodes and edges."""
    h, w = navigable.shape
    ny, nx = grid.alive.shape
    ys, xs, in_bounds = _node_cells(h, w, ny, nx, grid.off_x, grid.off_y,
                                    step, navigable.device)
    node_ok = navigable[ys.clamp(0, h - 1)[:, None],
                        xs.clamp(0, w - 1)[None, :]] & in_bounds
    er, ed = _corridor_masks(navigable, ys, xs, in_bounds, step)
    if monotone:
        return grid._replace(alive=grid.alive & node_ok,
                             edge_right=grid.edge_right & er,
                             edge_down=grid.edge_down & ed)
    return grid._replace(alive=node_ok & ~grid.pruned,
                         edge_right=er, edge_down=ed)


def distance_field_from_seeds(grid: NavGrid,
                              seeds: torch.Tensor) -> torch.Tensor:
    """BFS hop distances (int32 ``[ny, nx]``) from a seed node set over
    alive nodes and intact edges; ``INF`` where unreachable.  Relaxes 8
    hops between host convergence checks (hops past the fixpoint change
    nothing)."""
    alive = grid.alive
    er = grid.edge_right & alive & torch.roll(alive, -1, dims=1)
    ed = grid.edge_down & alive & torch.roll(alive, -1, dims=0)
    er_l = torch.roll(er, 1, dims=1)
    er_l[:, 0] = False
    ed_u = torch.roll(ed, 1, dims=0)
    ed_u[0, :] = False
    inf = torch.full_like(alive, INF, dtype=torch.int32)

    def relax(dist):
        from_left = torch.where(er_l, torch.roll(dist, 1, dims=1) + 1, inf)
        from_right = torch.where(er, torch.roll(dist, -1, dims=1) + 1, inf)
        from_up = torch.where(ed_u, torch.roll(dist, 1, dims=0) + 1, inf)
        from_down = torch.where(ed, torch.roll(dist, -1, dims=0) + 1, inf)
        best = torch.minimum(torch.minimum(from_left, from_right),
                             torch.minimum(from_up, from_down))
        return torch.where(alive, torch.minimum(dist, best), inf)

    dist = relax(torch.where(seeds & alive, torch.zeros_like(inf), inf))
    while True:
        new = dist
        for _ in range(8):
            new = relax(new)
        if not bool((new != dist).any()):
            return new
        dist = new


def distance_field(grid: NavGrid, src_j: int, src_i: int) -> torch.Tensor:
    """BFS hop distances from one node (src_j, src_i)."""
    seeds = torch.zeros_like(grid.alive)
    seeds[src_i, src_j] = True
    return distance_field_from_seeds(grid, seeds)


def seeds_near_cell(grid: NavGrid, cell_xy: torch.Tensor, step: int,
                    radius_cells: int) -> torch.Tensor:
    """Alive nodes within a Chebyshev map-cell radius of (x, y)."""
    ny, nx = grid.alive.shape
    dev = grid.alive.device
    node_y = grid.off_y + torch.arange(ny, device=dev)[:, None] * step
    node_x = grid.off_x + torch.arange(nx, device=dev)[None, :] * step
    near = ((node_x - cell_xy[0]).abs() <= radius_cells) & \
        ((node_y - cell_xy[1]).abs() <= radius_cells)
    return near & grid.alive


def nearest_node(grid: NavGrid, dist: torch.Tensor, cell_xy, step: int,
                 reachable_only: bool = True) -> torch.Tensor:
    """Index ``(j, i)`` of the nearest (euclidean, in map cells) node to
    map cell (x, y), restricted to BFS-reachable nodes when asked; ties
    go to the first node in row-major order."""
    ny, nx = grid.alive.shape
    dev = grid.alive.device
    node_y = grid.off_y + torch.arange(ny, device=dev)[:, None] * step
    node_x = grid.off_x + torch.arange(nx, device=dev)[None, :] * step
    d2 = ((node_x - cell_xy[0]) ** 2 +
          (node_y - cell_xy[1]) ** 2).to(torch.float32)
    ok = grid.alive & (dist < INF) if reachable_only else grid.alive
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    k = torch.argmin(d2.reshape(-1))
    return torch.stack([k % nx, k // nx])


def plan(grid: NavGrid, occ_vm: VoxelMap, agent_world: torch.Tensor,
         goal_world: torch.Tensor, *, step: int, padding: int,
         z_start: int, z_stop: int, threshold: float, refresh: bool,
         monotone: bool = False, blocked=None):
    """One planning step: (optionally) refresh the mesh from the map,
    seed a BFS around the agent (the nearest node when its
    neighbourhood was pruned), and snap the goal to the nearest
    reachable node.  Returns ``(grid, dist, target_ji, agent_cell,
    goal_cell)`` as device tensors."""
    if refresh:
        nav = navigable_area(occ_vm, padding, z_start, z_stop, threshold,
                             blocked=blocked)
        grid = refresh_nav_grid(grid, nav, step=step, monotone=monotone)
    agent_cell = occ_vm.world_to_map(agent_world[:2])
    goal_cell = occ_vm.world_to_map(goal_world[:2])
    seeds = seeds_near_cell(grid, agent_cell, step, radius_cells=2 * step)
    src = nearest_node(grid, torch.zeros_like(grid.alive, dtype=torch.int32),
                       agent_cell, step, reachable_only=False)
    fallback = torch.zeros_like(grid.alive)
    fallback[src[1], src[0]] = True
    seeds = torch.where(seeds.any(), seeds, fallback)
    dist = distance_field_from_seeds(grid, seeds)
    tgt = nearest_node(grid, dist, goal_cell, step, reachable_only=True)
    return grid, dist, tgt, agent_cell, goal_cell


def extract_path(grid: NavGrid, dist: np.ndarray, target_ji,
                 step: int) -> np.ndarray:
    """Backtrack a shortest node path target -> source from a BFS
    distance field on the host (``grid``'s edge masks as numpy).
    Returns ``[L, 2]`` (x, y) map-cell coordinates source-first."""
    er = np.asarray(grid.edge_right)
    ed = np.asarray(grid.edge_down)
    off_x = int(grid.off_x)
    off_y = int(grid.off_y)
    j, i = int(target_ji[0]), int(target_ji[1])
    ny, nx = dist.shape
    if dist[i, j] >= INF:
        return np.zeros((0, 2), np.int32)
    path = [(j, i)]
    while dist[i, j] > 0:
        d = dist[i, j]
        moved = False
        for (dj, di, ok) in (
                (-1, 0, j > 0 and er[i, j - 1]),
                (1, 0, j < nx - 1 and er[i, j]),
                (0, -1, i > 0 and ed[i - 1, j]),
                (0, 1, i < ny - 1 and ed[i, j])):
            if ok and dist[i + di, j + dj] == d - 1:
                j, i = j + dj, i + di
                path.append((j, i))
                moved = True
                break
        if not moved:  # defensive: inconsistent field
            break
    path.reverse()
    return np.asarray(
        [(off_x + j * step, off_y + i * step) for j, i in path], np.int32)
