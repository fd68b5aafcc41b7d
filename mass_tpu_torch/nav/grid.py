"""Grid navigation mesh as device masks + BFS distance fields (port of
``mass_tpu.nav.grid``).

Nodes sit every ``step`` cells of the navigation map (offset so the map
origin's cell owns a node); an edge joins two adjacent nodes when the
corridor between them is fully navigable; planning is breadth-first
search over three boolean masks: on the card one launch of the
hand-written kernel ``csrc/bfs.cu`` a field (all of a batch's meshes),
on the CPU a min-plus relaxation with host convergence checks.
Map-derived state recomputes from the current navigable mask on refresh,
while failed-action prunes stay sticky in ``NavGrid.pruned``;
``monotone=True`` keeps the reference's only-ever-remove rule.  Path
extraction backtracks the distance field on the host.

A plan's parts run in ``mass.planning.*`` spans (``utils/profiling.span``):
``refresh`` (the navigable area and the mesh's refresh), ``snap`` (agent
and goal cells, seeds, nearest nodes), ``bfs`` (the whole field) with a
``bfs_kernel`` span around the kernel's launch inside it on the card, or
a ``bfs_check`` span around each convergence check on the CPU, and
``to_host`` (:func:`plan_to_host`'s copy).

Every mesh function also takes a batch of G meshes (masks ``[G, ny,
nx]``, offsets a ``[G]`` tensor; :func:`stack_grids`), which
:func:`plan_batch` plans at once for a fleet of episodes; each mesh of a
batch gets exactly what it gets alone.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.core.voxelmap import VoxelMap, world_to_cells
from mass_tpu_torch.ops import splat
from mass_tpu_torch.ops.pool import max_pool2d_same
from mass_tpu_torch.utils.profiling import span

INF = 1 << 28
# BFS kernel launches (read by tests to show a field went through it)
BFS_LAUNCHES = 0


def _navigable(occupied: torch.Tensor, blocked, padding: int) -> torch.Tensor:
    if blocked is not None:
        occupied = occupied | blocked
    if padding > 0:
        occupied = max_pool2d_same(occupied, padding)
    return ~occupied


def navigable_area(vm: VoxelMap, padding: int = 3, z_start: int = 0,
                   z_stop: int = 32, obstacle_threshold: float = 0.0,
                   blocked: torch.Tensor = None) -> torch.Tensor:
    """``[H, W]`` bool — cells with no occupied voxel in the z slice,
    eroded by ``padding`` cells around obstacles; ``blocked`` cells
    (collision evidence) count as obstacles."""
    return _navigable(vm.occupancy_mask(z_start, z_stop, obstacle_threshold),
                      blocked, padding)


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """``(2r+1)^2`` sliding-window sum of a 0/1 image with zero padding,
    from an integral image (two integer cumsums, so the float32 result is
    exact as the JAX package's float32 cumsums are below 2**24)."""
    k = 2 * r + 1
    c = torch.nn.functional.pad(x.to(torch.int32), (r + 1, r, r + 1, r))
    c = torch.cumsum(torch.cumsum(c, dim=0), dim=1)
    return (c[k:, k:] - c[:-k, k:] - c[k:, :-k]
            + c[:-k, :-k]).to(torch.float32)


def frontier_mass(vm: VoxelMap, radius_cells: int, padding: int = 3,
                  z_start: int = 0, z_stop: int = 32,
                  obstacle_threshold: float = 0.0,
                  blocked: torch.Tensor = None) -> torch.Tensor:
    """``[H, W]`` float — the number of frontier cells within a
    ``radius_cells`` Chebyshev window of each map cell.  A frontier cell
    is unobserved and borders observed navigable space, so unknown space
    behind walls scores zero while doorways into unexplored rooms score
    high."""
    observed = vm.rows(lambda grid: grid.amax(dim=(2, 3)) > 0)  # any splat
    free = observed & navigable_area(vm, padding, z_start, z_stop,
                                     obstacle_threshold, blocked=blocked)
    near_free = free.clone()
    near_free[:-1] |= free[1:]
    near_free[1:] |= free[:-1]
    near_free[:, :-1] |= free[:, 1:]
    near_free[:, 1:] |= free[:, :-1]
    return _box_sum(~observed & near_free, radius_cells)


class NavGrid(NamedTuple):
    """Navigation mesh state.  Node ``(i, j)`` sits at map cell
    ``(y, x) = (off_y + i*step, off_x + j*step)``; ``edge_right[i, j]``
    joins (i, j)-(i, j+1) and ``edge_down[i, j]`` joins (i, j)-(i+1, j).
    The masks are ``[ny, nx]`` bool tensors and the offsets host ints;
    a batch of G meshes has ``[G, ny, nx]`` masks and ``[G]`` int64
    offsets on the masks' device."""

    alive: torch.Tensor
    edge_right: torch.Tensor
    edge_down: torch.Tensor
    off_x: Union[int, torch.Tensor]
    off_y: Union[int, torch.Tensor]
    pruned: torch.Tensor   # sticky failed-action node removals


def stack_grids(grids: Sequence[NavGrid]) -> NavGrid:
    """G meshes of one shape as one batch (offsets sent to the masks'
    device without a host sync)."""
    dev = grids[0].alive.device
    offsets = G.to_device(torch.tensor(
        [[g.off_x for g in grids], [g.off_y for g in grids]],
        dtype=torch.int64), dev)

    def stack(name):
        return torch.stack([getattr(g, name) for g in grids])
    return NavGrid(alive=stack("alive"), edge_right=stack("edge_right"),
                   edge_down=stack("edge_down"), off_x=offsets[0],
                   off_y=offsets[1], pruned=stack("pruned"))


def _node_axis(off, n: int, step: int, device) -> torch.Tensor:
    """Map coordinates of the nodes along one axis: ``[n]`` for a host
    offset, ``[G, n]`` for a batch's offsets."""
    steps = torch.arange(n, dtype=torch.int64, device=device) * step
    if isinstance(off, torch.Tensor):
        return off[:, None] + steps
    return int(off) + steps


def _node_cells(nav_h: int, nav_w: int, ny: int, nx: int, off_x, off_y,
                step: int, device):
    ys = _node_axis(off_y, ny, step, device)
    xs = _node_axis(off_x, nx, step, device)
    in_bounds = (ys[..., :, None] < nav_h) & (xs[..., None, :] < nav_w)
    return ys, xs, in_bounds


def _at(table: torch.Tensor, rows: torch.Tensor,
        cols: torch.Tensor) -> torch.Tensor:
    """``table[rows, cols]`` of a ``[h, w]`` table, or of each of a
    batch's ``[G, h, w]`` tables."""
    if table.dim() == 2:
        return table[rows, cols]
    batch = torch.arange(table.shape[0], device=table.device)[:, None, None]
    return table[batch, rows, cols]


def _corridor_masks(navigable: torch.Tensor, ys, xs, in_bounds,
                    step: int):
    """Edge masks: the (step+1)-cell corridor between adjacent nodes
    must be fully navigable (window-all tests via integer cumsums)."""
    nav = navigable.to(torch.int32)
    h, w = navigable.shape[-2:]
    cs_x = torch.nn.functional.pad(torch.cumsum(nav, dim=-1), (1, 0))
    cs_y = torch.nn.functional.pad(torch.cumsum(nav, dim=-2), (0, 0, 1, 0))

    def window_all_x(y_idx, x_idx):
        x0 = x_idx[..., None, :]
        hi = (x0 + step + 1).clamp(0, w)
        lo = x0.clamp(0, w)
        rows = y_idx[..., :, None]
        total = _at(cs_x, rows, hi) - _at(cs_x, rows, lo)
        return total >= hi - lo

    def window_all_y(y_idx, x_idx):
        y0 = y_idx[..., :, None]
        hi = (y0 + step + 1).clamp(0, h)
        lo = y0.clamp(0, h)
        cols = x_idx[..., None, :]
        total = _at(cs_y, hi, cols) - _at(cs_y, lo, cols)
        return total >= hi - lo

    ny, nx = ys.shape[-1], xs.shape[-1]
    right_ok = window_all_x(ys.clamp(0, h - 1), xs)
    down_ok = window_all_y(ys, xs.clamp(0, w - 1))
    has_right = in_bounds & torch.roll(in_bounds, -1, dims=-1)
    has_right[..., :, nx - 1] = False
    has_down = in_bounds & torch.roll(in_bounds, -1, dims=-2)
    has_down[..., ny - 1, :] = False
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
    h, w = navigable.shape[-2:]
    ny, nx = grid.alive.shape[-2:]
    ys, xs, in_bounds = _node_cells(h, w, ny, nx, grid.off_x, grid.off_y,
                                    step, navigable.device)
    node_ok = _at(navigable, ys.clamp(0, h - 1)[..., :, None],
                  xs.clamp(0, w - 1)[..., None, :]) & in_bounds
    er, ed = _corridor_masks(navigable, ys, xs, in_bounds, step)
    if monotone:
        return grid._replace(alive=grid.alive & node_ok,
                             edge_right=grid.edge_right & er,
                             edge_down=grid.edge_down & ed)
    return grid._replace(alive=node_ok & ~grid.pruned,
                         edge_right=er, edge_down=ed)


def distance_field_reference(alive: torch.Tensor, edge_right: torch.Tensor,
                             edge_down: torch.Tensor,
                             seeds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the BFS kernel (``csrc/bfs.cu``): the JAX
    package's min-plus relaxation, 8 hops between host convergence
    checks, one check for the whole batch (hops past a mesh's fixpoint
    change nothing), each check in a ``mass.planning.bfs_check`` span: a
    field of c checks relaxed 8c + 1 hops.  An edge leaving the mesh
    (``edge_right``'s last column, ``edge_down``'s last row) joins
    nothing."""
    er = edge_right & alive & torch.roll(alive, -1, dims=-1)
    er[..., :, -1] = False
    ed = edge_down & alive & torch.roll(alive, -1, dims=-2)
    ed[..., -1, :] = False
    er_l = torch.roll(er, 1, dims=-1)
    er_l[..., :, 0] = False
    ed_u = torch.roll(ed, 1, dims=-2)
    ed_u[..., 0, :] = False
    inf = torch.full_like(alive, INF, dtype=torch.int32)

    def relax(dist):
        from_left = torch.where(er_l, torch.roll(dist, 1, dims=-1) + 1, inf)
        from_right = torch.where(er, torch.roll(dist, -1, dims=-1) + 1, inf)
        from_up = torch.where(ed_u, torch.roll(dist, 1, dims=-2) + 1, inf)
        from_down = torch.where(ed, torch.roll(dist, -1, dims=-2) + 1, inf)
        best = torch.minimum(torch.minimum(from_left, from_right),
                             torch.minimum(from_up, from_down))
        return torch.where(alive, torch.minimum(dist, best), inf)

    dist = relax(torch.where(seeds & alive, torch.zeros_like(inf), inf))
    while True:
        new = dist
        for _ in range(8):
            new = relax(new)
        with span("mass.planning.bfs_check"):
            changed = bool((new != dist).any())
        if not changed:
            return new
        dist = new


def _bfs_kernel(alive: torch.Tensor, edge_right: torch.Tensor,
                edge_down: torch.Tensor,
                seeds: torch.Tensor) -> torch.Tensor:
    """The BFS field of CUDA masks by one launch of ``csrc/bfs.cu``
    (counted in ``BFS_LAUNCHES``); :func:`distance_field_reference`'s
    arguments and result.  Raises on masks that are not four bool
    tensors of one shape on one CUDA device."""
    global BFS_LAUNCHES
    masks = (alive, edge_right, edge_down, seeds)
    shape = tuple(alive.shape)
    if any(m.dtype != torch.bool or tuple(m.shape) != shape
           for m in masks) or alive.dim() not in (2, 3):
        got = [(m.dtype, tuple(m.shape)) for m in masks]
        raise ValueError(f"bfs kernel: four bool [ny, nx] or [G, ny, nx] "
                         f"masks, got {got}")
    if any(m.device != alive.device for m in masks) or \
            alive.device.type != "cuda":
        raise ValueError(f"bfs kernel: masks on one CUDA device, got "
                         f"{[str(m.device) for m in masks]}")
    ny, nx = shape[-2:]
    if ny * nx >= INF:
        raise ValueError(f"bfs kernel: a mesh of {ny} x {nx} nodes; one "
                         f"holds fewer than {INF}")
    meshes = shape[0] if alive.dim() == 3 else 1
    masks = [m.contiguous() for m in masks]
    out = torch.empty(shape, dtype=torch.int32, device=alive.device)
    splat._raise_on(splat._library("bfs").bfs_launch(
        *(m.data_ptr() for m in masks), meshes, ny, nx, out.data_ptr(),
        splat._stream(alive.device)), "bfs")
    BFS_LAUNCHES += 1
    return out


def distance_field_from_seeds(grid: NavGrid,
                              seeds: torch.Tensor) -> torch.Tensor:
    """BFS hop distances (int32 ``[ny, nx]``, or ``[G, ny, nx]`` for a
    batch) from a seed node set over alive nodes and intact edges;
    ``INF`` where unreachable.  CUDA masks converge on the card in one
    launch of ``csrc/bfs.cu`` (a ``mass.planning.bfs_kernel`` span);
    CPU masks take :func:`distance_field_reference`.  The field runs in
    a ``mass.planning.bfs`` span."""
    with span("mass.planning.bfs"):
        masks = (grid.alive, grid.edge_right, grid.edge_down, seeds)
        if all(m.device.type == "cpu" for m in masks):
            return distance_field_reference(*masks)
        with span("mass.planning.bfs_kernel"):
            return _bfs_kernel(*masks)


def distance_field(grid: NavGrid, src_j: int, src_i: int) -> torch.Tensor:
    """BFS hop distances from one node (src_j, src_i)."""
    seeds = torch.zeros_like(grid.alive)
    seeds[src_i, src_j] = True
    return distance_field_from_seeds(grid, seeds)


def _node_xy(grid: NavGrid, step: int):
    """Map x ``[..., 1, nx]`` and y ``[..., ny, 1]`` of every node."""
    ny, nx = grid.alive.shape[-2:]
    dev = grid.alive.device
    return (_node_axis(grid.off_x, nx, step, dev)[..., None, :],
            _node_axis(grid.off_y, ny, step, dev)[..., :, None])


def seeds_near_cell(grid: NavGrid, cell_xy: torch.Tensor, step: int,
                    radius_cells: int) -> torch.Tensor:
    """Alive nodes within a Chebyshev map-cell radius of (x, y)
    (``cell_xy [2]``, or ``[G, 2]`` for a batch)."""
    node_x, node_y = _node_xy(grid, step)
    near = ((node_x - cell_xy[..., 0, None, None]).abs() <= radius_cells) & \
        ((node_y - cell_xy[..., 1, None, None]).abs() <= radius_cells)
    return near & grid.alive


def nearest_node(grid: NavGrid, dist: torch.Tensor, cell_xy, step: int,
                 reachable_only: bool = True) -> torch.Tensor:
    """Index ``(j, i)`` of the nearest (euclidean, in map cells) node to
    map cell (x, y), restricted to BFS-reachable nodes when asked; ties
    go to the first node in row-major order.  ``[2]``, or ``[G, 2]`` for
    a batch."""
    nx = grid.alive.shape[-1]
    node_x, node_y = _node_xy(grid, step)
    d2 = ((node_x - cell_xy[..., 0, None, None]) ** 2 +
          (node_y - cell_xy[..., 1, None, None]) ** 2).to(torch.float32)
    ok = grid.alive & (dist < INF) if reachable_only else grid.alive
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    k = torch.argmin(d2.flatten(-2), dim=-1)
    return torch.stack([k % nx, k // nx], dim=-1)


def _plan(grid: NavGrid, bins, agent_world: torch.Tensor,
          goal_world: torch.Tensor, step: int):
    """:func:`plan` of one (refreshed) mesh or a batch, given the grids'
    bins."""
    with span("mass.planning.snap"):
        agent_cell = world_to_cells(bins, agent_world[..., :2])
        goal_cell = world_to_cells(bins, goal_world[..., :2])
        seeds = seeds_near_cell(grid, agent_cell, step,
                                radius_cells=2 * step)
        src = nearest_node(grid, torch.zeros_like(grid.alive,
                                                  dtype=torch.int32),
                           agent_cell, step, reachable_only=False)
        ny, nx = grid.alive.shape[-2:]
        node = torch.arange(ny * nx, device=grid.alive.device).view(ny, nx)
        fallback = node == (src[..., 1] * nx + src[..., 0])[..., None, None]
        seeds = torch.where(seeds.flatten(-2).any(-1)[..., None, None],
                            seeds, fallback)
    dist = distance_field_from_seeds(grid, seeds)
    with span("mass.planning.snap"):
        tgt = nearest_node(grid, dist, goal_cell, step, reachable_only=True)
    return grid, dist, tgt, agent_cell, goal_cell


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
        with span("mass.planning.refresh"):
            grid = refresh_nav_grid(
                grid, navigable_area(occ_vm, padding, z_start, z_stop,
                                     threshold, blocked=blocked),
                step=step, monotone=monotone)
    return _plan(grid, occ_vm.bins, agent_world, goal_world, step)


def plan_batch(grids: NavGrid, occ_vms: Sequence[VoxelMap],
               agent_worlds: torch.Tensor, goal_worlds: torch.Tensor, *,
               step: int, padding: int, z_start: int, z_stop: int,
               threshold: float, refresh: bool, monotone: bool = False,
               blocked=None):
    """:func:`plan` for G episodes at once (the fleet's planner): a
    batch of meshes (:func:`stack_grids`), each episode's map
    (``occ_vms``, views of a fleet buffer), world agents and goals
    ``[G, >=2]`` and collision evidence ``[G, H, W]``.  A refresh
    reduces each map's ``z_start:z_stop`` slice in place, so no map is
    copied; one BFS field covers the whole batch.  Returns
    :func:`plan`'s tuple with a leading ``[G]``, each episode's entries
    equal to its own :func:`plan`."""
    if refresh:
        with span("mass.planning.refresh"):
            grids = refresh_nav_grid(grids, _navigable(torch.stack([
                vm.occupancy_mask(z_start, z_stop, threshold)
                for vm in occ_vms]), blocked, padding), step=step,
                monotone=monotone)
    with span("mass.planning.snap"):
        bins = tuple(torch.stack(axis)
                     for axis in zip(*(vm.bins for vm in occ_vms)))
    return _plan(grids, bins, agent_worlds, goal_worlds, step)


def plan_to_host(grid: NavGrid, dist: torch.Tensor, tgt: torch.Tensor,
                 agent_cell: torch.Tensor):
    """What the host backtrack reads of one plan, or of a batch of plans
    (leading ``[G]``), in one device-to-host copy: ``(dist, target,
    agent_cell)`` as int64 and the edge masks as bool numpy arrays."""
    parts = (dist, tgt, agent_cell, grid.edge_right, grid.edge_down)
    lead = dist.shape[:-2]
    flat = [p.reshape(*lead, -1).to(torch.int64) for p in parts]
    packed = torch.cat(flat, dim=-1)
    with span("mass.planning.to_host"):
        host = packed.cpu().numpy()
    out, lo = [], 0
    for p, f in zip(parts, flat):
        out.append(host[..., lo:lo + f.shape[-1]].reshape(p.shape))
        lo += f.shape[-1]
    dist_h, tgt_h, agent_h, er, ed = out
    return dist_h, tgt_h, agent_h, er > 0, ed > 0


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
