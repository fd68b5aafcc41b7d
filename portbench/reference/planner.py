"""Plain navigation mesh and breadth-first search in NumPy.

Nodes sit every ``step`` map cells from an offset that gives the map's
origin cell a node; node ``(i, j)`` is at map cell ``(y, x) = (off_y +
i * step, off_x + j * step)``.  A refresh keeps a node whose cell is
navigable (no occupied voxel within ``padding`` cells) and joins two
neighbours when every cell of the corridor between them, both ends
included, is navigable.  The distance field is the hop count from the
seed nodes over live nodes and edges whose two ends are live, ``INF``
where unreachable; ties in nearest-node searches go to the first node in
row-major order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

INF = 1 << 28


class Mesh(NamedTuple):
    alive: np.ndarray        # [ny, nx] bool
    right: np.ndarray        # [ny, nx] bool: (i, j)-(i, j+1)
    down: np.ndarray         # [ny, nx] bool: (i, j)-(i+1, j)
    off_x: int
    off_y: int


def _dilate(occupied: np.ndarray, radius: int) -> np.ndarray:
    h, w = occupied.shape
    padded = np.zeros((h + 2 * radius, w + 2 * radius), bool)
    padded[radius:radius + h, radius:radius + w] = occupied
    out = np.zeros_like(occupied)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            out |= padded[dy:dy + h, dx:dx + w]
    return out


def navigable(occupied: np.ndarray, padding: int) -> np.ndarray:
    return ~_dilate(occupied, padding) if padding else ~occupied


def cell_of(edges_x: np.ndarray, edges_y: np.ndarray,
            xy) -> np.ndarray:
    """Map cell ``(x, y)`` of a world point, clamped into the grid (float32
    as the map's edges)."""
    out = []
    for k, e in enumerate((edges_x, edges_y)):
        lo = np.float32((e[0] + e[1]) / np.float32(2))
        hi = np.float32((e[-1] + e[-2]) / np.float32(2))
        v = min(max(np.float32(xy[k]), lo), hi)
        i = int(np.searchsorted(e, v, side="right")) - 1
        out.append(i if k == 0 else e.shape[0] - 2 - i)
    return np.asarray(out, np.int64)


def origin_offsets(edges_x: np.ndarray, edges_y: np.ndarray,
                   resolution: float, step: int):
    """The node offsets that give the map's centre cell a node."""
    half = np.float32(resolution / 2)
    centre = [np.float32((e[0] + e[-1]) / np.float32(2)) + half
              for e in (edges_x, edges_y)]
    cell = cell_of(edges_x, edges_y, centre)
    return int(cell[0]) % step, int(cell[1]) % step


def mesh(nav: np.ndarray, off_x: int, off_y: int, step: int) -> Mesh:
    h, w = nav.shape
    ny, nx = -(-h // step), -(-w // step)
    ys = off_y + np.arange(ny) * step
    xs = off_x + np.arange(nx) * step
    inside = (ys[:, None] < h) & (xs[None, :] < w)
    cy, cx = np.minimum(ys, h - 1), np.minimum(xs, w - 1)
    alive = nav[cy[:, None], cx[None, :]] & inside
    # a corridor is all navigable where its count of navigable cells
    # (running sums along the axis) equals its length
    run_x = np.pad(np.cumsum(nav, axis=1), ((0, 0), (1, 0)))
    run_y = np.pad(np.cumsum(nav, axis=0), ((1, 0), (0, 0)))
    lo_x, hi_x = np.minimum(xs, w), np.minimum(xs + step + 1, w)
    lo_y, hi_y = np.minimum(ys, h), np.minimum(ys + step + 1, h)
    right = (run_x[cy[:, None], hi_x[None, :]] - run_x[cy[:, None],
                                                      lo_x[None, :]]
             >= (hi_x - lo_x)[None, :])
    down = (run_y[hi_y[:, None], cx[None, :]] - run_y[lo_y[:, None],
                                                     cx[None, :]]
            >= (hi_y - lo_y)[:, None])
    right[:, :-1] &= inside[:, :-1] & inside[:, 1:]
    right[:, -1] = False
    down[:-1] &= inside[:-1] & inside[1:]
    down[-1] = False
    return Mesh(alive, right, down, off_x, off_y)


def distances(m: Mesh, seeds: np.ndarray) -> np.ndarray:
    """Hop counts from ``seeds`` over live nodes and live edges."""
    alive = m.alive
    right = m.right.copy()
    right[:, :-1] &= alive[:, :-1] & alive[:, 1:]
    right[:, -1] = False
    down = m.down.copy()
    down[:-1] &= alive[:-1] & alive[1:]
    down[-1] = False
    dist = np.where(seeds & alive, 0, INF).astype(np.int64)
    while True:
        new = dist.copy()
        new[:, 1:] = np.where(right[:, :-1],
                              np.minimum(new[:, 1:], dist[:, :-1] + 1),
                              new[:, 1:])
        new[:, :-1] = np.where(right[:, :-1],
                               np.minimum(new[:, :-1], dist[:, 1:] + 1),
                               new[:, :-1])
        new[1:] = np.where(down[:-1], np.minimum(new[1:], dist[:-1] + 1),
                           new[1:])
        new[:-1] = np.where(down[:-1], np.minimum(new[:-1], dist[1:] + 1),
                            new[:-1])
        new = np.where(alive, np.minimum(new, INF), INF)
        if np.array_equal(new, dist):
            return dist
        dist = new


def _node_xy(m: Mesh, step: int):
    ny, nx = m.alive.shape
    return (m.off_x + np.arange(nx)[None, :] * step,
            m.off_y + np.arange(ny)[:, None] * step)


def nearest(m: Mesh, ok: np.ndarray, cell, step: int) -> np.ndarray:
    """``(j, i)`` of the ``ok`` node nearest (euclidean, in cells) to map
    cell ``(x, y)``; the first node where none is ``ok``."""
    x, y = _node_xy(m, step)
    d2 = ((x - cell[0]) ** 2 + (y - cell[1]) ** 2).astype(np.float64)
    d2 = np.where(ok, d2, np.inf)
    k = int(np.argmin(d2))
    nx = m.alive.shape[1]
    return np.asarray([k % nx, k // nx], np.int64)


def plan(m: Mesh, agent_cell, goal_cell, step: int):
    """Seeds around the agent (its nearest node where none is near),
    the distance field and the target: the reachable node nearest the
    goal.  Returns ``(dist, target (j, i))``."""
    x, y = _node_xy(m, step)
    seeds = ((np.abs(x - agent_cell[0]) <= 2 * step)
             & (np.abs(y - agent_cell[1]) <= 2 * step) & m.alive)
    if not seeds.any():
        j, i = nearest(m, m.alive, agent_cell, step)
        seeds = np.zeros_like(m.alive)
        seeds[i, j] = True
    dist = distances(m, seeds)
    target = nearest(m, m.alive & (dist < INF), goal_cell, step)
    return dist, target
