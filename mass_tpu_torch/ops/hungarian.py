"""Minimum-cost bipartite assignment (port of ``mass_tpu.ops.hungarian``).

The matcher's cost matrices are a few instances square, so the solve
runs on the host: the same O(n^3) shortest-augmenting-path algorithm
with dual potentials as the JAX package, row by row, with the same
float32 arithmetic and the same first-index ``argmin``, so ties resolve
as they do there.  Rectangular costs are padded to square the same way.
"""

from __future__ import annotations

import numpy as np
import torch

_INF = np.float32(1e30)


def _solve_square(cost: np.ndarray) -> np.ndarray:
    """``col_of_row [n]`` minimizing ``sum cost[i, col_of_row[i]]`` over
    permutations of a square float32 ``[n, n]`` cost matrix."""
    n = cost.shape[0]
    u = np.zeros(n + 1, np.float32)
    v = np.zeros(n + 1, np.float32)
    # p[j]: row assigned to column j (-1 free); column 0 is the virtual
    # column holding the row being inserted
    p = np.full(n + 1, -1, np.int64)
    for i in range(n):
        p[0] = i
        minv = np.full(n + 1, _INF, np.float32)
        minv[0] = -_INF
        used = np.zeros(n + 1, bool)
        way = np.zeros(n + 1, np.int64)
        j0 = 0
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = np.concatenate(
                [[_INF], (cost[i0, :] - u[i0]) - v[1:]]).astype(np.float32)
            better = (~used) & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            masked = np.where(used, _INF, minv).astype(np.float32)
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            for j in np.nonzero(used & (p >= 0))[0]:
                u[p[j]] = u[p[j]] + delta
            v = np.where(used, v - delta, v).astype(np.float32)
            minv = np.where(used, minv, minv - delta).astype(np.float32)
            j0 = j1
            if p[j1] < 0:
                break
        # walk the augmenting path backwards, reassigning columns
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.full(n, -1, np.int64)
    for j in range(1, n + 1):
        if p[j] >= 0:
            col_of_row[p[j]] = j - 1
    return col_of_row


def linear_sum_assignment(cost, num_rows=None,
                          num_cols=None) -> torch.Tensor:
    """Minimum-cost assignment of a (possibly rectangular) ``[R, C]``
    cost matrix; entries beyond ``num_rows``/``num_cols`` are ignored.

    Returns ``col_of_row [R]`` (int64, on the cost's device): the
    assigned column per row, -1 where the row is unmatched.
    """
    device = cost.device if isinstance(cost, torch.Tensor) else None
    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu().numpy()
    cost = np.asarray(cost, np.float32)
    r, c = cost.shape
    n = max(r, c)
    num_rows = r if num_rows is None else int(num_rows)
    num_cols = c if num_cols is None else int(num_cols)
    rows_real = np.arange(n) < num_rows
    cols_real = np.arange(n) < num_cols
    sq = np.zeros((n, n), np.float32)
    sq[:r, :c] = cost
    # real rows escaping to a padded column pay a uniform large cost, so
    # the escapees are the ones scipy's rectangular solve leaves out;
    # padded rows take the leftover columns for free
    sq = np.where(rows_real[:, None] & ~cols_real[None, :],
                  np.float32(1e6), sq)
    sq = np.where(~rows_real[:, None], np.float32(0.0), sq)
    col_of_row = _solve_square(sq.astype(np.float32))[:r]
    matched = (np.arange(r) < num_rows) & (col_of_row < num_cols)
    out = np.where(matched, col_of_row, -1)
    return torch.as_tensor(out, dtype=torch.int64, device=device)
