"""Trainer for the semantic-search policy (port of
``mass_tpu.search.train``).

Supervised training of the goal heat map from (top-down semantic map,
goal cell) pairs: the cross-entropy of the softmax over map cells
against the labelled goal cell, optionally Gaussian-smoothed, with Adam
(AdamW under a weight decay).  ``fit`` splits the collected tasks into
train and validation by task, draws batches and dihedral augmentations
from one ``np.random.RandomState(seed)`` in the JAX package's order, and
saves the parameters with the best validation NLL as a ``.pth`` in the
reference ``policy.pth`` layout, which the CLI's ``--policy-checkpoint``
reads.  ``--conditioned`` trains the walkthrough-conditioned variant (2C
input channels); on square maps its float16 snapshot and context pools
live on the device and each batch is gathered, concatenated and
augmented there.

    python -m mass_tpu_torch.search.train --data /tmp/search-data \\
        --out /tmp/policy.pth

Runs on ``--device`` (default ``cuda``); forward and backward run with
deterministic cuDNN and TF32 off, so two runs from one seed give equal
parameters.  ``--data-parallel`` splits each batch over every card from
``--device``'s on (or ``--data-parallel N`` over N replicas, which on the
CPU all lie on the CPU), one replica of the policy a device
(``utils/training.Replicas``), as the JAX package's
``fit(data_parallel=True)`` shards it over its ``data`` axis.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from mass_tpu_torch import resolve_device
from mass_tpu_torch.search import policy as P
from mass_tpu_torch.utils.checkpoint import save_state_dict
from mass_tpu_torch.utils.training import Replicas, data_devices, exact_convs


@dataclasses.dataclass
class TrainState:
    """The policy being trained, its optimizer, its replicas over the
    data axis (one for a one-device step) and the steps taken."""

    policy: P.SearchPolicy
    optimizer: torch.optim.Optimizer
    replicas: Replicas
    step: int = 0


def create_train_state(generator: torch.Generator, channels: int,
                       learning_rate: float = 3e-4,
                       weight_decay: float = 0.0,
                       device=None, devices=None) -> TrainState:
    """A policy initialised from ``generator`` on ``device`` with Adam,
    or AdamW with ``weight_decay`` on every parameter (optax's
    ``adamw``: torch's default decay is not used).  ``devices`` (first
    ``device``) is the data axis a step splits its batch over."""
    device = resolve_device(device)
    policy = P.init_policy(generator, channels).to(device)
    params = policy.parameters()
    optimizer = (torch.optim.AdamW(params, learning_rate,
                                   weight_decay=weight_decay)
                 if weight_decay else torch.optim.Adam(params, learning_rate))
    return TrainState(policy, optimizer,
                      Replicas(policy, devices or [device]))


def _logits(policy: P.SearchPolicy, top_down: torch.Tensor) -> torch.Tensor:
    out = policy(top_down)
    return out.reshape(out.shape[0], -1)


def goal_cross_entropy(policy: P.SearchPolicy, top_down: torch.Tensor,
                       goal_cells: torch.Tensor,
                       sigma: float = 0.0) -> torch.Tensor:
    """Mean NLL of labelled goal cells ``[B, 2]`` (x, y) under the softmax
    over the cells of ``top_down [B, H, W, C]``; with ``sigma > 0`` the
    target is a normalised Gaussian heat map around each goal cell.  The
    target is dense (a one-hot row for ``sigma == 0``), so the backward
    pass is a product and not a scatter."""
    logp = torch.log_softmax(_logits(policy, top_down), dim=-1)
    h, w = top_down.shape[1], top_down.shape[2]
    goal_cells = goal_cells.to(logp.device)
    if sigma <= 0.0:
        flat = goal_cells[:, 1].long() * w + goal_cells[:, 0].long()
        target = F.one_hot(flat, h * w).to(logp.dtype)
    else:
        ys = torch.arange(h, dtype=torch.float32, device=logp.device)
        xs = torch.arange(w, dtype=torch.float32, device=logp.device)
        gy = goal_cells[:, 1].to(torch.float32)[:, None]
        gx = goal_cells[:, 0].to(torch.float32)[:, None]
        d2 = ((ys[None] - gy) ** 2)[:, :, None] + \
            ((xs[None] - gx) ** 2)[:, None, :]
        target = torch.exp(-d2 / (2.0 * sigma ** 2)).reshape(len(gy), -1)
        target = target / target.sum(dim=-1, keepdim=True)
    return -(target * logp).sum(dim=-1).mean()


def train_step(state: TrainState, top_down: torch.Tensor,
               goal_cells: torch.Tensor, sigma: float = 0.0
               ) -> torch.Tensor:
    """One optimizer step on a batch (in place), split over the state's
    replicas; returns the batch's loss before the step."""
    losses, grads = state.replicas.grads(
        lambda policy, t, g: {"total": goal_cross_entropy(policy, t, g,
                                                          sigma)},
        top_down, goal_cells.to(top_down.device))
    state.replicas.set_grads(grads)
    state.optimizer.step()
    state.step += 1
    return losses["total"]


# ---------------------------------------------------------------------
# the dataset and the fit loop
# ---------------------------------------------------------------------


def _task_files(logdir: str):
    """``(task id, path)`` of every ``task-*.npz`` under ``logdir``, in
    sorted path order (so ``task-10`` precedes ``task-2``)."""
    for path in sorted(glob.glob(os.path.join(logdir, "task-*.npz"))):
        yield int(re.search(r"task-(\d+)\.npz", path).group(1)), path


def load_dataset(logdir: str):
    """Every ``task-*.npz`` written by ``mass_tpu_torch.search.dataset``
    as (tops [N, H, W, C] float16, cells [N, 2] int32, task_ids [N]): one
    sample per (snapshot, labelled goal cell) pair, walkthrough and
    unshuffle phases pooled."""
    tops, cells, task_ids = [], [], []
    for tid, path in _task_files(logdir):
        with np.load(path) as z:
            for phase in ("0", "1"):
                t, c = z[f"tops{phase}"], z[f"cells{phase}"]
                for i in range(len(t)):
                    for j in range(len(c)):
                        tops.append(t[i])
                        cells.append(c[j])
                        task_ids.append(tid)
    assert tops, f"no task-*.npz files under {logdir}"
    return (np.stack(tops), np.stack(cells).astype(np.int32),
            np.asarray(task_ids))


class _PlainSamples:
    """Sample source for the reference-style single-map policy input."""

    def __init__(self, tops, cells, task_ids):
        self.cells, self.task_ids = cells, task_ids
        self._tops = tops
        self.shape = tops.shape[1:]

    def __len__(self):
        return len(self._tops)

    def top(self, i):
        return self._tops[i]


class _ConditionedSamples:
    """Walkthrough-conditioned samples: the input is ``concat([current
    top-down, context], channel)``, the context being the finished
    walkthrough map for unshuffle-phase samples and zeros for
    walkthrough-phase ones.  Snapshots and contexts are stored once and
    gathered per batch."""

    def __init__(self, snaps, ctxs, snap_idx, ctx_idx, cells, task_ids):
        self.cells, self.task_ids = cells, task_ids
        self._snaps, self._ctxs = snaps, ctxs
        self._si, self._ci = snap_idx, ctx_idx
        h, w, c = snaps.shape[1:]
        self.shape = (h, w, 2 * c)
        self._zero = np.zeros((h, w, c), snaps.dtype)

    def __len__(self):
        return len(self._si)

    def top(self, i):
        ctx = (self._ctxs[self._ci[i]] if self._ci[i] >= 0
               else self._zero)
        return np.concatenate([self._snaps[self._si[i]], ctx], axis=-1)


def load_dataset_conditioned(logdir: str) -> _ConditionedSamples:
    """Conditioned-policy dataset: (snapshot, goal cell) pairs plus a
    per-sample context index, the task's final walkthrough top-down
    (``tops0[-1]``) for unshuffle samples and none for walkthrough ones.
    Unshuffle targets are the walkthrough cells (``cells0``) followed by
    the current cells (``cells1``)."""
    snaps, ctxs = [], []
    snap_idx, ctx_idx, cells, task_ids = [], [], [], []
    for tid, path in _task_files(logdir):
        with np.load(path) as z:
            t0, c0 = z["tops0"], z["cells0"]
            t1, c1 = z["tops1"], z["cells1"]
        ci = -1
        if len(t0):
            ctxs.append(t0[-1])
            ci = len(ctxs) - 1
        c01 = np.concatenate([c0, c1]) if len(c0) and len(c1) else \
            (c0 if len(c0) else c1)
        for phase_tops, phase_cells, phase_ctx in (
                (t0, c0, -1), (t1, c01, ci)):
            for i in range(len(phase_tops)):
                snaps.append(phase_tops[i])
                si = len(snaps) - 1
                for j in range(len(phase_cells)):
                    snap_idx.append(si)
                    ctx_idx.append(phase_ctx)
                    cells.append(phase_cells[j])
                    task_ids.append(tid)
    assert snap_idx, f"no task-*.npz files under {logdir}"
    return _ConditionedSamples(
        np.stack(snaps), np.stack(ctxs) if ctxs else
        np.zeros((0,) + snaps[0].shape, snaps[0].dtype),
        np.asarray(snap_idx), np.asarray(ctx_idx),
        np.stack(cells).astype(np.int32), np.asarray(task_ids))


@torch.no_grad()
def goal_distance(policy: P.SearchPolicy, top_down: torch.Tensor,
                  goal_cells: torch.Tensor) -> torch.Tensor:
    """Mean L2 map-cell distance from the policy's argmax cell to the
    labelled goal."""
    logits = _logits(policy, top_down)
    w = top_down.shape[2]
    idx = torch.argmax(logits, dim=-1)
    xy = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)
    return torch.linalg.norm(
        xy - goal_cells.to(xy.device, torch.float32), dim=-1).mean()


def _dihedral_cell(cell, k: int, flip: bool, h: int, w: int):
    """Coordinate leg of the dihedral transform (matches np.rot90)."""
    x, y = int(cell[0]), int(cell[1])
    if flip:
        x = w - 1 - x
    for _ in range(k):
        # np.rot90 CCW: (y, x) -> (w - 1 - x, y); the rotated array is
        # (w, h), so the width used by the next step swaps too
        x, y = y, w - 1 - x
        h, w = w, h
    return np.asarray([x, y], np.int32)


def _dihedral(top: np.ndarray, cell: np.ndarray, k: int, flip: bool):
    """One of the 8 square symmetries of a (top-down, cell) pair: a flip
    of the columns, then ``k`` counter-clockwise quarter turns."""
    h, w = top.shape[:2]
    c = _dihedral_cell(cell, k, flip, h, w)
    if flip:
        top = top[:, ::-1]
    for _ in range(k):
        top = np.rot90(top)
    return top, c


def _device_dihedral(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """:func:`_dihedral` of a square ``[H, W, C]`` tensor where it lies
    (np.rot90(m) == flip(swapaxes(m, 0, 1), 0))."""
    if flip:
        x = torch.flip(x, [1])
    if k == 1:
        return torch.flip(x.transpose(0, 1), [0])
    if k == 2:
        return torch.flip(x, [0, 1])
    if k == 3:
        return torch.flip(x.transpose(0, 1), [1])
    return x


def _assemble_conditioned(snaps: torch.Tensor, ctxs: torch.Tensor, si, ci,
                          ks, flips) -> torch.Tensor:
    """Gather, concatenate and augment a conditioned batch where the
    float16 snapshot and context pools lie: the host sends only the
    index vectors ``si``/``ci`` and the host draws ``ks``/``flips``."""
    dev = snaps.device
    si = torch.as_tensor(np.asarray(si), dtype=torch.long).to(dev)
    ci = torch.as_tensor(np.asarray(ci), dtype=torch.long).to(dev)
    x = snaps.index_select(0, si)
    ctx = ctxs.index_select(0, ci.clamp_min(0))
    ctx = torch.where((ci >= 0)[:, None, None, None], ctx,
                      torch.zeros((), dtype=ctx.dtype, device=dev))
    x = torch.cat([x, ctx], dim=-1).to(torch.float32)
    return torch.stack([_device_dihedral(x[j], int(ks[j]), bool(flips[j]))
                        for j in range(x.shape[0])])


def fit(data_dir: str, out_path: str, steps: int = 600,
        batch_size: int = 8, learning_rate: float = 3e-4,
        val_fraction: float = 0.15, seed: int = 0,
        log_every: int = 50, sigma: float = 2.0,
        weight_decay: float = 1e-4, augment: bool = True,
        data_parallel: bool = False, conditioned: bool = False,
        device=None, devices=None):
    """Train the search policy on collected (top-down, goal-cell) pairs
    and save the parameters of the best validation smoothed-NLL seen as
    the ``.pth`` at ``out_path``; returns that (val NLL, val argmax
    distance).  The split is by task, targets are smoothed by ``sigma``
    cells and training batches take random dihedral augmentations, all
    drawn in the JAX package's order from ``RandomState(seed)``.

    ``data_parallel`` splits each batch over ``devices`` (default: every
    card from ``device``'s index on, one replica on the CPU;
    ``utils/training.data_devices``), which must divide it, as the JAX
    package's does over its devices, and assembles the batches on the host
    (as the JAX package does)."""
    if not out_path.endswith(".pth"):
        raise ValueError(f"{out_path} does not end in .pth: the policy "
                         f"saves as a policy.pth state dict, the format "
                         f"--policy-checkpoint reads")
    if data_parallel:
        devices = list(devices or data_devices(resolve_device(device)))
        device = devices[0]
        if batch_size % len(devices):
            raise ValueError(f"batch_size {batch_size} must divide over "
                             f"{len(devices)} devices")
    else:
        devices = None
    device = resolve_device(device)
    source = (load_dataset_conditioned(data_dir) if conditioned
              else _PlainSamples(*load_dataset(data_dir)))
    task_ids = source.task_ids
    cells = source.cells
    uniq = np.unique(task_ids)
    rng = np.random.RandomState(seed)
    rng.shuffle(uniq)
    if len(uniq) < 2:
        raise ValueError(
            f"need >= 2 tasks for a by-task train/val split, got "
            f"{len(uniq)} in {data_dir} — collect more tasks "
            f"(search.dataset --total-tasks)")
    # by-task split, but never let validation claim the training set
    n_val = min(max(1, int(len(uniq) * val_fraction)), len(uniq) - 1)
    val_tasks = set(uniq[:n_val].tolist())
    val_mask = np.isin(task_ids, list(val_tasks))
    tr_idx = np.nonzero(~val_mask)[0]
    va_idx = np.nonzero(val_mask)[0]
    h, w, c = source.shape
    print(f"dataset: {len(tr_idx)} train / {len(va_idx)} val samples "
          f"({len(uniq)} tasks, map {h}x{w}x{c}"
          f"{', conditioned' if conditioned else ''})", flush=True)

    state = create_train_state(torch.Generator().manual_seed(seed), c,
                               learning_rate, weight_decay, device, devices)
    if data_parallel:
        print(f"data-parallel over {len(devices)} devices", flush=True)
    # device-resident dataset: the fp16 snapshot and context pools go to
    # the device once and batches are assembled there
    device_data = conditioned and not data_parallel and h == w
    if device_data:
        snaps_dev = torch.from_numpy(source._snaps).to(device)
        ctxs_np = source._ctxs
        if not len(ctxs_np):
            ctxs_np = np.zeros((1,) + source._snaps.shape[1:],
                               source._snaps.dtype)
        ctxs_dev = torch.from_numpy(ctxs_np).to(device)
        si_all, ci_all = source._si, source._ci

    def host_batch(tops) -> torch.Tensor:
        return torch.from_numpy(np.stack(tops).astype(np.float32)).to(device)

    def val_batch(ids) -> torch.Tensor:
        if device_data:
            ident = np.zeros(len(ids), np.int64)
            return _assemble_conditioned(snaps_dev, ctxs_dev, si_all[ids],
                                         ci_all[ids], ident, ident)
        return host_batch([source.top(i) for i in ids])

    @torch.no_grad()
    def val_metrics():
        nll, dist, n = 0.0, 0.0, 0
        with exact_convs():
            for i0 in range(0, len(va_idx), batch_size):
                ids = va_idx[i0:i0 + batch_size]
                g = torch.from_numpy(cells[ids]).to(device)
                t = val_batch(ids)
                k = len(ids)
                nll += float(goal_cross_entropy(state.policy, t, g,
                                                sigma)) * k
                dist += float(goal_distance(state.policy, t, g)) * k
                n += k
        return nll / n, dist / n

    def snapshot():
        return {k: v.detach().clone()
                for k, v in state.policy.state_dict().items()}

    best = (float("inf"), None)
    for step in range(steps):
        idx = tr_idx[rng.randint(0, len(tr_idx), batch_size)]
        if device_data:
            if augment:
                ks = rng.randint(0, 4, batch_size)
                fl = rng.randint(0, 2, batch_size).astype(bool)
            else:
                ks = np.zeros(batch_size, np.int64)
                fl = np.zeros(batch_size, bool)
            gs = np.stack([
                _dihedral_cell(cells[i], int(ks[j]), bool(fl[j]), h, w)
                for j, i in enumerate(idx)])
            t = _assemble_conditioned(snaps_dev, ctxs_dev, si_all[idx],
                                      ci_all[idx], ks, fl)
        else:
            ts, gs = [], []
            for i in idx:
                top, g = source.top(i), cells[i]
                if augment:
                    top, g = _dihedral(top, g, int(rng.randint(4)),
                                       bool(rng.randint(2)))
                ts.append(np.ascontiguousarray(top))
                gs.append(g)
            t, gs = host_batch(ts), np.stack(gs)
        loss = train_step(state, t, torch.from_numpy(gs).to(device), sigma)
        if (step + 1) % log_every == 0 or step == 0:
            vn, vd = val_metrics()
            if vn < best[0]:
                best = (vn, snapshot())
            print(f"step {step + 1}/{steps}: train NLL "
                  f"{float(loss):.3f}  val NLL {vn:.3f}  "
                  f"val argmax-dist {vd:.1f} cells", flush=True)

    vn, vd = val_metrics()
    if vn < best[0]:
        best = (vn, snapshot())
    if best[1] is None:
        raise RuntimeError(
            f"training diverged: validation NLL was never finite "
            f"(final {vn}); lower --learning-rate — no checkpoint "
            f"saved")
    state.policy.load_state_dict(best[1])
    vn, vd = val_metrics()
    # chance references: uniform NLL = log(H*W); random-cell expected
    # distance ~ 0.52 * map size for uniform draws on a square
    print(f"best: val NLL {vn:.3f} (uniform {np.log(h * w):.3f})  "
          f"val argmax-dist {vd:.1f} cells", flush=True)
    if conditioned:
        # a conditioned head is multi-modal (one input, several labelled
        # site cells): score the argmax against the NEAREST label
        groups = {}
        for i in va_idx:
            groups.setdefault(int(source._si[i]), []).append(i)
        near = []
        for si, idxs in sorted(groups.items()):
            with exact_convs():
                lg = P.goal_logits(state.policy, host_batch(
                    [source.top(idxs[0])]))[0].cpu().numpy()
            am = int(lg.argmax())
            labels = cells[np.asarray(idxs)]
            near.append(float(np.min(np.hypot(labels[:, 0] - am % w,
                                              labels[:, 1] - am // w))))
        near = np.asarray(near)
        print(f"conditioned val: argmax-to-NEAREST-label mean "
              f"{near.mean():.1f} / median {np.median(near):.1f} cells "
              f"over {len(near)} held-out inputs", flush=True)
    save_state_dict(out_path, state.policy.state_dict())
    print(f"saved policy checkpoint to {out_path}", flush=True)
    return vn, vd


def main(argv=None):
    from mass_tpu_torch.agent.cli import (add_device_flags,
                                          resolve_device_flags)

    p = argparse.ArgumentParser("semantic-search policy trainer")
    p.add_argument("--data", type=str, required=True,
                   help="dir of task-*.npz from "
                        "mass_tpu_torch.search.dataset")
    p.add_argument("--out", type=str, required=True,
                   help="checkpoint output path (a .pth state dict)")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--val-fraction", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma", type=float, default=2.0,
                   help="goal heat-map smoothing, in map cells")
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--data-parallel", type=int, nargs="?", const=0,
                   default=None, metavar="N",
                   help="split each batch over every card, or over N "
                        "replicas (on the CPU: N replicas on the CPU)")
    p.add_argument("--conditioned", action="store_true",
                   help="walkthrough-conditioned input (2x channels: "
                        "current map + finished walkthrough map); the "
                        "agent detects such checkpoints")
    add_device_flags(p)
    args = p.parse_args(argv)
    device = resolve_device_flags(args)
    data_parallel = args.data_parallel is not None
    fit(args.data, args.out, steps=args.steps,
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        val_fraction=args.val_fraction, seed=args.seed,
        sigma=args.sigma, weight_decay=args.weight_decay,
        augment=not args.no_augment, data_parallel=data_parallel,
        conditioned=args.conditioned, device=device,
        devices=data_devices(resolve_device(device), args.data_parallel)
        if data_parallel else None)


if __name__ == "__main__":
    main()
