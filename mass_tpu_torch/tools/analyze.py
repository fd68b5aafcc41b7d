"""Result analysis and plotting over experiment logdirs (port of
``mass_tpu.tools.analyze``: a host-only copy, the same tables; scipy for
the tests, matplotlib and pandas imported only by the commands that
need them).

Covers the reference's visualize_* script family (reference:
visualize_metrics.py, visualize_budget_ablation.py,
visualize_detector_ablation.py, visualize_precision_recall.py,
visualize_found_objects.py, visualize_remainder.py) as subcommands over
one loader:

    python -m mass_tpu_torch.tools.analyze metrics  DIR [DIR...]
    python -m mass_tpu_torch.tools.analyze ablation DIR [DIR...] \
        --param exploration_budget_one --out curves.png
    python -m mass_tpu_torch.tools.analyze pr       DIR [DIR...]
    python -m mass_tpu_torch.tools.analyze found    DIR --out found.png
    python -m mass_tpu_torch.tools.analyze failures DIR [DIR...]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Sequence

import numpy as np

PRIMARY_METRICS = ["unshuffle/prop_fixed_strict", "unshuffle/success",
                   "unshuffle/num_initially_misplaced",
                   "unshuffle/num_newly_misplaced"]


def is_task_result(path: str) -> bool:
    """True for per-task result records (``<task>.json``, task ids are
    digits or dash-joined digit groups).  The found-objects recorder
    drops ``objects-found-<phase>-<task>-types.json`` sidecars into the
    same ``results/`` directory, and ad-hoc files can land there too —
    every loader (here and tools/submission.py) must use THIS predicate
    so non-task files are skipped consistently."""
    name = os.path.splitext(os.path.basename(path))[0]
    return all(p.isdigit() for p in name.split("-"))


def load_results(logdir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(
            os.path.join(logdir, "results", "*.json"))):
        if not is_task_result(path):
            continue
        with open(path) as f:
            rec = json.load(f)
        rec["_logdir"] = os.path.basename(os.path.normpath(logdir))
        rec["_task"] = os.path.splitext(os.path.basename(path))[0]
        out.append(rec)
    return out


def timing_table(logdirs: List[str]) -> Dict[str, Dict[str, Dict]]:
    """Aggregate the per-task ``timing`` blocks (utils/profiling
    StageTimer, written into every results JSON — SURVEY.md §5.1) into
    per-stage totals: call-weighted mean ms, total seconds, calls.
    """
    out: Dict[str, Dict[str, Dict]] = {}
    for logdir in logdirs:
        stages: Dict[str, Dict] = {}
        tasks = 0
        records = 0
        for rec in load_results(logdir):
            records += 1
            timing = rec.get("timing")
            if timing:
                tasks += 1
            # fleet-wide summaries (parallel/evaluator.py writes one
            # per batch under "fleet_timing") aggregate under a
            # "fleet:" prefix so they never average against per-task
            # blocks from sequential runs in the same logdir
            blocks = ([(stage, row) for stage, row in timing.items()]
                      if timing else [])
            blocks += [("fleet:" + stage, row) for stage, row
                       in (rec.get("fleet_timing") or {}).items()]
            for stage, row in blocks:
                agg = stages.setdefault(
                    stage, {"total_s": 0.0, "count": 0})
                agg["total_s"] += row.get("total_s", 0.0)
                agg["count"] += row.get("count", 0)
        for stage, agg in stages.items():
            agg["mean_ms"] = (1e3 * agg["total_s"] / agg["count"]
                              if agg["count"] else 0.0)
            # fleet blocks are batch-wide: amortize over every result
            # record in the logdir, not just those carrying per-task
            # timing (a fleet batch of B tasks writes ONE block)
            denom = records if stage.startswith("fleet:") else tasks
            agg["s_per_task"] = (agg["total_s"] / denom if denom
                                 else 0.0)
        stages["_tasks"] = tasks
        out[os.path.basename(os.path.normpath(logdir))] = stages
    return out


def paired_compare(dir_a: str, dir_b: str,
                   metric: str = "unshuffle/prop_fixed_strict") -> Dict:
    """Matched-seed comparison of two arms: pooled means ± CI over the
    COMMON task ids, per-task win/loss counts, and an exact McNemar
    test on the discordant pairs (binary metrics).  Beyond the
    reference's tooling — its figures show pooled bars only
    (visualize_metrics.py), which round-3 sweeps showed can be
    noise-inflated at small n (docs/experiments.md, 160-geometry
    null): episode outcomes on matched seeds are heavily correlated,
    so the paired test is the honest one."""
    from scipy import stats
    a = {r["_task"]: r.get(metric) for r in load_results(dir_a)}
    b = {r["_task"]: r.get(metric) for r in load_results(dir_b)}
    common = sorted(set(a) & set(b), key=lambda t: (len(t), t))
    if not common:
        raise SystemExit(f"no common task ids between {dir_a} and "
                         f"{dir_b}")
    va = np.asarray([a[t] for t in common], np.float64)
    vb = np.asarray([b[t] for t in common], np.float64)
    wins = int(((va > vb)).sum())
    losses = int(((va < vb)).sum())
    if wins + losses:
        p = float(stats.binomtest(wins, wins + losses, 0.5).pvalue)
    else:
        p = 1.0
    # continuous metrics (e.g. unshuffle/observed_cells) also get the
    # paired t — the sign test alone discards the magnitudes
    t_stat, t_p = _paired_t(va, vb)
    return dict(n=len(common),
                mean_a=mean_ci(va), mean_b=mean_ci(vb),
                wins=wins, losses=losses, ties=len(common) - wins -
                losses, mcnemar_p=p, t=t_stat, t_p=t_p, metric=metric)


def paired_found_compare(dir_a: str, dir_b: str,
                         phase: str = "unshuffle",
                         radius: float = 1.0) -> Dict:
    """Matched-seed paired t-test on the FINAL fraction of objects
    approached within ``radius`` per task (the found-objects endpoint;
    distances recorded by ``--record-found-objects``, reference:
    agent.py:612-631).  This is the pre-registered primary endpoint of
    the multi-room exploration sweeps (docs/experiments.md): unlike the
    binary fix-rate it is continuous, so the paired t-test applies."""
    from scipy import stats

    def final_rates(logdir):
        out = {}
        for path in glob.glob(os.path.join(
                logdir, "results", f"objects-found-{phase}-*.npy")):
            tid = os.path.basename(path)[len(
                f"objects-found-{phase}-"):-len(".npy")]
            dist = np.load(path)                 # [objects, timesteps]
            if dist.size == 0:
                continue
            out[tid] = float(
                (np.minimum.accumulate(dist, axis=1)[:, -1]
                 <= radius).mean())
        return out

    a, b = final_rates(dir_a), final_rates(dir_b)
    common = sorted(set(a) & set(b), key=lambda t: (len(t), t))
    if not common:
        raise SystemExit(
            f"no common found-objects recordings ({phase}) between "
            f"{dir_a} and {dir_b} — run with --record-found-objects")
    va = np.asarray([a[t] for t in common], np.float64)
    vb = np.asarray([b[t] for t in common], np.float64)
    t_stat, p = _paired_t(va, vb)
    return dict(n=len(common), phase=phase, radius=radius,
                mean_a=mean_ci(va), mean_b=mean_ci(vb),
                delta=float((va - vb).mean()), t=t_stat, p=p)


def _paired_t(va: np.ndarray, vb: np.ndarray):
    """ttest_rel with the degenerate cases pinned: identical arms ->
    (0, 1); a CONSTANT nonzero difference (possible for integer
    metrics at small n) has zero difference-variance, where ttest_rel
    returns inf/nan — report it as the certain direction it is."""
    from scipy import stats
    d = va - vb
    if np.allclose(d, 0):
        return 0.0, 1.0
    if np.allclose(d.std(), 0):
        return float(np.sign(d.mean()) * np.inf), 0.0
    return tuple(float(x) for x in stats.ttest_rel(va, vb))


def mean_ci(values, confidence: float = 0.68):
    """Mean with a t-interval like the reference's seaborn error bars
    (reference: visualize_metrics.py:80-95)."""
    from scipy import stats
    values = np.asarray(values, np.float64)
    if len(values) < 2:
        return float(values.mean()) if len(values) else float("nan"), 0.0
    half = stats.t.interval(
        confidence, len(values) - 1, loc=values.mean(),
        scale=stats.sem(values) + 1e-12)
    return float(values.mean()), float((half[1] - half[0]) / 2)


def metrics_table(logdirs) -> Dict[str, Dict[str, tuple]]:
    table = {}
    for logdir in logdirs:
        recs = load_results(logdir)
        row = {}
        for key in PRIMARY_METRICS:
            vals = [r[key] for r in recs if key in r]
            row[key] = mean_ci(vals)
        table[logdir] = row
    return table


def precision_recall(logdirs) -> Dict[str, Dict[str, float]]:
    """Per-class precision/recall of difference detection from the
    moved/to-move accuracy fields (reference:
    visualize_precision_recall.py:33-75)."""
    stats: Dict[str, Dict[str, int]] = {}
    for logdir in logdirs:
        for rec in load_results(logdir):
            moved = rec.get("unshuffle/objects_moved", [])
            moved_ok = rec.get("unshuffle/objects_moved_accuracy", [])
            to_move = rec.get("unshuffle/objects_to_move", [])
            to_move_ok = rec.get(
                "unshuffle/objects_to_move_accuracy", [])
            for name, ok in zip(moved, moved_ok):
                s = stats.setdefault(name, dict(tp=0, fp=0, fn=0))
                s["tp" if ok else "fp"] += 1
            for name, ok in zip(to_move, to_move_ok):
                if not ok:
                    stats.setdefault(
                        name, dict(tp=0, fp=0, fn=0))["fn"] += 1
    out = {}
    for name, s in sorted(stats.items()):
        precision = s["tp"] / max(s["tp"] + s["fp"], 1)
        recall = s["tp"] / max(s["tp"] + s["fn"], 1)
        out[name] = dict(precision=precision, recall=recall, **s)
    return out


def failure_modes(logdirs) -> Dict[str, int]:
    """Stacked failure attribution (reference: visualize_remainder.py):
    solved / failed-to-detect / failed-to-rearrange / incorrect-object /
    exceeded-time."""
    counts = dict(TaskSolved=0, FailedToDetectDisagreement=0,
                  FailedToRearrangeDisagreement=0,
                  IncorrectObjectRearranged=0, ExceededTimeLimit=0)
    for logdir in logdirs:
        for rec in load_results(logdir):
            if rec.get("unshuffle/success"):
                counts["TaskSolved"] += 1
            elif any(v == 0 for v in rec.get(
                    "unshuffle/objects_moved_accuracy", [])):
                counts["IncorrectObjectRearranged"] += 1
            elif any(v == 0 for v in rec.get(
                    "unshuffle/objects_to_move_accuracy", [])):
                counts["FailedToDetectDisagreement"] += 1
            elif rec.get("unshuffle/ep_length", 0) >= 250:
                counts["ExceededTimeLimit"] += 1
            else:
                counts["FailedToRearrangeDisagreement"] += 1
    return counts


def found_objects_stats(logdir: str, radius: float = 1.0):
    """Per-phase (mean curve, sem curve, n tasks) of the fraction of
    objects approached within ``radius`` by each timestep, from the
    recorded distance matrices (reference:
    visualize_found_objects.py:37-107)."""
    stats = {}
    for phase in ("walkthrough", "unshuffle"):
        per_task = []
        for path in glob.glob(os.path.join(
                logdir, "results", f"objects-found-{phase}-*.npy")):
            dist = np.load(path)  # [objects, timesteps]
            found = np.minimum.accumulate(dist, axis=1) <= radius
            per_task.append(found.mean(axis=0))
        if per_task:
            n = max(len(c) for c in per_task)
            padded = np.stack([
                np.pad(c, (0, n - len(c)), constant_values=c[-1])
                for c in per_task])
            sem = (padded.std(axis=0, ddof=1) / np.sqrt(len(padded))
                   if len(padded) > 1 else np.zeros(n))
            stats[phase] = (padded.mean(axis=0), sem, len(padded))
    return stats


def found_objects_curves(logdir: str, radius: float = 1.0):
    """Mean %found-vs-timestep curves (see found_objects_stats)."""
    return {phase: mean for phase, (mean, _, _)
            in found_objects_stats(logdir, radius).items()}


def found_objects_stats_by_class(logdir: str, radius: float = 1.0):
    """Per-phase, per-CLASS found curves: ``{phase: {class: (mean,
    sem, n_instances)}}`` — each misplaced-object instance is one row,
    grouped by the class names in the ``objects-found-*-types.json``
    sidecars (agent/metrics.write_found_objects).  Tasks recorded
    before the sidecar existed are skipped."""
    stats: Dict[str, Dict] = {}
    for phase in ("walkthrough", "unshuffle"):
        rows: Dict[str, List[np.ndarray]] = {}
        for path in glob.glob(os.path.join(
                logdir, "results", f"objects-found-{phase}-*.npy")):
            types_path = path[:-len(".npy")] + "-types.json"
            if not os.path.exists(types_path):
                continue
            with open(types_path) as f:
                types = json.load(f)
            dist = np.load(path)  # [objects, timesteps]
            if len(types) != len(dist):
                continue
            found = np.minimum.accumulate(dist, axis=1) <= radius
            for cls, row in zip(types, found):
                rows.setdefault(cls, []).append(row.astype(np.float64))
        per_class = {}
        for cls, curves in rows.items():
            n = max(len(c) for c in curves)
            padded = np.stack([
                np.pad(c, (0, n - len(c)), constant_values=c[-1])
                for c in curves])
            sem = (padded.std(axis=0, ddof=1) / np.sqrt(len(padded))
                   if len(padded) > 1 else np.zeros(n))
            per_class[cls] = (padded.mean(axis=0), sem, len(padded))
        if per_class:
            stats[phase] = per_class
    return stats


def final_found_rate_by_radius(logdir: str, radii: Sequence[float]):
    """Final (episode-end) found rate as a function of the proximity
    radius: ``{phase: [(radius, mean, sem, n_tasks)]}`` — the radius
    sweep that shows whether an arm's found-rate edge is an artifact
    of one threshold or holds across proximity scales."""
    out: Dict[str, List] = {}
    for phase in ("walkthrough", "unshuffle"):
        min_dists = []  # per task: [objects] min distance over time
        for path in glob.glob(os.path.join(
                logdir, "results", f"objects-found-{phase}-*.npy")):
            min_dists.append(np.load(path).min(axis=1))
        if not min_dists:
            continue
        out[phase] = []
        for r in radii:
            rates = np.asarray([(d <= r).mean() for d in min_dists])
            sem = (rates.std(ddof=1) / np.sqrt(len(rates))
                   if len(rates) > 1 else 0.0)
            out[phase].append((float(r), float(rates.mean()),
                               float(sem), len(rates)))
    return out


def sweep_value(logdir: str, param: str):
    """The swept parameter's value for a logdir, read from the
    hyperparameter dump the CLI writes (``params-*.json``,
    agent/cli.py — keys are argparse dest names, e.g.
    ``exploration_budget_one``, ``detection_threshold``)."""
    for path in sorted(glob.glob(os.path.join(logdir,
                                              "params-*.json"))):
        with open(path) as f:
            params = json.load(f)
        if param in params:
            return params[param]
    return None


def ablation_table(logdirs, param: str, group_by: str = None):
    """Group logdirs by swept-parameter value and aggregate each
    group's task results into metric mean ± CI — the curve data of the
    reference's sweep plots (reference:
    visualize_budget_ablation.py:88-90, visualize_detector_ablation.py:
    metric vs sweep value with seaborn CI bands).

    ``group_by`` names a second params-json key that splits the dirs
    into SERIES (one curve per distinct value) — e.g. sweep
    ``exploration_budget_one`` grouped by ``policy_checkpoint`` plots
    random-vs-policy budget curves side by side, like the reference's
    per-method budget figure."""
    groups: Dict = {}
    for logdir in logdirs:
        value = sweep_value(logdir, param)
        if value is None:
            raise SystemExit(
                f"{logdir}: no '{param}' in any params-*.json — pass "
                f"--param with a key from the CLI's hyperparameter "
                f"dump")
        series = (_series_label(sweep_value(logdir, group_by))
                  if group_by else None)
        groups.setdefault(series, {}).setdefault(value, []).extend(
            load_results(logdir))
    tables = {}
    for series, by_value in groups.items():
        table = {}
        for value in sorted(by_value):
            recs = by_value[value]
            table[value] = {
                key: mean_ci([r[key] for r in recs if key in r])
                for key in PRIMARY_METRICS}
            table[value]["_n"] = len(recs)
        tables[series] = table
    return tables


def _series_label(value) -> str:
    """Readable series name for a grouping value (checkpoint paths
    shrink to their basename; None means the feature is off)."""
    if value is None:
        return "off"
    if isinstance(value, str) and "/" in value:
        return os.path.basename(os.path.normpath(value))
    return str(value)


def _plot_curves(tables, param: str, out: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    keys = PRIMARY_METRICS[:2]
    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4))
    for ax, key in zip(np.atleast_1d(axes), keys):
        for series, table in tables.items():
            values = list(table)
            means = np.asarray([table[v][key][0] for v in values])
            errs = np.asarray([table[v][key][1] for v in values])
            line, = ax.plot(values, means, marker="o", label=series)
            ax.fill_between(values, means - errs, means + errs,
                            alpha=0.25, color=line.get_color())
        ax.set_xlabel(param)
        ax.set_title(key)
        ax.grid(True, alpha=0.3)
        if len(tables) > 1:
            ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def _plot_failure_modes(per_dir: Dict[str, Dict[str, int]], out: str):
    """Stacked failure-attribution bars, one bar per logdir
    (reference: visualize_remainder.py tail)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    names = list(per_dir)
    modes = list(next(iter(per_dir.values())))
    fig, ax = plt.subplots(figsize=(1.8 + 1.2 * len(names), 4.5))
    bottom = np.zeros(len(names))
    for mode in modes:
        vals = np.asarray([per_dir[n][mode] for n in names], float)
        ax.bar(range(len(names)), vals, bottom=bottom, label=mode)
        bottom += vals
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels([os.path.basename(os.path.normpath(n))
                        for n in names], rotation=30, ha="right")
    ax.set_ylabel("episodes")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def _plot_precision_recall(stats: Dict[str, Dict[str, float]],
                           out: str):
    """Per-class precision/recall bars of difference detection
    (reference: visualize_precision_recall.py:33-75)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    names = list(stats)
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(2.0 + 0.45 * len(names), 4.0))
    ax.bar(x - 0.2, [stats[n]["precision"] for n in names], 0.4,
           label="precision")
    ax.bar(x + 0.2, [stats[n]["recall"] for n in names], 0.4,
           label="recall")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=60, ha="right", fontsize=7)
    ax.set_ylim(0, 1.05)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def _plot_bars(table, out):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    keys = PRIMARY_METRICS[:2]
    fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4))
    for ax, key in zip(np.atleast_1d(axes), keys):
        names = list(table)
        means = [table[n][key][0] for n in names]
        errs = [table[n][key][1] for n in names]
        ax.bar(range(len(names)), means, yerr=errs)
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels([os.path.basename(os.path.normpath(n))
                            for n in names], rotation=30, ha="right")
        ax.set_title(key)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def object_analytics(logdirs):
    """Aggregate the per-object analytics CSVs: per-type counts, mean
    initial/final distances, and fix rates (reference:
    visualize_analytics.py over analytics-*.csv)."""
    import pandas as pd
    frames = []
    for logdir in logdirs:
        for path in glob.glob(os.path.join(logdir, "results",
                                           "analytics-*.csv")):
            frames.append(pd.read_csv(path))
    if not frames:
        return None
    df = pd.concat(frames, ignore_index=True)
    misplaced = df[~df["initial_correct"]]
    out = misplaced.groupby("type").agg(
        count=("type", "size"),
        initial_distance=("initial_distance", "mean"),
        final_distance=("final_distance", "mean"),
        fixed_rate=("final_correct", "mean"))
    return out.sort_values("count", ascending=False)


ANALYTICS_XS = ["size", "initial_distance", "initial_min_distance_type"]


def _plot_analytics(logdirs, out_path: str, bins: int = 10):
    """Binned fix-rate curves over object features — the reference's
    analytics panels (reference: visualize_analytics.py defaults:
    xs = size / initial_distance / initial_min_distance_type,
    y = final_correct, 10 bins over misplaced objects)."""
    import pandas as pd
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = []
    for logdir in logdirs:
        for path in glob.glob(os.path.join(logdir, "results",
                                           "analytics-*.csv")):
            frames.append(pd.read_csv(path))
    df = pd.concat(frames, ignore_index=True)
    misplaced = df[~df["initial_correct"]]

    fig, axes = plt.subplots(1, len(ANALYTICS_XS),
                             figsize=(4 * len(ANALYTICS_XS), 3.2))
    for ax, x in zip(np.atleast_1d(axes), ANALYTICS_XS):
        sub = misplaced[[x, "final_correct"]].dropna()
        if not len(sub):
            ax.set_title(f"{x} (no data)")
            continue
        edges = np.quantile(sub[x], np.linspace(0, 1, bins + 1))
        edges = np.unique(edges)
        centers, rates = [], []
        for lo, hi in zip(edges[:-1], edges[1:]):
            m = (sub[x] >= lo) & (sub[x] <= hi)
            if m.any():
                centers.append((lo + hi) / 2)
                rates.append(float(sub.loc[m, "final_correct"].mean()))
        ax.plot(centers, rates, marker="o")
        ax.set_xlabel(x)
        ax.set_ylabel("fix rate")
        ax.set_ylim(-0.05, 1.05)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    print(f"wrote {out_path}")


def main(argv=None):
    p = argparse.ArgumentParser("result analysis")
    p.add_argument("command", choices=["metrics", "ablation", "pr",
                                       "found", "failures",
                                       "analytics", "compare",
                                       "timing"])
    p.add_argument("logdirs", nargs="+")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--radius", type=float, default=1.0)
    p.add_argument("--radii", type=str, default=None,
                   help="found: comma-separated radius sweep (e.g. "
                        "'0.5,1,2') — prints/plots the FINAL found "
                        "rate vs radius instead of time curves")
    p.add_argument("--per-class", action="store_true",
                   help="found: split curves by object class (needs "
                        "the objects-found-*-types.json sidecars)")
    p.add_argument("--bins", type=int, default=10,
                   help="analytics: quantile bins for fix-rate curves")
    p.add_argument("--param", type=str,
                   default="exploration_budget_one",
                   help="ablation: swept hyperparameter (params-*.json "
                        "key, e.g. exploration_budget_one, "
                        "detection_threshold)")
    p.add_argument("--group-by", type=str, default=None,
                   help="ablation: second params key splitting the "
                        "dirs into one curve per value (e.g. "
                        "policy_checkpoint for random-vs-policy "
                        "budget curves)")
    p.add_argument("--metric", type=str,
                   default="unshuffle/prop_fixed_strict",
                   help="compare: results-json key to pair on")
    args = p.parse_args(argv)

    if args.command == "metrics":
        table = metrics_table(args.logdirs)
        for name, row in table.items():
            print(name)
            for key, (mean, ci) in row.items():
                print(f"  {key:42s} {mean:8.4f} ± {ci:.4f}")
        if args.out:
            _plot_bars(table, args.out)
    elif args.command == "ablation":
        tables = ablation_table(args.logdirs, args.param,
                                group_by=args.group_by)
        for series, table in tables.items():
            if series is not None:
                print(f"[{args.group_by} = {series}]")
            for value, row in table.items():
                print(f"{args.param} = {value}  (n={row['_n']})")
                for key in PRIMARY_METRICS:
                    mean, ci = row[key]
                    print(f"  {key:42s} {mean:8.4f} ± {ci:.4f}")
        if args.out:
            _plot_curves(tables, args.param, args.out)
    elif args.command == "pr":
        stats = precision_recall(args.logdirs)
        for name, s in stats.items():
            print(f"{name:20s} precision={s['precision']:.3f} "
                  f"recall={s['recall']:.3f} "
                  f"(tp={s['tp']} fp={s['fp']} fn={s['fn']})")
        if args.out and stats:
            _plot_precision_recall(stats, args.out)
    elif args.command == "failures":
        per_dir = {d: failure_modes([d]) for d in args.logdirs}
        total: Dict[str, int] = {}
        for counts in per_dir.values():
            for mode, count in counts.items():
                total[mode] = total.get(mode, 0) + count
        for mode, count in total.items():
            print(f"{mode:32s} {count}")
        if args.out:
            _plot_failure_modes(per_dir, args.out)
    elif args.command == "analytics":
        table = object_analytics(args.logdirs)
        print(table if table is not None else "no analytics CSVs found")
        if args.out and table is not None:
            _plot_analytics(args.logdirs, args.out, bins=args.bins)
    elif args.command == "timing":
        for name, stages in timing_table(args.logdirs).items():
            tasks = stages.pop("_tasks")
            print(f"{name}  (n={tasks} tasks with timing)")
            order = sorted(stages, key=lambda s: -stages[s]["total_s"])
            for stage in order:
                a = stages[stage]
                print(f"  {stage:16s} {a['mean_ms']:9.2f} ms/call"
                      f"  x{a['count']:>7d}"
                      f"  {a['s_per_task']:8.2f} s/task")
    elif args.command == "compare":
        if len(args.logdirs) != 2:
            raise SystemExit("compare takes exactly two logdirs")
        if args.metric.startswith("found"):
            # --metric found[:phase] — paired t-test on the final
            # per-task found-objects rate at --radius
            phase = (args.metric.split(":", 1) + ["unshuffle"])[1] \
                if ":" in args.metric else "unshuffle"
            r = paired_found_compare(args.logdirs[0], args.logdirs[1],
                                     phase=phase, radius=args.radius)
            (ma, ca), (mb, cb) = r["mean_a"], r["mean_b"]
            print(f"final {r['phase']} found rate @ {r['radius']} m  "
                  f"(n={r['n']} matched tasks)")
            print(f"  {args.logdirs[0]:40s} {ma:8.4f} ± {ca:.4f}")
            print(f"  {args.logdirs[1]:40s} {mb:8.4f} ± {cb:.4f}")
            print(f"  paired t: delta {r['delta']:+.4f}  "
                  f"t = {r['t']:.3f}  p = {r['p']:.4g}")
        else:
            r = paired_compare(args.logdirs[0], args.logdirs[1],
                               metric=args.metric)
            (ma, ca), (mb, cb) = r["mean_a"], r["mean_b"]
            print(f"{r['metric']}  (n={r['n']} matched tasks)")
            print(f"  {args.logdirs[0]:40s} {ma:8.4f} ± {ca:.4f}")
            print(f"  {args.logdirs[1]:40s} {mb:8.4f} ± {cb:.4f}")
            print(f"  paired: A-wins {r['wins']}  B-wins {r['losses']}"
                  f"  ties {r['ties']}  exact McNemar p = "
                  f"{r['mcnemar_p']:.4f}")
            print(f"  paired t: t = {r['t']:.3f}  p = {r['t_p']:.4g}")
    elif args.command == "found" and args.radii:
        # radius sweep: final found rate vs proximity radius, one line
        # per (logdir, phase) — is the found-rate edge threshold-bound?
        radii = [float(r) for r in args.radii.split(",")]
        per_dir = {d: final_found_rate_by_radius(d, radii)
                   for d in args.logdirs}
        for d, phases in per_dir.items():
            name = os.path.basename(d.rstrip("/"))
            for phase, rows in phases.items():
                for r, mean, sem, n in rows:
                    print(f"{name} {phase} @ {r:g} m (n={n}): "
                          f"{mean*100:.1f}% ± {sem*100:.1f}")
        if args.out and any(per_dir.values()):
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6.5, 4))
            styles = {"walkthrough": "-", "unshuffle": "--"}
            for i, (d, phases) in enumerate(per_dir.items()):
                for phase, rows in phases.items():
                    xs = [r for r, *_ in rows]
                    ms = np.asarray([m for _, m, _, _ in rows]) * 100
                    ss = np.asarray([s for _, _, s, _ in rows]) * 100
                    label = (f"{os.path.basename(d.rstrip('/'))} "
                             f"{phase}")
                    ax.plot(xs, ms, styles.get(phase, "-"),
                            color=f"C{i}", marker="o", label=label)
                    ax.fill_between(xs, ms - ss, ms + ss,
                                    color=f"C{i}", alpha=0.15,
                                    linewidth=0)
            ax.set_xlabel("proximity radius (m)")
            ax.set_ylabel("% objects found at episode end")
            ax.set_ylim(0, 102)
            ax.legend(fontsize=8)
            fig.tight_layout()
            fig.savefig(args.out, dpi=120)
            print(f"wrote {args.out}")
    elif args.command == "found" and args.per_class:
        # per-class curves: where do the heads differ — which object
        # classes does an arm find that another misses?
        for d in args.logdirs:
            name = os.path.basename(d.rstrip("/"))
            stats = found_objects_stats_by_class(d, args.radius)
            if not stats:
                print(f"{name}: no types sidecars — re-run with "
                      f"--record-found-objects on the current build")
                continue
            for phase, per_class in stats.items():
                order = sorted(per_class,
                               key=lambda c: -per_class[c][0][-1])
                for cls in order:
                    mean, _, n = per_class[cls]
                    print(f"{name} {phase} {cls:20s} (n={n}): "
                          f"final {mean[-1]*100:.1f}%")
        if args.out:
            if len(args.logdirs) != 1:
                raise SystemExit("--per-class plots one logdir")
            stats = found_objects_stats_by_class(args.logdirs[0],
                                                 args.radius)
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, axes = plt.subplots(1, max(len(stats), 1),
                                     figsize=(6 * max(len(stats), 1),
                                              4))
            for ax, (phase, per_class) in zip(
                    np.atleast_1d(axes), sorted(stats.items())):
                for j, cls in enumerate(sorted(per_class)):
                    mean, sem, n = per_class[cls]
                    x = np.arange(len(mean))
                    ax.plot(x, mean * 100, color=f"C{j % 10}",
                            label=f"{cls} (n={n})")
                    ax.fill_between(x, (mean - sem) * 100,
                                    (mean + sem) * 100,
                                    color=f"C{j % 10}", alpha=0.15,
                                    linewidth=0)
                ax.set_title(phase)
                ax.set_xlabel("timestep")
                ax.set_ylabel(f"% within {args.radius} m")
                ax.set_ylim(0, 102)
                ax.legend(fontsize=7)
            fig.tight_layout()
            fig.savefig(args.out, dpi=120)
            print(f"wrote {args.out}")
    elif args.command == "found":
        # one logdir: phase curves; several: overlay the arms with
        # 68% CI bands — the exploration-efficiency comparison
        # (reference: visualize_found_objects.py overlays methods)
        per_dir = {d: found_objects_stats(d, args.radius)
                   for d in args.logdirs}
        for d, stats in per_dir.items():
            for phase, (mean, _, n) in stats.items():
                half = np.argmax(mean >= 0.5) if (mean >= 0.5).any() \
                    else None
                half_s = f"50% by step {half}" if half is not None \
                    else "never reaches 50%"
                print(f"{os.path.basename(d.rstrip('/'))} {phase} "
                      f"(n={n}): {half_s}; final {mean[-1]*100:.1f}% "
                      f"by step {len(mean)}")
        if args.out and any(per_dir.values()):
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6.5, 4))
            styles = {"walkthrough": "-", "unshuffle": "--"}
            for i, (d, stats) in enumerate(per_dir.items()):
                color = f"C{i}"
                for phase, (mean, sem, n) in stats.items():
                    label = (f"{os.path.basename(d.rstrip('/'))} "
                             f"{phase}" if len(per_dir) > 1 else phase)
                    x = np.arange(len(mean))
                    ax.plot(x, mean * 100, styles.get(phase, "-"),
                            color=color, label=label)
                    ax.fill_between(x, (mean - sem) * 100,
                                    (mean + sem) * 100, color=color,
                                    alpha=0.15, linewidth=0)
            ax.set_xlabel("timestep")
            ax.set_ylabel(f"% objects within {args.radius} m")
            ax.set_ylim(0, 102)
            ax.legend(fontsize=8)
            fig.tight_layout()
            fig.savefig(args.out, dpi=120)
            print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
