"""Pack per-task metrics into a challenge submission archive (port of
``mass_tpu.tools.submission``).

Merges ``results/*.json`` across stage logdirs into a single gzipped
``submission.json.gz``, padding truncated walkthrough action sequences
with a terminal ``done`` the way the challenge expects (reference:
create_submission.py).

    python -m mass_tpu_torch.tools.submission --logdirs run-val run-test \
        --output submission.json.gz
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from mass_tpu_torch.tools import analyze

MAX_WALKTHROUGH_ACTIONS = 250


def collect(logdirs):
    merged = {}
    for logdir in logdirs:
        for path in sorted(glob.glob(
                os.path.join(logdir, "results", "*.json"))):
            name = os.path.splitext(os.path.basename(path))[0]
            # shared predicate with tools/analyze.load_results so the
            # two loaders can never skip results/ files inconsistently
            if not analyze.is_task_result(path):
                continue
            with open(path) as f:
                record = json.load(f)
            key = record.get("unique_id", record.get(
                "task_id", f"{os.path.basename(logdir)}/{name}"))
            actions = record.get("walkthrough_actions")
            if actions is not None and (
                    len(actions) < MAX_WALKTHROUGH_ACTIONS and
                    (not actions or actions[-1] != "done")):
                actions.append("done")
                taken = record.get("walkthrough_actions_taken")
                if taken is not None:
                    taken.append(True)
            merged[str(key)] = record
    return merged


def main(argv=None):
    p = argparse.ArgumentParser("submission packer")
    p.add_argument("--logdirs", type=str, nargs="+", required=True)
    p.add_argument("--output", type=str, default="submission.json.gz")
    args = p.parse_args(argv)
    merged = collect(args.logdirs)
    with gzip.open(args.output, "wt") as f:
        json.dump(merged, f)
    print(f"packed {len(merged)} task records into {args.output}")


if __name__ == "__main__":
    main()
