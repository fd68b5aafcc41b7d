"""Harvest the simulator's class->color segmentation table (port of
``mass_tpu.tools.color_mappings``; reference:
get_color_mappings.py, which iterates THOR tasks reading
``object_id_to_color`` for misplaced objects — the origin of the
taxonomy color constants).

Against THOR this walks episodes and dumps the harvested mapping;
against the grid world it reads the colors straight from the taxonomy
(the grid world renders with them), so the tool mainly serves as the
THOR-side regeneration path when the upstream simulator changes.

    python -m mass_tpu_torch.tools.color_mappings --backend thor \
        --total-tasks 10 --out colors.json
"""

from __future__ import annotations

import argparse
import json

from mass_tpu_torch import taxonomy


def harvest_thor(total_tasks: int):
    from mass_tpu_torch.env.thor import ThorTaskSampler
    sampler = ThorTaskSampler(ground_truth=True)
    mapping = {}
    for _ in range(total_tasks):
        task = sampler.next_task()
        env = task._active_env()
        for object_id, color in \
                env.last_event.object_id_to_color.items():
            object_type = object_id.split("|")[0]
            if object_type in taxonomy.CLASS_TO_COLOR and \
                    object_type not in mapping:
                mapping[object_type] = tuple(int(c) for c in color)
        sampler.next_task()  # consume the paired unshuffle phase
    return mapping


def main(argv=None):
    p = argparse.ArgumentParser("color-mapping harvester")
    p.add_argument("--backend", type=str, default="gridworld",
                   choices=["gridworld", "thor"])
    p.add_argument("--total-tasks", type=int, default=10)
    p.add_argument("--out", type=str, default="colors.json")
    args = p.parse_args(argv)
    if args.backend == "thor":
        mapping = harvest_thor(args.total_tasks)
    else:
        mapping = {k: list(v)
                   for k, v in taxonomy.CLASS_TO_COLOR.items()}
    with open(args.out, "w") as f:
        json.dump(mapping, f, indent=2)
    print(f"wrote {len(mapping)} class colors to {args.out}")


if __name__ == "__main__":
    main()
