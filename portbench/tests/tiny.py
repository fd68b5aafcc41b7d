"""A copy of the benchmark's data at a size the CPU runs in seconds: the
same cells, metrics and limits, each configuration cut to an 80x80x24
map at 0.125 m and a 64 px camera, the house to 6 m, the fleet to 4
episodes of 12 frames with missions of at most 5 plans."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY_CONFIG = dict(camera_size=64, map_height=80, map_width=80,
                   map_depth=24, grid_resolution=0.125, step_size=2,
                   obstacle_padding=2, map_slice_start=0, map_slice_stop=12,
                   graph_update_interval=3)
TINY_TRAFFIC = dict(batch=4, frames_per_episode=12, room=[6.0, 2.5, 6.0],
                    families=["semantic0", "semantic0", "semantic1",
                              "semantic1"],
                    setup_frames=[0, 0, 6, 6], max_goal_steps=5,
                    warmup_ticks=2, traced_ticks=2, check_rate=1.0,
                    render_chunk=4, max_ticks=1000)


def tiny_root(path: str) -> str:
    """Write the tiny benchmark under ``path``; returns ``path``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    os.makedirs(os.path.join(path, "portbench", "configs"))
    os.makedirs(os.path.join(path, "portbench", "traffic"))
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(path, "portbench", "metrics"))
    shutil.copytree(os.path.join(BENCH, "limits"),
                    os.path.join(path, "portbench", "limits"))
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        config.update(TINY_CONFIG)
        if config.get("sensor"):
            config["sensor"]["image_size"] = TINY_CONFIG["camera_size"]
            # a 64 px frame scores lower than a 224 px one
            config["detection_threshold"] = 0.1
        with open(os.path.join(path, c["file"]), "w") as f:
            json.dump(config, f)
    names = {w["traffic"] for w in spec["workloads"]}
    for name in names:
        with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
            traffic = json.load(f)
        traffic.update(TINY_TRAFFIC)
        with open(os.path.join(path, "portbench", "traffic",
                               f"{name}.json"), "w") as f:
            json.dump(traffic, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return path
