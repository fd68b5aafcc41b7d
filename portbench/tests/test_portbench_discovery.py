"""Cells, configurations, traffic mixes, limits and metrics are found by
name in their own files: adding them edits no file."""

import json
import os

from portbench.bench import Bench


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    for d in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(root, "portbench", d))
    spec = {"configs": [{"name": "room-9", "file":
                         "portbench/configs/room-9.json"}],
            "workloads": [{"name": "room-9.crowd", "config": "room-9",
                           "traffic": "crowd", "chips": 1}],
            "end_to_end": [{"name": "rate.new", "unit": "steps/s"}],
            "per_layer": [{"name": "layer.new", "unit": "ms",
                           "workloads": ["room-9.crowd"]},
                          {"name": "layer.other", "unit": "ms",
                           "workloads": ["elsewhere"]}]}
    files = {"BENCHMARK.json": spec,
             "portbench/configs/room-9.json": {"map_height": 9},
             "portbench/traffic/crowd.json": {"batch": 3},
             "portbench/limits/room-9.crowd.json": {"map_gap": 0.5}}
    for name, body in files.items():
        with open(os.path.join(root, name), "w") as f:
            json.dump(body, f)
    for name, value in (("rate.new", 7.0), ("layer.new", None)):
        with open(os.path.join(root, "portbench", "metrics",
                               f"{name}.py"), "w") as f:
            f.write(f"def read(run):\n    return {value!r}\n")
    bench = Bench(root)
    assert bench.cell("room-9.crowd")["traffic"] == "crowd"
    assert bench.config("room-9") == {"map_height": 9}
    assert bench.traffic("crowd") == {"batch": 3}
    assert bench.limits("room-9.crowd") == {"map_gap": 0.5}
    assert [m["name"] for m in bench.metrics("room-9.crowd", False)] \
        == ["rate.new"]
    assert [m["name"] for m in bench.metrics("room-9.crowd", True)] \
        == ["layer.new"]
    assert bench.reader("rate.new")(None) == 7.0
    assert bench.reader("layer.new")(None) is None


def test_the_benchmark_names_a_file_for_every_entry():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = Bench(os.path.dirname(here))
    for cell in bench.spec["workloads"]:
        bench.config(cell["config"])
        bench.traffic(cell["traffic"])
        assert bench.limits(cell["name"])
        for traced in (False, True):
            for m in bench.metrics(cell["name"], traced):
                assert callable(bench.reader(m["name"]))
    # every configuration file holds what the system reads of it, and
    # every reader under metrics/ is an entry's
    for entry in bench.spec["configs"]:
        config = bench.config(entry["name"])
        dense = config.get("dense_families") or {}
        assert set(config.get("dense_rides_with", {})) == set(dense)
        assert set(config.get("dense_rides_with", {}).values()) \
            <= set(config["families"])
        if dense:
            assert config["camera_size"] % config["backbone"]["stride"] == 0
    names = {m["name"] for kind in ("end_to_end", "per_layer")
             for m in bench.spec[kind]}
    readers = {f[:-3] for f in os.listdir(os.path.join(here, "metrics"))
               if f.endswith(".py")}
    assert readers == names
