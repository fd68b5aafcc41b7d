"""What a benchmark run loads: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference nothing of the port."""

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from portbench import run
from portbench.tests.tiny import BENCH, ROOT, tiny_root


@pytest.mark.parametrize("name, flagged", [
    ("mass_tpu", True), ("mass_tpu.agent", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("mass_tpu_torch", False), ("mass_tpu_torch.nav", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_forbidden_names_compare_whole_top_level_names(monkeypatch, name,
                                                       flagged):
    for m in list(sys.modules):
        if m.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in run.forbidden_modules()) == flagged


def _top_level_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_the_port_and_neither_jax_nor_the_jax_package(tmp_path):
    root = tiny_root(str(tmp_path))
    names = _top_level_after(
        "import torch; torch.set_num_threads(2)\n"
        "from portbench.bench import Bench\n"
        "from portbench.run import run_cell\n"
        f"run_cell(Bench({root!r}), 'semantic-384.fleet8', 5, 0.3, True, "
        "'cpu')")
    assert "mass_tpu_torch" in names
    assert not names & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level_after(
        "import portbench.check, portbench.control, portbench.bench\n"
        "import portbench.traffic.generator\n"
        "from portbench.reference import maskrcnn, planner, resnet, "
        "roofline, spans, trace, voxel")
    assert not names & {"mass_tpu_torch", *run.FORBIDDEN}


def test_no_reference_source_names_the_port():
    folder = os.path.join(BENCH, "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in {"mass_tpu_torch",
                                                 *run.FORBIDDEN}, name
