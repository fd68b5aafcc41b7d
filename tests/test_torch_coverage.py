"""The port has every public name of the JAX package: each public
top-level function or class of ``mass_tpu/**/*.py`` has a same-named
counterpart bound at the top level of the port's module at the same path
(a definition, an assignment or an import), or a row in ``REPLACED``
that names the port's replacement or gives the reason there is none.
Read with ``ast``: neither package is imported."""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "mass_tpu")
PORT_PKG = os.path.join(REPO, "mass_tpu_torch")

_XLA = ("the XLA path: the records are sorted by ops/splat.sorted_*records "
        "and splatted by the hand-written kernels, beside their plain "
        "versions")
_PTH = "the port loads PyTorch .pth state dicts directly"

# JAX "module:name" -> (the port's replacement as "path:name", or None;
# why).  A .py path names a top-level binding, a .cu path an extern "C"
# entry.
REPLACED = {
    "core/voxelmap.py:resolved_layout": (
        None, "the port's MapGeometry has no layout field: maps are "
        "voxel-major [V, F] (ROADMAP.md queue 3)"),
    "ops/pallas_splat.py:splat_onehot_cmajor": (
        "csrc/splat_onehot.cu:splat_onehot_launch",
        "ops/splat.apply_records launches it"),
    "ops/pallas_splat.py:splat_onehot_multi_cmajor": (
        "csrc/splat_onehot.cu:splat_onehot_multi_launch",
        "ops/splat.apply_records_multi launches it"),
    "ops/pallas_splat.py:splat_onehot_frames_cmajor": (
        "csrc/splat_onehot.cu:splat_onehot_frames_launch",
        "ops/splat.apply_frame_records launches it"),
    "ops/scatter.py:apply_dense_rows": (
        "ops/splat.py:apply_dense_records", _XLA),
    "ops/scatter.py:apply_onehot_cmajor": (
        "ops/splat.py:apply_records", _XLA),
    "ops/scatter.py:apply_onehot_vmajor": (
        "ops/splat.py:apply_records", _XLA),
    "ops/scatter.py:segment_totals": (
        "ops/splat.py:splat_onehot_reference", _XLA),
    "ops/scatter.py:span_sorted_records": (
        "ops/splat.py:sorted_records", _XLA),
    "perception/maskrcnn.py:export_detectron2_state_dict": (
        "convert.py:maskrcnn_state_dict_from_jax",
        "the JAX parameters' export lives with the port's converters"),
    "perception/maskrcnn.py:params_from_detectron2": (
        "perception/maskrcnn.py:load_detector", _PTH),
    "perception/maskrcnn.py:params_from_torchvision_maskrcnn": (
        "perception/maskrcnn.py:state_dict_from_torchvision", _PTH),
    "perception/maskrcnn.py:init_maskrcnn": (
        "perception/maskrcnn.py:MaskRCNN", _PTH),
    "perception/resnet.py:init_backbone": (
        "perception/resnet.py:ResNet50Stage1", _PTH),
    "perception/resnet.py:load_pretrained_backbone": (
        "perception/resnet.py:load_backbone_checkpoint", _PTH),
    "perception/resnet.py:params_from_torchvision": (
        "perception/resnet.py:from_state_dict", _PTH),
    "perception/resnet.py:save_backbone_checkpoint": (
        "utils/checkpoint.py:save_state_dict", _PTH),
    "search/policy.py:init_params": (
        "search/policy.py:init_policy", _PTH),
    "search/policy.py:params_from_torch_state_dict": (
        "search/policy.py:from_state_dict", _PTH),
    "utils/checkpoint.py:load_pytree": (
        "utils/checkpoint.py:load_state_dict", "orbax, replaced by .pth"),
    "utils/checkpoint.py:save_pytree": (
        "utils/checkpoint.py:save_state_dict", "orbax, replaced by .pth"),
}


def _source(path):
    with open(path) as f:
        return f.read()


def _public_defs(path):
    """Public top-level functions and classes of a module."""
    return {node.name for node in ast.parse(_source(path)).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")}


def _bound(path):
    """Every name bound at a module's top level, under ``if``/``try``
    too: definitions, assignments and imports."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names.update(n.id for t in targets for n in ast.walk(t)
                             if isinstance(n, ast.Name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for handler in node.handlers:
                    visit(handler.body)
                visit(node.orelse)
                visit(node.finalbody)
    visit(ast.parse(_source(path)).body)
    return names


def _jax_names():
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                rel = os.path.relpath(path, JAX_PKG).replace(os.sep, "/")
                out.extend(f"{rel}:{n}" for n in sorted(_public_defs(path)))
    return sorted(out)


def _port_has(rel: str, name: str) -> bool:
    path = os.path.join(PORT_PKG, rel)
    if not os.path.exists(path):
        return False
    if rel.endswith(".cu"):
        return re.search(rf'extern "C" \w+ {re.escape(name)}\(',
                         _source(path)) is not None
    return name in _bound(path)


def test_every_jax_name_has_a_port_counterpart_or_a_row():
    names = _jax_names()
    assert len(names) > 200           # the walk found the package
    missing = [key for key in names if key not in REPLACED
               and not _port_has(*key.split(":"))]
    assert not missing, missing


def test_rows_name_only_jax_names_the_port_lacks():
    names = set(_jax_names())
    stale = [key for key in REPLACED
             if key not in names or _port_has(*key.split(":"))]
    assert not stale, stale


@pytest.mark.parametrize("key", sorted(REPLACED))
def test_row_names_an_existing_replacement(key):
    replacement, reason = REPLACED[key]
    assert reason
    if replacement is not None:
        assert _port_has(*replacement.split(":")), replacement


def test_profiling_needs_no_row():
    assert "utils/profiling.py:trace" in _jax_names()
    for name in ("trace", "block", "StageTimer"):
        assert _port_has("utils/profiling.py", name)
        assert f"utils/profiling.py:{name}" not in REPLACED
