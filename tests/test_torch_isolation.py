"""mass_tpu_torch stands alone: every module imports in a process where
``jax`` and ``mass_tpu`` cannot be imported, and so does chip_smoke.py;
its kernels build from plain CUDA sources of their own."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mass_tpu")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import mass_tpu_torch
    names = ["chip_smoke"] + [
        m.name for m in pkgutil.walk_packages(mass_tpu_torch.__path__,
                                              "mass_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    from mass_tpu_torch.core.voxelmap import VoxelMap, apply_onehot_group
    from mass_tpu_torch.ops import splat
    for entry in ("apply_records", "apply_records_multi",
                  "apply_frame_records", "sorted_records_multi",
                  "sorted_frame_records",
                  "splat_onehot_multi_reference",
                  "splat_onehot_frames_reference"):
        assert callable(getattr(splat, entry)), entry
    assert callable(VoxelMap.update_classes_frames)
    from mass_tpu_torch.nav.grid import plan_batch, stack_grids
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator
    from mass_tpu_torch.parallel.fleet import FleetMaps
    assert "mass_tpu_torch.parallel.fleet" in names
    assert "mass_tpu_torch.parallel.evaluator" in names
    for entry in (plan_batch, stack_grids, FleetEvaluator.run,
                  FleetMaps.update_batch):
        assert callable(entry), entry
    print(len(names))
""")


def test_port_imports_without_jax_or_mass_tpu():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25


def test_kernel_sources_stand_alone():
    """Every kernel the port builds has its CUDA source in the package,
    with a plain C interface (no PyTorch or JAX header, so nvcc builds it
    in seconds) and its launch and limit entry points.  The single-map,
    multi-map and frames kernels share one source and one library."""
    from mass_tpu_torch.ops import splat

    assert splat.KERNELS == ("splat_onehot", "splat_onehot_multi",
                             "splat_onehot_frames")
    assert splat.LIBRARIES == ("splat_onehot",)
    assert {lib for lib, _ in splat._ENTRIES.values()} == {"splat_onehot"}
    for gone in ("splat_onehot_multi.cu", "splat_onehot_frames.cu"):
        assert not os.path.exists(os.path.join(
            REPO, "mass_tpu_torch", "csrc", gone))
    for name in splat.LIBRARIES:
        source, library = splat._paths(name)
        with open(source) as f:
            text = f.read()
        assert "#include <torch" not in text and "ATen" not in text
        assert "mass_tpu/ops/pallas_splat.py" in text   # what it replaces
        kernels = [k for k, (lib, _) in splat._ENTRIES.items()
                   if lib == name]
        for entry in [f"{k}_launch(" for k in kernels] + [
                f"{name}_max_features("]:
            assert f'extern "C" int {entry}' in text, (name, entry)
        assert library.endswith(f"build/kernels/lib{name}.so")
    with open(splat._paths("splat_onehot")[0]) as f:
        assert 'extern "C" int splat_onehot_tile(' in f.read()
