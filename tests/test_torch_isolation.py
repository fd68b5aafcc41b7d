"""mass_tpu_torch stands alone: every module imports in a process where
``jax`` and ``mass_tpu`` cannot be imported, and so does chip_smoke.py."""

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
    print(len(names))
""")


def test_port_imports_without_jax_or_mass_tpu():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25
