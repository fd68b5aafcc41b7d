"""Native (C++) runtime components, loaded via ctypes.

The reference's environment layer is a native engine (the AI2-THOR
Unity runtime — SURVEY.md §1 L0 / §2.2); this package holds the
grid-world replacement's native core.  Libraries are compiled on first
use with the system g++ (no Python.h / pybind11 dependency: plain C
ABI + ctypes) and cached under ``build/native/`` at the repository
root (listed in .gitignore); every caller must keep a
pure-Python fallback, so a box without a toolchain still runs
everything (slower).

Set ``MASS_TPU_NO_NATIVE=1`` to force the fallbacks (used by the
parity tests to drive both paths).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                      "native")
_LOCK = threading.Lock()
_CACHE = {}


def _build(name: str) -> Optional[str]:
    src = os.path.join(_DIR, f"{name}.cpp")
    lib = os.path.join(_BUILD, f"_{name}.so")
    if not os.path.exists(src):
        # a stale .so without its source (e.g. after a refactor) must
        # not be loaded — and must not crash the fallback contract
        return None
    if (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)):
        return lib
    tmp = lib + f".tmp{os.getpid()}"
    os.makedirs(_BUILD, exist_ok=True)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic vs concurrent builders
        return lib
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def load(name: str) -> Optional[ctypes.CDLL]:
    """The named native library, building it if stale; None when
    disabled or the toolchain/build is unavailable."""
    if os.environ.get("MASS_TPU_NO_NATIVE"):
        return None
    with _LOCK:
        if name not in _CACHE:
            lib = _build(name)
            try:
                _CACHE[name] = ctypes.CDLL(lib) if lib else None
            except OSError:
                _CACHE[name] = None
        return _CACHE[name]
