"""Build and load the native host extensions.

Each ``<name>.cpp`` here is compiled with g++ (``-O3 -std=c++17
-fopenmp``, plain CPython C API: no pybind11) into the git-ignored
``stereo_vision_tpu_torch/_build/``, as ``_<name>-<digest>.<SOABI>.so``:
the digest covers the source, the flags and the Python headers' directory,
so an edited source is rebuilt and a stale module is never loaded (the
naming ``_build.py`` uses for the CUDA libraries). Nothing is compiled when
the package is imported: :func:`load` builds on first use. Callers fall
back to numpy / ``queue.Queue`` paths when the toolchain or the module is
unavailable (``load`` returns None).

Modules:
  host_ops   — grayscale pack, brightness scans, PNG row filters (host_ops.cpp)
  frame_ring — blocking frame-window ring buffer (frame_ring.cpp)
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_OUT = _HERE.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")
SOURCES = {name: _HERE / f"{name}.cpp" for name in ("host_ops", "frame_ring")}


def _target(name: str) -> Path:
    include = sysconfig.get_path("include")
    h = hashlib.sha1(" ".join((*_FLAGS, include)).encode())
    h.update(SOURCES[name].read_bytes())
    tag = sysconfig.get_config_var("SOABI") or "cpython"
    return _OUT / f"_{name}-{h.hexdigest()[:16]}.{tag}.so"


def build(name: str = "host_ops", force: bool = False) -> Path | None:
    """Compile the named extension unless it is built; returns the .so path,
    or None when g++ is missing or fails (its errors go to stderr)."""
    so = _target(name)
    if so.exists() and not force:
        return so
    _OUT.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, f"-I{sysconfig.get_path('include')}", str(SOURCES[name]), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.SubprocessError) as e:
        sys.stderr.write(f"{name} build failed: {e}\n")
        return None
    if r.returncode != 0:
        sys.stderr.write(f"{name} build failed:\n{r.stderr}\n")
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)  # atomic: a concurrent build never loads a half-written file
    return so


def load(name: str = "host_ops"):
    """Import the compiled module (building it if needed); None on failure."""
    so = build(name)
    if so is None:
        return None
    spec = importlib.util.spec_from_file_location(f"_{name}", so)
    if spec is None or spec.loader is None:
        return None
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ImportError as e:
        sys.stderr.write(f"{name} load failed: {e}\n")
        return None
    return mod
