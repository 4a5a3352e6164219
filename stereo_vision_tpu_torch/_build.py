"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``_build/lib<name>-<digest>.so``; the digest covers the source,
the shared headers and the flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built when the package is
imported: a wrapper builds its library on its first launch, and
:func:`build` compiles every source at once (one nvcc process per source,
all started together), as ``chip_smoke.py`` does before it times anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_OUT = Path(__file__).resolve().parent / "_build"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    for p in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return _OUT / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet.

    Returns each compiled source's nvcc output (ptxas register and
    shared-memory report). Raises RuntimeError with the compiler output
    if any source fails.
    """
    names = sources() if names is None else names
    _OUT.mkdir(exist_ok=True)
    jobs = []
    for name in names:
        tgt = _target(name)
        if tgt.exists():
            continue
        tmp = tgt.with_name(f"{tgt.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, tgt, tmp, proc))
    reports, failed = {}, []
    for name, tgt, tmp, proc in jobs:
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, tgt)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.svt_error_string.argtypes = [ctypes.c_int]
        lib.svt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.svt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
