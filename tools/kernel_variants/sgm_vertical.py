"""Time the exact vertical scan (csrc/sgm.cu) under other launch plans, and profile its row loop, on one GPU.

Run from the repository root:

    python3 tools/kernel_variants/sgm_vertical.py [--old PATH] [--profile]

Builds copies of ``sgm.cu`` with -D knobs on the plan (``FORCE_CS=n``: only
clusters of n blocks; ``VPL4_WARPS=n``: n warps a block at 4 values a lane) into
``tools/kernel_variants/_build/`` and times each at exact8's shape (4
frames, 720 x 1152 columns, D=128, int16; with and without diagonals; three
runs of five calls), each held to the first's output. ``--old`` adds another
``sgm.cu`` (an earlier commit's: ``git show <commit>:stereo_vision_tpu_torch/
csrc/sgm.cu``) with the vertical entry point it had (its row launches).
``--profile`` builds a copy with ``-DPROF``: lane 0 of warps 0 (an edge
column) and 2 (interior columns) of the first block add clock64 deltas by
phase of the row loop to a device array, printed as cycles a row.
Results go to ``tools/kernel_variants/_build/sgm_vertical.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from stereo_vision_tpu_torch import _build  # noqa: E402

OUT = Path(__file__).resolve().parent / "_build"
CSRC = ROOT / "stereo_vision_tpu_torch/csrc"
VARIANTS = {"plan": [], "cs16": ["FORCE_CS=16"], "cs8": ["FORCE_CS=8"], "24_warps": ["VPL4_WARPS=24"]}
PHASES = ["arrive relaxed", "columns", "syncthreads", "cluster wait"]


def knob_copy() -> Path:
    """csrc/sgm.cu with the plan knobs and the profile points."""
    s = (CSRC / "sgm.cu").read_text()
    s = s.replace('#include "common.cuh"', f'#include "{CSRC / "common.cuh"}"')
    s = s.replace('#include "wide_range.cuh"', f'#include "{CSRC / "wide_range.cuh"}"')

    def put(old, new):
        nonlocal s
        if s.count(old) != 1:
            raise SystemExit(f"sgm.cu: {old.strip()!r} is not there once; this script knows the cluster kernel")
        s = s.replace(old, new)

    put("vpl <= 4 ? 32 :", "vpl <= 4 ? VPL4_WARPS :")
    put("      if (cs > 1 && cs > W) continue;\n",
        "#ifdef FORCE_CS\n      if (cs != FORCE_CS) continue;\n#endif\n      if (cs > 1 && cs > W) continue;\n")
    put("namespace cg = cooperative_groups;\n", """namespace cg = cooperative_groups;
#ifdef PROF
__device__ unsigned long long g_prof[16];  // [role][phase], 8 phases a role at most
#define PROF_AT(k) if (profiling) { const long long t_ = clock64(); \\
  atomicAdd(&g_prof[role * 8 + (k)], (unsigned long long)(t_ - t_prev)); t_prev = t_; }
#else
#define PROF_AT(k)
#endif
""")
    put("SVT_EXPORT int svt_sgm_vertical_plan(", """#ifdef PROF
SVT_EXPORT int svt_prof(unsigned long long* out) { return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }
SVT_EXPORT int svt_prof_reset() { unsigned long long z[16] = {}; return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }
#endif
SVT_EXPORT int svt_sgm_vertical_plan(""")
    head = "  for (int i = 0; i < H; ++i) {\n    if (diag && early) cluster_arrive_relaxed();\n"
    put(head, """#ifdef PROF
  const bool profiling = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && lane == 0 && (warp == 0 || warp == 2);
  const int role = warp == 0 ? 0 : 1;
  long long t_prev = clock64();
#endif
""" + head + "    PROF_AT(0)\n")
    put("    __syncthreads();\n    if (diag) cluster_wait();\n",
        "    PROF_AT(1)\n    __syncthreads();\n    PROF_AT(2)\n    if (diag) cluster_wait();\n    PROF_AT(3)\n")
    s = "#ifndef VPL4_WARPS\n#define VPL4_WARPS 32\n#endif\n" + s
    OUT.mkdir(exist_ok=True)
    copy = OUT / "sgm_knobs.cu"
    copy.write_text(s)
    return copy


def build(jobs: dict[str, tuple[Path, list[str]]]) -> dict[str, ctypes.CDLL]:
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen([nvcc, *_build._FLAGS, *[f"-D{f}" for f in flags], "-o",
                                     str(OUT / f"sgm_{name}.so"), str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True) for name, (src, flags) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"sgm_{name}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="an earlier sgm.cu with the row-launch vertical entry point")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sgm_vertical: no CUDA device", file=sys.stderr)
        return 1
    copy = knob_copy()
    jobs = {name: (copy, flags) for name, flags in VARIANTS.items()}
    if args.profile:
        jobs["profile"] = (copy, ["PROF"])
    if args.old:
        old = OUT / "sgm_old.cu"
        old.write_text(args.old.read_text().replace('#include "common.cuh"', f'#include "{CSRC / "common.cuh"}"')
                       .replace('#include "wide_range.cuh"', f'#include "{CSRC / "wide_range.cuh"}"'))
        jobs["old"] = (old, [])
    libs = build(jobs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    B, H, W, D = 4, 720, 1152, 128
    C = torch.from_numpy(np.random.default_rng(0).integers(0, 2326, (B, H, W, D)).astype(np.int16)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    calls, want, res = {}, {}, {"card": card}
    for name, lib in libs.items():
        dn, up = torch.empty_like(C), torch.empty_like(C)
        if name == "old":
            lib.svt_sgm_vertical.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            lbuf = torch.empty((2, 6, B, W, D), dtype=C.dtype, device=dev)
            mbuf = torch.empty((2, 6, B, W), dtype=torch.int32, device=dev)
            calls[name] = (lambda lib, dn, up, lbuf, mbuf: lambda diag: lib.svt_sgm_vertical(
                C.data_ptr(), dn.data_ptr(), up.data_ptr(), lbuf.data_ptr(), mbuf.data_ptr(), B, H, W, D, 200, 800,
                diag, 2, stream))(lib, dn, up, lbuf, mbuf)
        else:
            lib.svt_sgm_vertical.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
            lib.svt_sgm_vertical_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
            plan = (ctypes.c_longlong * 8)()
            if lib.svt_sgm_vertical_plan(B, H, W, D, 2, plan):
                print(name, "refused by the plan")
                continue
            scratch = torch.empty(max(plan[6], 1), dtype=torch.uint8, device=dev)
            res[f"{name} plan"] = list(plan)
            print(name, "plan (cluster, columns, warps, carries in smem, clusters at once, smem, scratch, launches):",
                  list(plan), flush=True)
            calls[name] = (lambda lib, plan, dn, up, scratch: lambda diag: lib.svt_sgm_vertical(
                C.data_ptr(), dn.data_ptr(), up.data_ptr(), scratch.data_ptr(), B, H, W, D, 200, 800, diag, 2, plan,
                stream))(lib, plan, dn, up, scratch)
        for diag in (1, 0):
            if calls[name](diag) != 0:
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            got = (dn.clone(), up.clone())
            want.setdefault(diag, got)
            if not all(torch.equal(a, b) for a, b in zip(got, want[diag])):
                raise SystemExit(f"{name} (diagonals {diag}) differs from the first variant's output")
    for name, call in calls.items():
        for diag in (1, 0):
            runs = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    call(diag)
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end) / 5)
            res[f"{name} diagonals {diag}"] = runs
            print(name, "with diagonals" if diag else "without", [round(r, 4) for r in runs], flush=True)
    if args.profile:
        lib = libs["profile"]
        lib.svt_prof.argtypes = [ctypes.c_void_p]
        for diag in (1, 0):
            lib.svt_prof_reset()
            calls["profile"](diag)
            torch.cuda.synchronize()
            prof = (ctypes.c_ulonglong * 16)()
            lib.svt_prof(prof)
            for role, who in ((0, "edge warp 0"), (1, "interior warp 2")):
                row = {p: round(prof[role * 8 + k] / H) for k, p in enumerate(PHASES)}
                res[f"profile diagonals {diag} {who}"] = row
                print(f"cycles a row, diagonals {diag}, {who}:", row, flush=True)
    (OUT / "sgm_vertical.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
