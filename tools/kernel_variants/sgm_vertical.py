"""Time the exact vertical scan (csrc/sgm.cu) under other launch plans, and profile its row loops, on one GPU.

Run from the repository root:

    python3 tools/kernel_variants/sgm_vertical.py [--old PATH] [--profile] [--frames 4 8] [--split 6x16x12 ...]

Builds copies of ``sgm.cu`` into ``tools/kernel_variants/_build/`` and times,
at ``--frames`` frames of exact8's shape (720 x 1152 columns, D=128, int16;
default 4 and 8), three runs of five calls each of:

- the register form (the packed int16 scan with diagonals) under the plan
  ``sgm_cuda.register_plan`` gives with this card's answers, and under each
  ``--split`` (clusters x warps x columns a warp);
- the cluster kernel (carry rows in shared memory or scratch; with and
  without diagonals) under its C plan and under copies with -D knobs on it
  (``FORCE_CS=n``: only clusters of n blocks; ``VPL4_WARPS=n``: n warps a
  block at 4 values a lane);
- with ``--old``, another ``sgm.cu`` (an earlier commit's: ``git show
  <commit>:stereo_vision_tpu_torch/csrc/sgm.cu``) with the vertical entry
  point it had: the plan entry (since PR 10) or the row launches (before).

Every output is held to the first variant's. ``--profile`` builds a copy
with ``-DPROF``: lane 0 of two warps of the first block adds clock64 deltas
by phase of the row loop to a device array, printed as cycles a row: in the
cluster kernel warps 0 (an edge column) and 2 (interior columns); in the
register form warps 0 (no left neighbour) and 1 (both neighbours), phases
the neighbours' edges (their mbarrier waits and reads), the two edge
columns and their st.async, the interior columns. Results go to
``tools/kernel_variants/_build/sgm_vertical.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from stereo_vision_tpu_torch import _build  # noqa: E402
from stereo_vision_tpu_torch.stereo import sgm_cuda  # noqa: E402

OUT = Path(__file__).resolve().parent / "_build"
CSRC = ROOT / "stereo_vision_tpu_torch/csrc"
VARIANTS = {"plan": [], "cs16": ["FORCE_CS=16"], "cs8": ["FORCE_CS=8"], "24_warps": ["VPL4_WARPS=24"]}
PHASES = {"cluster": ["arrive relaxed", "columns", "syncthreads", "cluster wait"],
          "registers": ["neighbours' edges", "edge columns + st.async", "interior columns"]}
H, W, D, P1, P2 = 720, 1152, 128, 200, 800


def knob_copy() -> Path:
    """csrc/sgm.cu with the plan knobs and the profile points."""
    s = (CSRC / "sgm.cu").read_text()
    s = s.replace('#include "common.cuh"', f'#include "{CSRC / "common.cuh"}"')
    s = s.replace('#include "wide_range.cuh"', f'#include "{CSRC / "wide_range.cuh"}"')

    def put(old, new):
        nonlocal s
        if s.count(old) != 1:
            raise SystemExit(f"sgm.cu: {old.strip()!r} is not there once; this script knows its vertical kernels")
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
    # The cluster kernel's row loop.
    head = "  for (int i = 0; i < H; ++i) {\n    if (diag && early) cluster_arrive_relaxed();\n"
    put(head, """#ifdef PROF
  const bool profiling = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && lane == 0 && (warp == 0 || warp == 2);
  const int role = warp == 0 ? 0 : 1;
  long long t_prev = clock64();
#endif
""" + head + "    PROF_AT(0)\n")
    put("    __syncthreads();\n    if (diag) cluster_wait();\n",
        "    PROF_AT(1)\n    __syncthreads();\n    PROF_AT(2)\n    if (diag) cluster_wait();\n    PROF_AT(3)\n")
    # The register form's row: after the neighbours' edges, after the edge columns, after the interior.
    put("  auto row = [&](int i, auto tail) {\n", """#ifdef PROF
  const bool profiling = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && lane == 0 && warp < 2;
  const int role = warp;
  long long t_prev = clock64();
#endif
  auto row = [&](int i, auto tail) {
""")
    put("    const bool more = i + 1 < H;\n", "    PROF_AT(0)\n    const bool more = i + 1 < H;\n")
    put("#pragma unroll\n    for (int j = 1; j < CPW - 1; ++j) {\n",
        "    PROF_AT(1)\n#pragma unroll\n    for (int j = 1; j < CPW - 1; ++j) {\n")
    put("    cp += step;\n    sp += step;\n  };\n", "    PROF_AT(2)\n    cp += step;\n    sp += step;\n  };\n")
    s = "#ifndef VPL4_WARPS\n#define VPL4_WARPS 32\n#endif\n" + s
    OUT.mkdir(exist_ok=True)
    copy = OUT / "sgm_knobs.cu"
    copy.write_text(s)
    return copy


def build(jobs: dict[str, tuple[Path, list[str]]]) -> dict[str, ctypes.CDLL]:
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen([nvcc, *_build._FLAGS, *[f"-D{f}" for f in flags], "-I", str(CSRC), "-o",
                                     str(OUT / f"sgm_{name}.so"), str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True) for name, (src, flags) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(str(OUT / f"sgm_{name}.so"))
        if hasattr(lib, "svt_sgm_vertical_plan"):
            lib.svt_sgm_vertical.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
            lib.svt_sgm_vertical_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        else:  # the row launches' entry
            lib.svt_sgm_vertical.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        if hasattr(lib, "svt_sgm_vertical_registers"):
            lib.svt_sgm_vertical_registers.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def register_plan(lib: ctypes.CDLL, B: int) -> dict:
    """sgm_cuda.register_plan with this card's answers, as the library ``lib`` gives them."""
    return sgm_cuda.register_plan(
        B, W, D, active_clusters=lambda cs, nw, cpw: max(0, lib.svt_sgm_vertical_registers_clusters(D, cpw, nw, cs)),
        max_warps=lambda cpw: lib.svt_sgm_vertical_registers_warps(D, cpw))


def calls_for(name: str, lib: ctypes.CDLL, C: torch.Tensor, splits: list[tuple[int, int, int]],
              res: dict) -> tuple[dict, tuple[torch.Tensor, torch.Tensor]]:
    """Each way ``lib`` can run the vertical scan on C (name -> fn(diag) returning the CUDA error, or None
    where the way has no such form), and the two volumes they write."""
    B = C.shape[0]
    dev, stream = C.device, torch.cuda.current_stream().cuda_stream
    dn, up = torch.empty_like(C), torch.empty_like(C)
    out = {}
    if not hasattr(lib, "svt_sgm_vertical_plan"):
        lbuf = torch.empty((2, 6, B, W, D), dtype=C.dtype, device=dev)
        mbuf = torch.empty((2, 6, B, W), dtype=torch.int32, device=dev)
        out[name] = lambda diag: lib.svt_sgm_vertical(C.data_ptr(), dn.data_ptr(), up.data_ptr(), lbuf.data_ptr(),
                                                      mbuf.data_ptr(), B, H, W, D, P1, P2, diag, 2, stream)
        return out, (dn, up)
    plan = (ctypes.c_longlong * 8)()
    if lib.svt_sgm_vertical_plan(B, H, W, D, 2, plan) == 0:
        scratch = torch.empty(max(plan[6], 1), dtype=torch.uint8, device=dev)
        res[f"{name} B={B} cluster plan"] = list(plan)
        out[f"{name} cluster"] = lambda diag: lib.svt_sgm_vertical(C.data_ptr(), dn.data_ptr(), up.data_ptr(),
                                                                   scratch.data_ptr(), B, H, W, D, P1, P2, diag, 2,
                                                                   plan, stream)
    if hasattr(lib, "svt_sgm_vertical_registers"):
        p = register_plan(lib, B)
        ways = [(p["cluster"], p["warps"], p["cols_per_warp"], "plan")] if p else []
        ways += [(cs, nw, cpw, f"{cs}x{nw}x{cpw}") for cs, nw, cpw in splits]
        res[f"{name} B={B} register plan"] = p
        for cs, nw, cpw, label in ways:
            out[f"{name} registers {label}"] = (
                lambda cs, nw, cpw: lambda diag: lib.svt_sgm_vertical_registers(
                    C.data_ptr(), dn.data_ptr(), up.data_ptr(), B, H, W, D, P1, P2, cs, nw, cpw, stream)
                if diag else None)(cs, nw, cpw)
    return out, (dn, up)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="an earlier sgm.cu, with the vertical entry point it had")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--frames", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--split", nargs="*", default=[], help="register-form splits, CLUSTERxWARPSxCOLUMNS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sgm_vertical: no CUDA device", file=sys.stderr)
        return 1
    splits = [tuple(int(v) for v in s.split("x")) for s in args.split]
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
    res = {"card": card}
    for B in args.frames:
        gen = torch.Generator(device=dev).manual_seed(B)
        C = torch.randint(0, 2326, (B, H, W, D), generator=gen, dtype=torch.int16, device=dev)
        calls, want = {}, {}
        for name, lib in libs.items():
            if name == "profile":
                continue
            ways, (dn, up) = calls_for(name, lib, C, splits if name == "plan" else [], res)
            for way, call in ways.items():
                for diag in (1, 0):
                    if call(diag) is None:  # the register form has diagonals only
                        continue
                    torch.cuda.synchronize()
                    got = (dn.clone(), up.clone())
                    want.setdefault(diag, got)
                    if not all(torch.equal(a, b) for a, b in zip(got, want[diag])):
                        raise SystemExit(f"{way} (diagonals {diag}, {B} frames) differs from the first variant's output")
                    del got
                calls[way] = call
        for way, call in calls.items():
            for diag in (1, 0):
                if call(diag) is None:
                    continue
                runs = []
                for _ in range(3):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(5):
                        call(diag)
                    end.record()
                    torch.cuda.synchronize()
                    runs.append(start.elapsed_time(end) / 5)
                res[f"{way} B={B} diagonals {diag}"] = runs
                print(f"{way}, {B} frames,", "with diagonals" if diag else "without", [round(r, 4) for r in runs],
                      flush=True)
        if args.profile:
            lib = libs["profile"]
            lib.svt_prof.argtypes = [ctypes.c_void_p]
            ways, _ = calls_for("profile", lib, C, [], {})
            for way, call in ways.items():
                kind = "registers" if "registers" in way else "cluster"
                lib.svt_prof_reset()
                call(1)
                torch.cuda.synchronize()
                prof = (ctypes.c_ulonglong * 16)()
                lib.svt_prof(prof)
                for role in (0, 1):
                    row = {p: round(prof[role * 8 + k] / H) for k, p in enumerate(PHASES[kind])}
                    res[f"profile {way} B={B} role {role}"] = row
                    print(f"cycles a row, {way}, {B} frames, warp role {role}:", row, flush=True)
        del C
        torch.cuda.empty_cache()
    (OUT / "sgm_vertical.json").write_text(json.dumps(res, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
