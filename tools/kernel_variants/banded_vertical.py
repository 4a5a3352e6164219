"""Time the banded vertical scan (#17) under other launch plans, on one GPU.

Run from the repository root:

    python3 tools/kernel_variants/banded_vertical.py [--old DIR] [--knobs]

At each main-path shape (hier4x3's full, mid and coarse levels at 32
frames, hier16x3's full and coarse levels at 8 frames, without diagonals;
hier4x8's full level with them; int16 costs below the bench parameters'
bound, shift maps constant on 4x4 tiles) it times the plan's launch
(``banded_cuda.vertical_plan``), then the ring form at every block size and
ring depth whose shared memory fits, or the cluster form at every cluster
size and ring depth the card holds (``svt_banded_diag_clusters``), each held
to the plan's output: three runs of five calls, CUDA events. ``--old DIR``
adds the two kernels of another ``csrc`` directory (an earlier commit's,
from ``git archive <commit> stereo_vision_tpu_torch/csrc``), built with nvcc
into ``tools/kernel_variants/_build/`` and called through the entry points
they had (no plan). ``--knobs`` adds copies of the current sources with one
part taken out, built the same way, at the plan's launch (their outputs are
wrong by design; only their times count): ``no_store`` (no output stores),
``no_step`` (the ring form adds its costs in place of the SGM step),
``one_column`` (the ring form at one column a thread at every band),
``relaxed`` (the 8-path form's cluster arrivals relaxed, not release),
``no_exchange`` (the 8-path form's blocks never exchange their halos),
``profile`` (the 8-path form with clock64 deltas by phase of the row loop of
lane 0 of warp 1 of the first block, printed as cycles a row); and the time of ``torch``'s copy of the cost volume into two
volumes (the same bytes as the scan, as a measure of what the card streams).
Results go to ``tools/kernel_variants/_build/banded_vertical.json``.
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
from stereo_vision_tpu_torch.stereo import banded_cuda  # noqa: E402

OUT = Path(__file__).resolve().parent / "_build"
# label -> frames, rows, columns, band, G, with diagonals (the main paths' levels)
SHAPES = {"hier4x3 full": (32, 720, 1152, 4, 2, False), "hier4x3 mid": (32, 360, 576, 8, 4, False),
          "hier4x3 coarse": (32, 180, 288, 32, 2, False), "hier16x3 full": (8, 720, 1152, 16, 8, False),
          "hier16x3 coarse": (8, 180, 288, 32, 8, False), "hier4x8 full": (32, 720, 1152, 4, 2, True)}
P1, P2, BOUND = 200, 800, 2325  # the bench's p3 at block 5: cost_bound 2325
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def event_runs(fn, runs: int = 3, reps: int = 5) -> list[float]:
    fn()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return out


def old_libs(src: Path) -> dict[str, ctypes.CDLL]:
    """The earlier sources' vertical and 8-path libraries, with their entry points."""
    OUT.mkdir(exist_ok=True)
    libs = {}
    for name in ("banded", "banded_diag"):
        so = OUT / f"libold_{name}.so"
        cmd = [_build._nvcc(), *_build._FLAGS, "-o", str(so), str(src / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {src / name}.cu:\n{proc.stdout}{proc.stderr}")
        libs[name] = ctypes.CDLL(str(so))
    libs["banded"].svt_banded_vertical.argtypes = [_P] * 4 + [_I] * 8 + [_P]
    libs["banded_diag"].svt_banded_vertical_diag.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    libs["banded_diag"].svt_banded_vertical_diag_scratch_bytes.argtypes = [_I] * 4
    libs["banded_diag"].svt_banded_vertical_diag_scratch_bytes.restype = _LL
    return libs


# Knob copies: file -> (text, replacement) pairs that take one part out.
KNOBS = {
    "no_store": {"banded.cu": [("*reinterpret_cast<int4*>(o) = wv;", "if (H < 0) *reinterpret_cast<int4*>(o) = wv;"),
                               ("svt::store_lanes<T, KP>(o, K, L[0]);\n    }\n", "if (H < 0) svt::store_lanes<T, KP>(o, K, L[0]);\n    }\n")],
                 "banded_diag.cuh": [("svt::store_lanes<T, KP>(Ob + (size_t)row_of(t) * plane, K, sum);",
                                      "if (H < 0) svt::store_lanes<T, KP>(Ob + (size_t)row_of(t) * plane, K, sum);")]},
    "relaxed": {"banded_diag.cuh": [('asm volatile("barrier.cluster.arrive.release;\\n"',
                                     'asm volatile("barrier.cluster.arrive.relaxed;\\n"')]},
    "no_step": {"banded.cu": [("svt::banded_step<KP>(c, L[j], t == 0 ? 0 : sv - sprev[j], K, a.G, a.P1, a.P2);",
                               "for (int k = 0; k < KP; ++k) L[j][k] += c[k] + sv;")]},
    "one_column": {"banded.cu": [("return KP * (int)sizeof(T) == 8 ? 2 : 1;", "return 1;")]},
    "profile": {"banded_diag.cuh": [
        ("  int Lv[KP], Ld[KP], Lu[KP];\n", "  int Lv[KP], Ld[KP], Lu[KP];\n#ifdef PROF\n  const bool profiling = blockIdx.x == 0 && "
         "blockIdx.y == 0 && blockIdx.z == 0 && lane == 0 && warp == 1;\n  long long t_prev = clock64();\n#endif\n"),
        ("    const int sy = take(t, c);\n", "    const int sy = take(t, c);\n    PROF_AT(0)\n"),
        ("    svt::banded_step<KP>(c, Lv, sy - sprev, K, G, P1, P2);\n",
         "    svt::banded_step<KP>(c, Lv, sy - sprev, K, G, P1, P2);\n    PROF_AT(1)\n"),
        ("    int spL = __shfl_up_sync(svt::kFullMask, sprev, 1), spR = __shfl_down_sync(svt::kFullMask, sprev, 1);\n",
         "    int spL = __shfl_up_sync(svt::kFullMask, sprev, 1), spR = __shfl_down_sync(svt::kFullMask, sprev, 1);\n"
         "    PROF_AT(2)\n"),
        ("    if (x > 0 && tid > 0) {\n", "    PROF_AT(3)\n    if (x > 0 && tid > 0) {\n"),
        ("    sprev = sy;\n", "    PROF_AT(4)\n    sprev = sy;\n"),
        ("    if (own) {\n", "    PROF_AT(5)\n    if (own) {\n"),
        ("    issue(t + S);  // into the slot read last", "    PROF_AT(6)\n    issue(t + S);  // into the slot read last"),
        ("    __syncthreads();  // the row's edge entries are written before the next row reads them\n",
         "    PROF_AT(7)\n    __syncthreads();  // the row's edge entries are written before the next row reads them\n"
         "    PROF_AT(8)\n"),
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n__device__ unsigned long long g_prof[16];\n"
         "#define PROF_AT(k) if (profiling) { const long long t_ = clock64(); "
         "atomicAdd(&g_prof[(k)], (unsigned long long)(t_ - t_prev)); t_prev = t_; }\n"),
        ("SVT_EXPORT int svt_banded_vertical_diag(",
         "SVT_EXPORT int svt_prof(unsigned long long* out) { return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }\n"
         "SVT_EXPORT int svt_banded_vertical_diag("),
    ]},
    "no_exchange": {"banded_diag.cuh": [("if (h > 0 && t > 0 && t % h == 0 && t + 1 < H) {", "if (H < 0) {")]},
}


def knob_libs() -> dict[str, dict[str, ctypes.CDLL]]:
    """The current banded.cu and banded_diag.cu with each knob applied, one
    nvcc a copy, all started together."""
    src = ROOT / "stereo_vision_tpu_torch/csrc"
    jobs = []
    for name, edits in KNOBS.items():
        dst = OUT / f"knob_{name}"
        dst.mkdir(parents=True, exist_ok=True)
        for p in src.iterdir():
            text = p.read_text()
            for old, new in edits.get(p.name, []):
                if text.count(old) != 1:
                    raise SystemExit(f"{p.name}: {old!r} is not there once; this script knows the current kernels")
                text = text.replace(old, new)
            (dst / p.name).write_text(text)
        flags = ["-DPROF"] if name == "profile" else []
        for lib in ("banded", "banded_diag"):
            so = OUT / f"libknob_{name}_{lib}.so"
            cmd = [_build._nvcc(), *_build._FLAGS, *flags, "-o", str(so), str(dst / f"{lib}.cu")]
            jobs.append((name, lib, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                         text=True)))
    libs: dict[str, dict[str, ctypes.CDLL]] = {}
    for name, lib, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} copy of {lib}.cu:\n{out}")
        libs.setdefault(name, {})[lib] = ctypes.CDLL(str(so))
    for k in libs.values():
        k["banded"].svt_banded_vertical.argtypes = [_P] * 4 + [_I] * 11 + [_P]
        k["banded_diag"].svt_banded_vertical_diag.argtypes = [_P] * 5 + [_I] * 11 + [_P]
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="an earlier csrc directory")
    ap.add_argument("--knobs", action="store_true", help="time copies with one part taken out")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _build.build(["banded", "banded_diag"])
    old = old_libs(args.old) if args.old else None
    knobs = knob_libs() if args.knobs else {}
    dev = torch.device("cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    results = {"card": card, "shapes": {}}
    for label, (P, H, Wv, K, G, diag) in SHAPES.items():
        rng = np.random.default_rng(1)
        C = torch.randint(0, BOUND + 1, (P, H, Wv, K), dtype=torch.int16, device=dev)
        tiles = rng.integers(0, 20, (P, -(-H // 4), -(-Wv // 4))) * G
        s = torch.from_numpy(np.repeat(np.repeat(tiles, 4, 1), 4, 2)[:, :H, :Wv].astype(np.int32)).to(dev)
        s = s.contiguous()
        plan_fn = lambda: banded_cuda.banded_vertical(C, s, G, P1, P2, cost_bound=BOUND, with_diagonals=diag)
        ref = plan_fn()
        plan = dict(banded_cuda.banded_vertical.plan)
        nbytes = 3 * C.numel() * 2 + s.numel() * 4
        row = {"bound_ms": nbytes / 3.35e12 * 1e3, "plan": plan, "plan_ms": event_runs(plan_fn), "variants": {}}
        print(label, "plan", json.dumps(plan), row["plan_ms"], flush=True)
        dn, up = torch.empty_like(C), torch.empty_like(C)

        def check(tag):
            torch.cuda.synchronize()
            if not (torch.equal(dn, ref[0]) and torch.equal(up, ref[1])):
                raise SystemExit(f"{label} {tag}: differs from the plan's output")

        ptrs = (C.data_ptr(), s.data_ptr(), dn.data_ptr(), up.data_ptr())
        if not diag:
            lib = banded_cuda._lib()
            for NT in banded_cuda.RING_THREADS:
                for S in banded_cuda.RING_DEPTHS:
                    fn = lambda: lib.svt_banded_vertical(*ptrs, P, H, Wv, K, G, P1, P2, 2, 0, NT, S, st())
                    if fn() != 0:
                        continue  # its shared memory does not fit
                    check(f"NT={NT} S={S}")
                    row["variants"][f"NT={NT} S={S}"] = event_runs(fn)
            if K >= 16:
                fn = lambda: lib.svt_banded_vertical(*ptrs, P, H, Wv, K, G, P1, P2, 2, 1, 0, 0, st())
                if fn() == 0:
                    check("group")
                    row["variants"]["group form"] = event_runs(fn)
        else:
            lib = banded_cuda._diag_lib(C)
            for CS in banded_cuda.CLUSTER_SIZES:
                NT = (-(-Wv // CS) + 31) // 32 * 32 + (2 * banded_cuda.DIAG_HALO if CS > 1 else 0)
                for S in banded_cuda.RING_DEPTHS:
                    active = lib.svt_banded_diag_clusters(K, CS, NT, S)
                    if active < 1:
                        continue
                    fn = lambda: lib.svt_banded_vertical_diag(*ptrs, None, P, H, Wv, K, G, P1, P2, 0, CS, NT, S, st())
                    if fn() != 0:
                        continue
                    check(f"CS={CS} S={S}")
                    row["variants"][f"CS={CS} NT={NT} S={S} (resident {active})"] = event_runs(fn)
        for name, libs in knobs.items():
            if not diag:
                fn = lambda: libs["banded"].svt_banded_vertical(*ptrs, P, H, Wv, K, G, P1, P2, 2, 0, plan["threads"],
                                                                plan["ring"], st())
            else:
                fn = lambda: libs["banded_diag"].svt_banded_vertical_diag(
                    *ptrs, None, P, H, Wv, K, G, P1, P2, 0, plan["cluster"], plan["threads"], plan["ring"], st())
            if fn() == 0:
                row["variants"][f"knob {name}"] = event_runs(fn)
            if name == "profile" and diag:
                prof = (ctypes.c_ulonglong * 16)()
                torch.cuda.synchronize()
                libs["banded_diag"].svt_prof(prof)
                calls = 1 + 3 * 5 + 1  # the check, the warm-up and the timed runs
                row["profile_cycles_a_row"] = [round(v / calls / H, 1) for v in list(prof)[:9]]
                print("  profile (cycles a row: take, vertical, shuffles, edges, diagonals, exchange+entries, "
                      "sums, issue, barrier):", row["profile_cycles_a_row"], flush=True)
        if knobs:
            row["variants"]["torch copy into two volumes"] = event_runs(lambda: (dn.copy_(C), up.copy_(C)))
        if old is not None:
            if not diag:
                fn = lambda: old["banded"].svt_banded_vertical(*ptrs, P, H, Wv, K, G, P1, P2, 2, st())
            else:
                nb = old["banded_diag"].svt_banded_vertical_diag_scratch_bytes(P, Wv, K, 0)
                scratch = torch.empty(max(nb, 1), dtype=torch.uint8, device=dev)
                sp = scratch.data_ptr() if nb > 0 else None
                fn = lambda: old["banded_diag"].svt_banded_vertical_diag(*ptrs, sp, P, H, Wv, K, G, P1, P2, st())
            if fn() != 0:
                raise SystemExit(f"{label}: the earlier kernel refused the call")
            check("old")
            row["old_ms"] = event_runs(fn)
        for k, v in row["variants"].items():
            print(f"  {k}: {[round(x, 4) for x in v]}", flush=True)
        if "old_ms" in row:
            print(f"  old: {[round(x, 4) for x in row['old_ms']]}", flush=True)
        results["shapes"][label] = row
        del C, s, ref, dn, up
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "banded_vertical.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
