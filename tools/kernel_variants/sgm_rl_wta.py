"""Time the fused R->L scan + WTA (#5) beside earlier forms of it, on one GPU.

Run from the repository root:

    python3 tools/kernel_variants/sgm_rl_wta.py [--old DIR] [--knobs] [--variants] [--draft FILE ...]

At exact8 fused's shape (4 frames of 720 rows, 1152 valid columns, D=128,
int16 cost and volumes below the bench parameters' bounds) it times the
current kernel (``sgm_cuda.horizontal_rl_wta``, and its C entry alone,
without the wrapper's host time; its device launches a call, from
torch.profiler), the unfused pair it replaces on the same arguments (the
R->L horizontal scan #3 then the 4-volume WTA #4) and ``torch``'s copy of
the same bytes (a buffer of half the kernel's bytes in and out copied into
another). Every time is five runs of five calls, CUDA events.

``--old DIR`` adds the kernel of another ``csrc`` directory (an earlier
commit's, from ``git archive <commit> stereo_vision_tpu_torch/csrc``): its
``sgm.cu``, built with nvcc into ``tools/kernel_variants/_build/`` and
called through its C entry; its output is held to the current kernel's.
``--knobs`` adds copies of ``--old``'s ``sgm.cu`` (the first design's
kernel) and of the current one with one part taken out (their outputs are
wrong by design; only their times count): ``no_wta`` (the column's sums
written in place of the WTA's reductions), ``no_volume_loads`` (the three
volumes not read), ``no_store`` (the maps computed but not written).
``--variants`` adds copies of the current source with one choice changed
(``CURRENT_VARIANTS``), ``--draft FILE`` another source with the current
entry point, built against the current headers. Results go to
``tools/kernel_variants/_build/sgm_rl_wta.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from stereo_vision_tpu_torch import _build  # noqa: E402
from stereo_vision_tpu_torch.stereo import sgm_cuda  # noqa: E402

OUT = Path(__file__).resolve().parent / "_build"
CSRC = ROOT / "stereo_vision_tpu_torch/csrc"
# label -> frames, rows, valid columns, D, storage bytes
SHAPES = {"exact8 fused": (4, 720, 1152, 128, 2)}
COST_BOUND, P1, P2, UNIQ = 2325, 200, 800, 10  # the bench's exact8 parameters (block 5)
HBM = 3.35e12
_P, _I = ctypes.c_void_p, ctypes.c_int
RL_ARGS = [_P] * 10 + [_I] * 8 + [_P, _P]

# Knob copies: file -> label -> (text, replacement) pairs. "old" edits the
# first design's kernel (commit 8bc025c's sgm.cu), "current" this one.
_GUARD = -2147483641  # a value no map takes: the guarded stores never run
KNOBS = {
    "old": {
        "no_wta": [("    wta_store<VPL>(S, D, lane, uniq, p, minS, best, sm, s0, sp, uok);\n  }\n}",
                    "    int acc = 0;\n#pragma unroll\n    for (int k = 0; k < VPL; ++k) acc += S[k];\n"
                    "    if (lane == 0) minS[p] = best[p] = sm[p] = s0[p] = sp[p] = acc, uok[p] = acc & 1;\n  }\n}")],
        "no_volume_loads": [("      load_vec<T, VPL>(vols[j] + base, D, lane, t, 0);\n",
                             "#pragma unroll\n      for (int k = 0; k < VPL; ++k) t[k] = j + k;\n")],
        "no_store": [("  if (lane == 0) {\n    minS[p] = mn;", f"  if (lane == 0 && mn == {_GUARD}) {{\n    minS[p] = mn;")],
    },
    "current": {
        "no_wta": [("    const RlStats s = rl_reduce<VPL>(S, D, lane, a.uniq);\n",
                    "    int acc = 0;\n#pragma unroll\n    for (int k = 0; k < VPL; ++k) acc += S[k];\n"
                    "    const RlStats s{acc, acc, acc, acc, acc, (acc & 1) != 0};\n")],
        "no_volume_loads": [("          if (chunk_dst[i] >= 0) svt::cp_async(",
                             "          if (chunk_dst[i] >= 0 && chunk_dst[i] < 32 * kLane) svt::cp_async("),
                            ("        for (int j = 0; j < 4; ++j) {\n          auto g",
                             "        for (int j = 0; j < 1; ++j) {\n          auto g"),
                            ("      for (int j = 0; j < 3; ++j) read_words<T, VPL>(reinterpret_cast<const T*>(s + (j + 1) "
                             "* 32 * kLane), v[j]);",
                             "      for (int j = 0; j < 3; ++j)\n#pragma unroll\n"
                             "        for (int k = 0; k < VPL; ++k) v[j][k] = j + k;")],
        "no_store": [("    if ((x & 31) == 0 && x + lane < W) {\n",
                      f"    if ((x & 31) == 0 && x + lane < W && r0 == {_GUARD}) {{\n")],
    },
}

# Copies of the current sgm.cu with one choice changed: ring4 / ring8 a ring
# of 4 or 8 columns at D=128 int16 (the source's: 2, kRlRingBytes 2048);
# rows4 / rows2 4 or 2 rows a block (the source's: 8); lane_copies each lane
# copying its own 8 bytes an input (cp.async.ca; the source's: the warp's
# 16-byte chunks, cp.async.cg); wta_after the WTA of column x + 1 after
# the scan step of column x in program order (the source's: before it).
CURRENT_VARIANTS = {
    "ring4": [("constexpr int kRlRingBytes = 2048;", "constexpr int kRlRingBytes = 4096;")],
    "ring8": [("constexpr int kRlRingBytes = 2048;", "constexpr int kRlRingBytes = 8192;")],
    "rows4": [("constexpr int kRlRows = 8;", "constexpr int kRlRows = 4;")],
    "rows2": [("constexpr int kRlRows = 8;", "constexpr int kRlRows = 2;")],
    "lane_copies": [("  const bool coop = kLane < 16 && col % 16 == 0;", "  const bool coop = false;")],
    "wta_after": [("    reduce(S, x + 1);\n    advance(x, Sn);", "    advance(x, Sn);\n    reduce(S, x + 1);")],
}


def device_launches(fn, match: str, calls: int = 3) -> float | str:
    """Device launches a call of kernels whose name holds ``match``, from
    torch.profiler over ``calls`` calls ("not measured" where it records no
    device time)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    return sum(e.count for e in events if match in e.key) / calls if events else "not measured"


def event_runs(fn, runs: int = 5, reps: int = 5) -> list[float]:
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


def edited_copy(src_dir: Path, label: str, edits: list[tuple[str, str]]) -> Path:
    """A copy of ``src_dir`` under _build/<label> with ``edits`` applied to
    its sgm.cu (each text must be there once); returns the copy's sgm.cu."""
    dst = OUT / label
    dst.mkdir(parents=True, exist_ok=True)
    for p in src_dir.iterdir():
        if p.suffix not in (".cu", ".cuh"):
            continue
        text = p.read_text()
        if p.name == "sgm.cu":
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{label}: {old!r} is not in {src_dir / 'sgm.cu'} once")
                text = text.replace(old, new)
        (dst / p.name).write_text(text)
    return dst / "sgm.cu"


def build(jobs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """label -> source: one nvcc a source, all started together."""
    OUT.mkdir(exist_ok=True)
    procs = []
    for label, src in jobs.items():
        so = OUT / f"lib{label}.so"
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", str(CSRC), "-o", str(so), str(src)]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {label}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "rl_wta" in ln and "Compiling" in ln]
        print(f"built {label}: {len(regs)} fused R->L entries", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.svt_sgm_horizontal_rl_wta.argtypes = RL_ARGS
        libs[label] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="an earlier csrc directory")
    ap.add_argument("--knobs", action="store_true", help="time copies of the kernels with one part taken out")
    ap.add_argument("--variants", action="store_true", help="time copies of the current sgm.cu with one choice "
                    "changed (CURRENT_VARIANTS)")
    ap.add_argument("--draft", type=Path, action="append", default=[],
                    help="another source of svt_sgm_horizontal_rl_wta, built against the current csrc headers")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    jobs = {}
    if args.old:
        jobs["old"] = args.old / "sgm.cu"
    if args.knobs:
        for which, knobs in KNOBS.items():
            if which == "old" and not args.old:
                continue
            for name, edits in knobs.items():
                label = f"knob_{which}_{name}"
                jobs[label] = edited_copy(args.old if which == "old" else CSRC, label, edits)
    if args.variants:
        for name, edits in CURRENT_VARIANTS.items():
            jobs[f"variant_{name}"] = edited_copy(CSRC, f"variant_{name}", edits)
    jobs.update({f"draft_{d.stem}": d for d in args.draft})
    libs = build(jobs) if jobs else {}
    dev = torch.device("cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    results = {"card": card, "shapes": {}}
    for label, (B, H, W, D, nbytes) in SHAPES.items():
        dtype = torch.int16 if nbytes == 2 else torch.int32
        gen.manual_seed(D)
        C = torch.randint(0, COST_BOUND + 1, (B, H, W, D), dtype=dtype, device=dev, generator=gen)
        vols = [torch.randint(0, 3 * (COST_BOUND + P2) + 1, (B, H, W, D), dtype=dtype, device=dev, generator=gen)
                for _ in range(2)]
        vols.append(torch.randint(0, COST_BOUND + P2 + 1, (B, H, W, D), dtype=dtype, device=dev, generator=gen))
        kern = lambda: sgm_cuda.horizontal_rl_wta(C, *vols, P1, P2, UNIQ)
        ref = kern()
        n_in = 4 * C.numel() * nbytes
        n_out = sum(m.numel() * m.element_size() for m in ref)
        row = {"shape": [B, H, W, D], "bytes": n_in + n_out, "bound_ms": (n_in + n_out) / HBM * 1e3,
               "plan": sgm_cuda.horizontal_rl_wta.plan, "current_ms": event_runs(kern), "variants": {}}
        row["device_launches"] = device_launches(kern, "horizontal_rl_wta")
        row["unfused_pair_ms"] = event_runs(
            lambda: sgm_cuda.wta4(vols + [sgm_cuda.horizontal(C, P1, P2, True, COST_BOUND)], UNIQ))
        src = torch.empty((n_in + n_out) // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        row["copy_ms"] = event_runs(lambda: dst.copy_(src))
        del src, dst
        maps = [torch.empty_like(m) for m in ref]
        ptrs = [C.data_ptr()] + [v.data_ptr() for v in vols] + [m.data_ptr() for m in maps]
        cur = sgm_cuda._lib()
        row["variants"]["current (C entry)"] = event_runs(
            lambda: cur.svt_sgm_horizontal_rl_wta(*ptrs, B, H, W, D, P1, P2, UNIQ, nbytes, None, st()))
        for name, lib in libs.items():
            fn = lambda: lib.svt_sgm_horizontal_rl_wta(*ptrs, B, H, W, D, P1, P2, UNIQ, nbytes, None, st())
            if fn() != 0:
                raise SystemExit(f"{label}: {name} refused the call")
            torch.cuda.synchronize()
            if not name.startswith("knob_") and not all(torch.equal(a, b) for a, b in zip(maps, ref)):
                raise SystemExit(f"{label}: {name} differs from the current kernel")
            row["variants"][name] = event_runs(fn)
        print(f"{label} {row['shape']}: bound {row['bound_ms']:.4f} ms, plan {row['plan']}, device launches a call "
              f"{row['device_launches']}, current "
              f"{[round(x, 4) for x in row['current_ms']]}, unfused pair "
              f"{[round(x, 4) for x in row['unfused_pair_ms']]}, copy {[round(x, 4) for x in row['copy_ms']]}",
              flush=True)
        for k, v in row["variants"].items():
            print(f"  {k}: {[round(x, 4) for x in v]}", flush=True)
        results["shapes"][label] = row
        del C, vols, ref, maps
        torch.cuda.empty_cache()
    OUT.mkdir(exist_ok=True)
    (OUT / "sgm_rl_wta.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
