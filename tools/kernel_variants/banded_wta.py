"""Time the banded WTA (#20) and the packed LR check (#10) beside earlier
forms of them, on one GPU.

Run from the repository root:

    python3 tools/kernel_variants/banded_wta.py [--old DIR] [--knobs] [--variants] [--fused] [--draft FILE ...]

At each main-path level of #20 (hier4x3's coarse, mid and full levels at 32
frames, hier16x3's coarse and full levels at 8 frames, hier4x8's full
level: the band, the number of direction volumes and the form each level
runs; int16 volumes below the bench parameters' bound) it times the
current kernel (``banded_cuda.banded_wta``, and its C entry alone, without
the wrapper's host time) and, at hier4x3's and hier16x3's full-level
shapes, the current packed LR kernel (``lr_cuda.lr_fail_packed``) on
synthetic maps; then ``torch``'s copy of
the same bytes (a buffer of half the kernel's bytes in and out copied into
another, so that the copy moves as many bytes as the kernel), as a measure
of what the card streams. Every time is five runs of five calls, CUDA
events.

``--old DIR`` adds the kernels of another ``csrc`` directory (an earlier
commit's, from ``git archive <commit> stereo_vision_tpu_torch/csrc``):
its ``banded.cu`` and ``lr.cu``, built with nvcc into
``tools/kernel_variants/_build/`` and called through their C entry points;
each output is held to the current kernel's. ``--knobs`` adds copies of
the earlier ``banded.cu`` (``--old``'s, else the current one) with one part
of its WTA taken out (their outputs are wrong by design; only their times
count): ``no_store`` (the maps are computed but not written),
``no_reduce`` (the volumes are loaded and summed, the lanes summed in place
of the reduction, the maps written), ``loads_only`` (both). ``--variants``
adds copies of the current sources with one choice changed
(``CURRENT_VARIANTS``), ``--draft FILE`` another source with the current
entry points, built against the current headers. ``--fused`` adds the
fused WTA (#19) at its one main-path level, hier16x3's full level under
``hier._FUSED_STATS`` (8 frames, K=16, three volumes and a shift map in
[0, ndisp - 16]): the current kernel (the wrapper and its C entry; its
device launches a call, torch.profiler), #20 on
the same volumes, ``torch``'s copy of the fused form's bytes and, with
``--old`` (or ``--draft``), that source's ``svt_banded_wta_fused``, its
output held to the current kernel's. Results go to
``tools/kernel_variants/_build/banded_wta.json``.
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
from stereo_vision_tpu_torch.stereo import banded_cuda, lr_cuda  # noqa: E402

OUT = Path(__file__).resolve().parent / "_build"
# label -> frames, rows, valid columns, band, volumes, sub (the main paths' levels)
SHAPES = {"hier4x3 coarse": (32, 180, 288, 32, 4, True), "hier4x3 mid": (32, 360, 576, 8, 2, True),
          "hier4x3 full": (32, 720, 1152, 4, 3, True), "hier16x3 coarse": (8, 180, 288, 32, 4, True),
          "hier16x3 full": (8, 720, 1152, 16, 3, False), "hier4x8 full": (32, 720, 1152, 4, 4, True)}
# label -> frames x rows, frame width, ndisp (the packed LR check's main-path calls)
LR_SHAPES = {"hier4x3": (32 * 720, 1280, 128), "hier16x3": (8 * 720, 1280, 128)}
BOUND = 3125  # one direction volume's bound at the bench's p3 (cost_bound 2325 + P2 800)
HBM = 3.35e12
_P, _I = ctypes.c_void_p, ctypes.c_int
WTA_ARGS = [_P] * 4 + [_I] + [_P] * 6 + [_I] * 5 + [_P]
LR_ARGS = [_P] * 3 + [_I] * 5 + [_P]
FUSED_ARGS = [_P] * 4 + [_I] + [_P] * 3 + [_I] * 4 + [_P]
# The fused WTA's level: frames, rows, valid columns, volumes, ndisp.
FUSED_SHAPE = (8, 720, 1152, 3, 128)

# Knob copies of banded.cu's WTA: (text, replacement) pairs.
_REDUCE = "  const WtaStats w = wta_reduce<KP>(S, K, uniq);\n  minS[p] = w.mn;"
_SUMS = ("  int acc = 0;\n#pragma unroll\n  for (int k = 0; k < KP; ++k) acc += S[k];\n"
         "  const WtaStats w{acc, acc & 63, acc, acc, acc, true};\n")
_GUARD = "  if (w.mn != -2147483641) return;  // never: the maps are computed, not written\n"
KNOBS = {
    "no_store": [(_REDUCE, "  const WtaStats w = wta_reduce<KP>(S, K, uniq);\n" + _GUARD + "  minS[p] = w.mn;")],
    "no_reduce": [(_REDUCE, _SUMS + "  minS[p] = w.mn;")],
    "loads_only": [(_REDUCE, _SUMS + _GUARD + "  minS[p] = w.mn;")],
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


def build(jobs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """label -> source: one nvcc a source, all started together."""
    OUT.mkdir(exist_ok=True)
    procs = []
    for label, src in jobs.items():
        so = OUT / f"lib{label}.so"
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", str(ROOT / "stereo_vision_tpu_torch/csrc"), "-o", str(so),
               str(src)]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {label}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"built {label}: {len(regs)} entries; {regs[:2]}", flush=True)
        libs[label] = ctypes.CDLL(str(so))
    return libs


# Copies of the current sources with one choice changed: (file, text,
# replacement). wta_threads128 / wta_serial32 / wta_minblocks3: the WTA
# with 128 threads a block at every band (the source's: 256 to K = 16), with
# the volumes loaded one after another from K = 17 (the source's: from 33),
# or registers held to 3 blocks an SM; lr_ahead1 / lr_ahead4 / lr_warps16 / lr_minblocks2 /
# lr_minblocks5: the packed LR check with 1 or 4 words a lane loaded ahead
# (and a batch), 16 rows a block, or registers held to 2 or 5 blocks an SM
# (the source's: 2 words, 8 rows, 4 blocks); lr_no_scatter / lr_no_lookup:
# without its atomicMin or its shared-memory lookups (wrong by design).
CURRENT_VARIANTS = {
    "wta_threads128": [("banded_wta.cu", "wta_threads(int KP) { return KP <= 16 ? 256 : 128; }",
                        "wta_threads(int KP) { return KP <= 16 ? 128 : 128; }")],
    "wta_serial32": [("banded_wta.cu", "  if constexpr (KP <= 32) {\n    Raw<T, KP> raw[4];",
                      "  if constexpr (KP <= 16) {\n    Raw<T, KP> raw[4];")],
    "wta_minblocks3": [("banded_wta.cu", "__global__ void __launch_bounds__(wta_threads(KP))\n",
                        "__global__ void __launch_bounds__(wta_threads(KP), 3)\n")],
    "lr_ahead1": [("lr.cu", "constexpr int kLrAhead = 2;", "constexpr int kLrAhead = 1;")],
    "lr_ahead4": [("lr.cu", "constexpr int kLrAhead = 2;", "constexpr int kLrAhead = 4;")],
    "lr_warps16": [("lr.cu", "constexpr int kLrWarps = 8;", "constexpr int kLrWarps = 16;")],
    "lr_minblocks2": [("lr.cu", "constexpr int kLrBlocks = 4;", "constexpr int kLrBlocks = 2;")],
    "lr_minblocks5": [("lr.cu", "constexpr int kLrBlocks = 4;", "constexpr int kLrBlocks = 5;")],
    "lr_no_scatter": [("lr.cu", "if (d < ndisp && x2 >= 0 && x2 < W) atomicMin(&disp2[x2], p);",
                       "if (d < ndisp && x2 >= 0 && x2 < W && p == -7) atomicMin(&disp2[x2], p);")],
    "lr_no_lookup": [("lr.cu", "if (sh >= -1 && sh <= ndisp && c >= 0 && c < W) {\n            const int q = disp2[c];",
                      "if (sh >= -1 && sh <= ndisp && c >= 0 && c < W) {\n            const int q = c;")],
}


def current_variants() -> dict[str, Path]:
    """The current csrc with each of CURRENT_VARIANTS applied, a directory each."""
    src = ROOT / "stereo_vision_tpu_torch/csrc"
    out = {}
    for name, edits in CURRENT_VARIANTS.items():
        dst = OUT / f"variant_{name}"
        dst.mkdir(parents=True, exist_ok=True)
        target = edits[0][0]
        for p in src.iterdir():
            text = p.read_text()
            for f, old, new in edits:
                if p.name == f:
                    if text.count(old) != 1:
                        raise SystemExit(f"{f}: {old!r} is not there once; the variants know the current kernels")
                    text = text.replace(old, new)
            (dst / p.name).write_text(text)
        out[f"variant_{name}"] = dst / target
    return out


def knob_sources(src: Path) -> dict[str, Path]:
    """Copies of ``src``'s csrc with each knob applied to banded.cu."""
    out = {}
    for name, edits in KNOBS.items():
        dst = OUT / f"knob_{name}"
        dst.mkdir(parents=True, exist_ok=True)
        for p in src.iterdir():
            text = p.read_text()
            if p.name == "banded.cu":
                for old, new in edits:
                    if text.count(old) != 1:
                        raise SystemExit(f"banded.cu: {old!r} is not there once; the knobs know the "
                                         "one-thread-a-pixel WTA of commit 1eec350")
                    text = text.replace(old, new)
            (dst / p.name).write_text(text)
        out[f"knob_{name}"] = dst / "banded.cu"
    return out


def fused_level(libs: dict[str, ctypes.CDLL], gen: torch.Generator, st) -> dict:
    """#19 at hier16x3's full level beside #20 on the same volumes, torch's
    copy of its bytes and the other sources' svt_banded_wta_fused."""
    P, H, Wv, nvol, ndisp = FUSED_SHAPE
    K, dev = banded_cuda.FUSED_BAND, torch.device("cuda")
    gen.manual_seed(K * nvol)
    vols = [torch.randint(0, BOUND + 1, (P, H, Wv, K), dtype=torch.int16, device=dev, generator=gen)
            for _ in range(nvol)]
    s = torch.randint(0, ndisp - K + 1, (P, H, Wv), dtype=torch.int32, device=dev, generator=gen)
    kern = lambda: banded_cuda.banded_wta_fused(vols, s, 10, ndisp=ndisp)
    ref = kern()
    nbytes = sum(v.numel() * 2 for v in vols) + s.numel() * 4 + sum(m.numel() * 4 for m in ref)
    row = {"shape": [P, H, Wv, K], "volumes": nvol, "bytes": nbytes, "bound_ms": nbytes / HBM * 1e3,
           "current_ms": event_runs(kern), "wta20_ms": event_runs(lambda: banded_cuda.banded_wta(vols, 10, False)),
           "variants": {}}
    row["device_launches"] = device_launches(kern, "banded_wta_fused")
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    row["copy_ms"] = event_runs(lambda: dst.copy_(src))
    del src, dst
    out = [torch.empty_like(m) for m in ref]
    ptrs = [v.data_ptr() for v in vols] + [None] * (4 - nvol)
    call = lambda lib: lib.svt_banded_wta_fused(*ptrs, nvol, s.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                                P * H * Wv, K, 10, 2, st())
    cur = banded_cuda._lib("banded_wta")
    row["variants"]["current (C entry)"] = event_runs(lambda: call(cur))
    for name, lib in libs.items():
        if not hasattr(lib, "svt_banded_wta_fused"):
            continue
        if call(lib) != 0:
            raise SystemExit(f"fused: {name} refused the call")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise SystemExit(f"fused: {name} differs from the current kernel")
        row["variants"][name] = event_runs(lambda: call(lib))
    print(f"fused hier16x3 full {row['shape']} x{nvol}: bound {row['bound_ms']:.4f} ms, device launches a call "
          f"{row['device_launches']}, current "
          f"{[round(x, 4) for x in row['current_ms']]}, #20 {[round(x, 4) for x in row['wta20_ms']]}, copy "
          f"{[round(x, 4) for x in row['copy_ms']]}, " + ", ".join(f"{k} {[round(x, 4) for x in v]}"
                                                               for k, v in row["variants"].items()), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="an earlier csrc directory")
    ap.add_argument("--knobs", action="store_true", help="time copies of the WTA with one part taken out")
    ap.add_argument("--variants", action="store_true", help="time copies of the current sources with one choice "
                    "changed (CURRENT_VARIANTS)")
    ap.add_argument("--fused", action="store_true", help="time the fused WTA (#19) at hier16x3's full level")
    ap.add_argument("--draft", type=Path, action="append", default=[],
                    help="another source of svt_banded_wta or svt_lr_fail_packed (the current entry points' "
                         "arguments), built against the current csrc headers")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    jobs = {}
    if args.old:
        jobs.update(old_banded=args.old / "banded.cu", old_lr=args.old / "lr.cu")
    if args.knobs:
        jobs.update(knob_sources(args.old or ROOT / "stereo_vision_tpu_torch/csrc"))
    if args.variants:
        jobs.update(current_variants())
    jobs.update({f"draft_{d.stem}": d for d in args.draft})
    libs = build(jobs) if jobs else {}
    for label, lib in libs.items():
        if hasattr(lib, "svt_lr_fail_packed"):
            lib.svt_lr_fail_packed.argtypes = LR_ARGS
        if hasattr(lib, "svt_banded_wta"):
            lib.svt_banded_wta.argtypes = WTA_ARGS
        if hasattr(lib, "svt_banded_wta_fused"):
            lib.svt_banded_wta_fused.argtypes = FUSED_ARGS
    dev = torch.device("cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    results = {"card": card, "wta": {}, "lr": {}}
    for label, (P, H, Wv, K, nvol, sub) in SHAPES.items():
        gen.manual_seed(K + nvol)
        vols = [torch.randint(0, BOUND + 1, (P, H, Wv, K), dtype=torch.int16, device=dev, generator=gen)
                for _ in range(nvol)]
        kern = lambda: banded_cuda.banded_wta(vols, 10, sub)
        ref = kern()
        n_in = sum(v.numel() * 2 for v in vols)
        n_out = sum(m.numel() * m.element_size() for m in ref)
        row = {"shape": [P, H, Wv, K], "volumes": nvol, "sub": sub, "bytes": n_in + n_out,
               "bound_ms": (n_in + n_out) / HBM * 1e3, "current_ms": event_runs(kern), "variants": {}}
        src = torch.empty((n_in + n_out) // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        row["copy_ms"] = event_runs(lambda: dst.copy_(src))
        del src, dst
        maps = [torch.empty_like(m) for m in ref]
        ptrs = [v.data_ptr() for v in vols] + [None] * (4 - nvol)
        mptrs = [m.data_ptr() for m in maps[:-1]] + [None] * (5 - len(maps) + 1) + [maps[-1].data_ptr()]
        cur = banded_cuda._lib("banded_wta")
        row["variants"]["current (C entry)"] = event_runs(
            lambda: cur.svt_banded_wta(*ptrs, nvol, *mptrs, P * H * Wv, K, 10, int(sub), 2, st()))
        for name, lib in libs.items():
            if not hasattr(lib, "svt_banded_wta"):
                continue
            fn = lambda: lib.svt_banded_wta(*ptrs, nvol, *mptrs, P * H * Wv, K, 10, int(sub), 2, st())
            if fn() != 0:
                raise SystemExit(f"{label}: {name} refused the call")
            torch.cuda.synchronize()
            if not name.startswith("knob_") and not all(torch.equal(a, b) for a, b in zip(maps, ref)):
                raise SystemExit(f"{label}: {name} differs from the current kernel")
            row["variants"][name] = event_runs(fn)
        print(f"{label} {row['shape']} x{nvol} {'sub' if sub else '6-stat'}: bound {row['bound_ms']:.4f} ms, "
              f"current {[round(x, 4) for x in row['current_ms']]}, copy {[round(x, 4) for x in row['copy_ms']]}",
              flush=True)
        for k, v in row["variants"].items():
            print(f"  {k}: {[round(x, 4) for x in v]}", flush=True)
        results["wta"][label] = row
        del vols, ref, maps
        torch.cuda.empty_cache()
    for label, (rows, W, ndisp) in LR_SHAPES.items():
        Wv = W - ndisp
        gen.manual_seed(rows)
        d = torch.randint(0, ndisp, (rows, 1, Wv), dtype=torch.int32, device=dev, generator=gen)
        cost = torch.randint(0, 12000, (rows, 1, Wv), dtype=torch.int32, device=dev, generator=gen)
        pack = cost * 2048 + d
        d16 = d * 16 + torch.randint(-8, 9, (rows, 1, Wv), dtype=torch.int32, device=dev, generator=gen)
        kern = lambda: lr_cuda.lr_fail_packed(pack, d16, W=W, ndisp=ndisp, max_diff=1)
        ref = kern()
        nbytes = 2 * pack.numel() * 4 + ref.numel()
        row = {"rows": rows, "W": W, "ndisp": ndisp, "bytes": nbytes, "bound_ms": nbytes / HBM * 1e3,
               "current_ms": event_runs(kern), "variants": {}}
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        row["copy_ms"] = event_runs(lambda: dst.copy_(src))
        del src, dst
        for name, lib in libs.items():
            if not hasattr(lib, "svt_lr_fail_packed"):
                continue
            fail = torch.empty_like(ref)
            fn = lambda: lib.svt_lr_fail_packed(pack.data_ptr(), d16.data_ptr(), fail.data_ptr(), rows, W, Wv, ndisp,
                                                1, st())
            if fn() != 0:
                raise SystemExit(f"LR {label}: {name} refused the call")
            torch.cuda.synchronize()
            if not name.startswith(("variant_lr_no",)) and not torch.equal(fail, ref):
                raise SystemExit(f"LR {label}: {name} differs from the current kernel")
            row["variants"][name] = event_runs(fn)
        print(f"LR {label} rows {rows} W {W}: bound {row['bound_ms']:.4f} ms, current "
              f"{[round(x, 4) for x in row['current_ms']]}, copy {[round(x, 4) for x in row['copy_ms']]}, "
              + ", ".join(f"{k} {[round(x, 4) for x in v]}" for k, v in row["variants"].items()), flush=True)
        results["lr"][label] = row
    if args.fused:
        results["fused"] = fused_level(libs, gen, st)
    OUT.mkdir(exist_ok=True)
    (OUT / "banded_wta.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
