"""Time the box-downsample pyramid (#14) and the unpacked LR check (#9)
beside earlier forms of them, on one GPU.

Run from the repository root:

    python3 tools/kernel_variants/pyramid_lr.py [--old DIR] [--variants] [--parent-only] [--host]

#14 at the main paths' pyramids (hier4x3 and hier4x8: 32 frame pairs of
1280x720, levels (4, 4) and (2, 2); hier16x3: 8 pairs, (4, 4) alone) on
random 8-bit frames: the current ``banded_cuda.downsample_pyramid`` (the
wrapper and its C entry), its per-level form (one launch a level, both
images) and torch's ``avg_pool2d`` rounded, one call a level and image.
#9 at exact8's shape (4 frames of 720 rows, W = 1280, 1152 valid
columns, ndisp 128) on WTA-like maps: the current ``lr_cuda.lr_fail``
(wrapper and C entry). Beside each, torch's copy of the same bytes (half in,
half out). Every output is held to the plain form (run on the card) first;
every time is five runs of five calls, CUDA events.

``--old DIR`` adds an earlier ``csrc`` (``git archive <commit>
stereo_vision_tpu_torch/csrc``): its ``banded.cu`` (the one-level
``svt_downsample_box``, called once a level and image, as the parent's
``hier._prior`` did) and its ``lr.cu`` (``svt_lr_fail``), built with nvcc
into ``tools/kernel_variants/_build/``. ``--variants`` adds copies of the
current sources with one choice changed (``CURRENT_VARIANTS``).
``--parent-only`` builds and checks every form and times only ``--old``'s,
torch's copy and ``avg_pool2d`` (the parent's numbers, before a new
kernel's first timed run). ``--host`` adds the host time a call of the
wrappers takes at tiny shapes (device time ~nothing; host clock over
3,000 calls ending in a synchronise), and of the stream query, old and
new. Results go to
``tools/kernel_variants/_build/pyramid_lr.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from banded_wta import OUT, build, event_runs  # noqa: E402

from stereo_vision_tpu_torch import _build  # noqa: E402
from stereo_vision_tpu_torch.stereo import banded_cuda, lr_cuda, sgbm  # noqa: E402

HBM = 3.35e12
H, W = 720, 1280
# label -> frame pairs, level factors (the main paths' pyramids)
PYRAMIDS = {"hier4x3": (32, ((4, 4), (2, 2))), "hier16x3": (8, ((4, 4),))}
# exact8's unpacked LR check: frames, rows, frame width, ndisp, min_disparity
LR_SHAPE = (4, 720, 1280, 128, 0)
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_BOX_ARGS = [_P] * 2 + [_I] * 5 + [_P]
BOX_ARGS = [_P] * 3 + [_I] * 5 + [_P]
PYR_ARGS = [_P] * 2 + [_I] * 4 + [_P] * 4
LR_ARGS = [_P] * 4 + [_I] * 7 + [_P]

# Copies of the current sources with one choice changed: (file, text,
# replacement). pyr_rows4 / pyr_rows16: 4 or 16 row tiles a block (the
# source's: 8); pyr_stream_loads: the frames read with the streaming hint
# (__ldcs) in place of __ldg; lr_words1 / 3 / 4: the unpacked LR check
# with 1, 3 or 4 words a thread and map in a batch (the source's: 2;
# threads a row follow, at most 256: 256 (two batches), 96, 96 at exact8;
# the source's 160); lr_threads128: at most 128 threads a row (two
# batches at exact8).
CURRENT_VARIANTS = {
    "pyr_rows4": [("downsample.cu", "constexpr int kPyrRows = 8;", "constexpr int kPyrRows = 4;")],
    "pyr_rows16": [("downsample.cu", "constexpr int kPyrRows = 8;", "constexpr int kPyrRows = 16;")],
    "pyr_stream_loads": [("downsample.cu", "const int4 w = __ldg(reinterpret_cast<const int4*>(row));",
                          "const int4 w = __ldcs(reinterpret_cast<const int4*>(row));")],
    "lr_words1": [("lr.cu", "constexpr int kLrRowWords = 2;", "constexpr int kLrRowWords = 1;")],
    "lr_words3": [("lr.cu", "constexpr int kLrRowWords = 2;", "constexpr int kLrRowWords = 3;")],
    "lr_words4": [("lr.cu", "constexpr int kLrRowWords = 2;", "constexpr int kLrRowWords = 4;")],
    "lr_threads128": [("lr.cu", "constexpr int kLrRowThreads = 256;", "constexpr int kLrRowThreads = 128;")],
}


def current_variants() -> dict[str, Path]:
    """The current csrc with each of CURRENT_VARIANTS applied, a directory each."""
    src = ROOT / "stereo_vision_tpu_torch/csrc"
    out = {}
    for name, edits in CURRENT_VARIANTS.items():
        dst = OUT / f"variant_{name}"
        dst.mkdir(parents=True, exist_ok=True)
        for p in src.iterdir():
            text = p.read_text()
            for f, old, new in edits:
                if p.name == f:
                    if text.count(old) != 1:
                        raise SystemExit(f"{f}: {old!r} is not there once; the variants know the current kernels")
                    text = text.replace(old, new)
            (dst / p.name).write_text(text)
        out[f"variant_{name}"] = dst / edits[0][0]
    return out


def runs_note(v: list[float]) -> str:
    return str([round(x, 4) for x in v])


def copy_runs(nbytes: int, dev) -> list[float]:
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    return event_runs(lambda: dst.copy_(src))


def pyramid_rows(libs, dev, st, parent_only: bool) -> dict:
    gen = torch.Generator(device=dev)
    out = {}
    for label, (P, factors) in PYRAMIDS.items():
        gen.manual_seed(P)
        left, right = (torch.randint(0, 256, (P, H, W), dtype=torch.int32, device=dev, generator=gen)
                       for _ in range(2))
        kern = lambda: banded_cuda.downsample_pyramid(left, right, factors)
        got = kern()
        ref = banded_cuda.downsample_pyramid_plain(left, right, factors)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for g, r in zip(got, ref) for a, b in zip(g, r)):
            raise SystemExit(f"{label}: downsample_pyramid differs from its plain form")
        outs = [torch.empty((2, P, H // fy, W // fx), dtype=torch.int32, device=dev) for fy, fx in factors]
        n = len(factors)
        order = sorted(range(n), key=lambda i: factors[i])
        cur = banded_cuda._lib("downsample")
        call = lambda lib: lib.svt_downsample_pyramid(
            left.data_ptr(), right.data_ptr(), P, H, W, n, (ctypes.c_int * n)(*(factors[i][0] for i in order)),
            (ctypes.c_int * n)(*(factors[i][1] for i in order)),
            (ctypes.c_void_p * n)(*(outs[i].data_ptr() for i in order)), st())
        per_level = lambda lib: [lib.svt_downsample_box(left.data_ptr(), right.data_ptr(), o.data_ptr(), P, H, W, fy,
                                                        fx, st()) for (fy, fx), o in zip(factors, outs)]
        old_levels = lambda lib: [lib.svt_downsample_box(img.data_ptr(), o[i].data_ptr(), P, H, W, fy, fx, st())
                                  for (fy, fx), o in zip(factors, outs) for i, img in enumerate((left, right))]
        forms = {"current (C entry)": lambda: call(cur), "per-level form (C entry)": lambda: per_level(cur)}
        for name, lib in libs.items():
            if hasattr(lib, "svt_downsample_pyramid"):
                forms[name] = lambda lib=lib: call(lib)
            elif hasattr(lib, "svt_downsample_box"):
                forms[f"{name} (one launch a level and image)"] = lambda lib=lib: old_levels(lib)
        for name, fn in forms.items():
            for o in outs:
                o.fill_(-1)
            rc = fn()
            if any(rc) if isinstance(rc, list) else rc:
                raise SystemExit(f"{label}: {name} refused the call")
            torch.cuda.synchronize()
            if not all(torch.equal(o[i], g[i]) for o, g in zip(outs, got) for i in (0, 1)):
                raise SystemExit(f"{label}: {name} differs from the current kernel")
        nbytes = 2 * left.numel() * 4 + sum(o.numel() * 4 for o in outs)
        row = {"frames": P, "factors": factors, "bytes": nbytes, "bound_ms": nbytes / HBM * 1e3, "forms": {}}
        print(f"pyramid {label} {P}x{H}x{W} {factors}: exact ({', '.join(forms)}); bound {row['bound_ms']:.4f} ms",
              flush=True)
        if not parent_only:
            row["current_ms"] = event_runs(kern)
        row["copy_ms"] = copy_runs(nbytes, dev)
        pool = lambda: [torch.round(torch.nn.functional.avg_pool2d(img.float()[:, None], f))[:, 0].to(torch.int32)
                        for f in factors for img in (left, right)]
        row["avg_pool2d_ms"] = event_runs(pool)
        timed = {name: fn for name, fn in forms.items() if not parent_only or name.startswith("old_")}
        row["forms"] = {name: event_runs(fn) for name, fn in timed.items()}
        print(f"  wrapper {runs_note(row.get('current_ms', []))}, copy {runs_note(row['copy_ms'])}, avg_pool2d "
              f"{runs_note(row['avg_pool2d_ms'])}", flush=True)
        for name, v in row["forms"].items():
            print(f"  {name}: {runs_note(v)}", flush=True)
        out[label] = row
        del left, right, got, ref, outs
        torch.cuda.empty_cache()
    return out


def lr_row(libs, dev, st, parent_only: bool) -> dict:
    B, Hh, Wf, nd, md = LR_SHAPE
    min_x = nd + md
    Wv = Wf - min_x
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    shape = (B, Hh, Wv)
    best = torch.randint(0, nd, shape, dtype=torch.int32, device=dev, generator=gen)
    minS = torch.randint(0, 12000, shape, dtype=torch.int32, device=dev, generator=gen)
    frac = torch.randint(-8, 9, shape, dtype=torch.int32, device=dev, generator=gen)
    disp = ((best * 16 + frac).float() / 16.0 + md).contiguous()
    kw = dict(W=Wf, min_x=min_x, ndisp=nd, mindisp=md, max_diff=1)
    kern = lambda: lr_cuda.lr_fail(minS, best, disp, **kw)
    ref = kern()
    if not torch.equal(ref, sgbm.lr_fail(minS, best, disp, **kw)) or not ref.any():
        raise SystemExit("exact8 LR: lr_fail differs from its plain form")
    fail = torch.empty_like(ref)
    call = lambda lib: lib.svt_lr_fail(minS.data_ptr(), best.data_ptr(), disp.data_ptr(), fail.data_ptr(), B * Hh,
                                       Wf, Wv, min_x, nd, md, 1, st())
    forms = {"current (C entry)": lambda: call(lr_cuda._lib())}
    forms.update({name: (lambda lib=lib: call(lib)) for name, lib in libs.items() if hasattr(lib, "svt_lr_fail")})
    for name, fn in forms.items():
        fail.fill_(True)
        if fn() != 0:
            raise SystemExit(f"exact8 LR: {name} refused the call")
        torch.cuda.synchronize()
        if not torch.equal(fail, ref):
            raise SystemExit(f"exact8 LR: {name} differs from the current kernel")
    nbytes = 3 * minS.numel() * 4 + ref.numel()
    row = {"shape": list(shape), "W": Wf, "ndisp": nd, "bytes": nbytes, "bound_ms": nbytes / HBM * 1e3, "forms": {}}
    print(f"LR exact8 {shape}: exact ({', '.join(forms)}); bound {row['bound_ms']:.4f} ms", flush=True)
    if not parent_only:
        row["current_ms"] = event_runs(kern)
    row["copy_ms"] = copy_runs(nbytes, dev)
    row["forms"] = {name: event_runs(fn) for name, fn in forms.items() if not parent_only or name.startswith("old_")}
    print(f"  wrapper {runs_note(row.get('current_ms', []))}, copy {runs_note(row['copy_ms'])}", flush=True)
    for name, v in row["forms"].items():
        print(f"  {name}: {runs_note(v)}", flush=True)
    return row


def host_us(dev) -> dict:
    """Host microseconds a call at tiny shapes, where the device time is
    ~nothing: what a wrapper adds to a small call's ms."""
    from stereo_vision_tpu_torch.device import stream_handle

    def per_call(fn, n=3000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    l = torch.zeros((1, 16, 32), dtype=torch.int32, device=dev)
    r = l.clone()
    m = torch.zeros((1, 4, 64), dtype=torch.int32, device=dev)
    f = torch.zeros((1, 4, 64), device=dev)
    out = {"torch.cuda.current_stream(d).cuda_stream": per_call(lambda: torch.cuda.current_stream(dev).cuda_stream),
           "device.stream_handle": per_call(lambda: stream_handle(l)),
           "downsample_box (one level, one image)": per_call(lambda: banded_cuda.downsample_box(l, 4)),
           "downsample_pyramid ((4, 4),)": per_call(lambda: banded_cuda.downsample_pyramid(l, r, ((4, 4),))),
           "downsample_pyramid ((4, 4), (2, 2))": per_call(
               lambda: banded_cuda.downsample_pyramid(l, r, ((4, 4), (2, 2)))),
           "lr_fail": per_call(lambda: lr_cuda.lr_fail(m, m, f, W=80, min_x=16, ndisp=16, mindisp=0, max_diff=1))}
    for k, v in out.items():
        print(f"host {k}: {v:.2f} us a call", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="an earlier csrc directory")
    ap.add_argument("--variants", action="store_true", help="time copies of the current sources with one choice "
                    "changed (CURRENT_VARIANTS)")
    ap.add_argument("--parent-only", action="store_true", help="build and check; time only --old's forms")
    ap.add_argument("--host", action="store_true", help="time the wrappers' host cost a call at tiny shapes")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    jobs = {}
    if args.old:
        jobs.update(old_banded=args.old / "banded.cu", old_lr=args.old / "lr.cu")
    if args.variants:
        jobs.update(current_variants())
    for name, text in _build.build(["downsample", "lr"]).items():
        print(f"{name}: " + "; ".join(ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln),
              flush=True)
    libs = build(jobs) if jobs else {}
    for lib in libs.values():
        for fn, argtypes in (("svt_downsample_pyramid", PYR_ARGS), ("svt_lr_fail", LR_ARGS)):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
        if hasattr(lib, "svt_downsample_box"):
            lib.svt_downsample_box.argtypes = BOX_ARGS if hasattr(lib, "svt_downsample_pyramid") else OLD_BOX_ARGS
    dev = torch.device("cuda")
    st = lambda: torch.cuda.current_stream().cuda_stream
    results = {"card": card, "pyramid": pyramid_rows(libs, dev, st, args.parent_only),
               "lr": lr_row(libs, dev, st, args.parent_only)}
    if args.host:
        results["host_us"] = host_us(dev)
    OUT.mkdir(exist_ok=True)
    (OUT / "pyramid_lr.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
