"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Run from the repository root:  python3 chip_smoke.py

Phases, in order (any failure raises and the script exits nonzero):
  1. print the card's name and power limit (nvidia-smi);
  2. build every csrc/*.cu with nvcc for sm_90a (one process per source);
  3. per kernel, at the main path's shapes (1280x720, D=128, 4 frames):
     the CUDA wrapper against its plain PyTorch form on the card, exact
     equality; CUDA-event times of both and the kernel's bound;
  4. the pipeline at 240x320, D=64, 2 frames on CUDA and on the CPU:
     disparity exactly equal, points within float32 rtol 1e-6;
  5. the main path, batched_stereo_pipeline(matcher="sgbm") at 1280x720,
     4 frames, the bench's exact8 parameters: every kernel's launch count
     must move; valid share and within-1px share against the scene's true
     disparity must clear floors; ms per 4-frame call and Mpx/s, plus a
     per-stage breakdown.
The next-to-last line is the kernels' JSON, the last the device JSON.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from stereo_vision_tpu_torch import _build
from stereo_vision_tpu_torch.ops.remap import remap_bilinear
from stereo_vision_tpu_torch.parallel.streaming import batched_stereo_pipeline
from stereo_vision_tpu_torch.stereo import cost_cuda, sgm_cuda
from stereo_vision_tpu_torch.stereo.depth import reproject_disparity_to_3d
from stereo_vision_tpu_torch.stereo.postprocess import speckle_filter
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, lr_fail, subpixel_disp16
from stereo_vision_tpu_torch.synth.scenes import scene, scene_truth

H, W, D, B = 720, 1280, 128, 4
# bench.py's exact8 mode (BASELINE config #2).
PARAMS = StereoSGBMParams(num_disparities=D, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                          speckle_window_size=100, speckle_range=2)
# Floors for the ramp+box scene, from a CPU run of the plain forms at
# 240x480 with these parameters and rig() maps (valid 0.9672, within-1px
# 0.9994 over the columns x >= min_x), lowered by a margin for the larger frame.
VALID_FLOOR, WITHIN1_FLOOR = 0.90, 0.98
# H100 SXM data-sheet peaks: HBM bytes/s, and 32-bit integer operations/s
# counted against the 67 T/s non-tensor float32 rate (the data sheet gives
# no int32 rate; int32 issues at most that fast, so the bound stays a bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SOURCES = {"cost": "stereo_vision_tpu_torch/csrc/cost.cu", "sgm": "stereo_vision_tpu_torch/csrc/sgm.cu"}


def rig(h: int, w: int):
    """Smooth non-identity rectification maps (same sub-pixel warp for both
    views, so the scene's disparity survives within a fraction of a pixel)
    and the Q of a rectified rig (f = 1000 px, baseline 0.1 m)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mx = xx + 0.3 * np.sin(2 * np.pi * yy / h)
    my = yy + 0.25 * np.cos(2 * np.pi * xx / w)
    maps = tuple(a.astype(np.float32) for a in (mx, my, mx, my))
    Q = np.array([[1, 0, 0, -w / 2], [0, 1, 0, -h / 2], [0, 0, 0, 1000.0], [0, 0, 10.0, 0]], np.float32)
    return maps, Q


def quality(disp: np.ndarray, truth: np.ndarray, min_x: int) -> tuple[float, float]:
    """(valid share, within-1px share of the valid pixels) over x >= min_x."""
    d, t = disp[..., min_x:], np.broadcast_to(truth, disp.shape)[..., min_x:]
    valid = d > PARAMS.min_disparity - 1
    return float(valid.mean()), float((np.abs(d - t)[valid] <= 1.0).mean())


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(out, ref) -> int:
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(outs, refs))


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels(dev) -> list[dict]:
    """Each kernel against its plain form at the main path's shapes."""
    frames = [scene(seed=s) for s in range(B)]
    left = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    right = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    p = PARAMS
    minX1 = p.min_disparity + D
    Wv = W - minX1
    n = B * H * Wv * D  # elements of one volume
    vol = n * 2  # bytes of one int16 volume
    ckw = dict(ndisp=D, mindisp=p.min_disparity, block_size=p.block_size, ftzero=p.ftzero, x_offset=minX1)
    P1, P2, bound = p.P1, p.P2, p.cost_bound
    rows = []

    def check(name, src, replaces, kern, plain, nbytes, nops, reps):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        shapes_ok = all(a.shape == b.shape for a, b in zip(out if isinstance(out, tuple) else (out,),
                                                            ref if isinstance(ref, tuple) else (ref,)))
        if err != 0 or not shapes_ok:
            raise AssertionError(f"{name}: kernel differs from its plain form (max abs err {err})")
        ms, plain_ms = event_ms(kern, reps), event_ms(plain, 1)
        b_ms, b_by = bound_ms(nbytes, nops)
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces, launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
        print(f"kernel {name}: exact, {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by})",
              flush=True)
        return out

    # Operation counts per element, 32-bit integer ops: BT cost of two
    # channels (2 x 9) + shift/add (2) + separable box (2 (bs-1)); one SGM
    # direction step ~8 (3 min, 2 add, add/sub, min-reduce); WTA ~10.
    C = check("cost", SOURCES["cost"], "stereo_vision_tpu/stereo/cost_pallas.py:107 _cost_kernel",
              lambda: cost_cuda.cost_volume(left, right, **ckw),
              lambda: cost_cuda.cost_volume_plain(left, right, **ckw),
              2 * B * H * W * 4 + vol, n * (20 + 2 * (p.block_size - 1)), 10)
    vols = list(check("vertical", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:70 _vertical_kernel",
                      lambda: sgm_cuda.vertical(C, P1, P2, True, bound),
                      lambda: sgm_cuda.vertical_plain(C, P1, P2, True),
                      3 * vol, n * (6 * 8 + 4), 5))
    vols.append(check("horizontal", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:143 _horizontal_kernel",
                      lambda: sgm_cuda.horizontal(C, P1, P2, False, bound),
                      lambda: sgm_cuda.horizontal_plain(C, P1, P2, False),
                      2 * vol, n * 8, 10))
    rl = sgm_cuda.horizontal(C, P1, P2, True, bound)
    if max_abs_err(rl, sgm_cuda.horizontal_plain(C, P1, P2, True)) != 0:
        raise AssertionError("horizontal R->L differs from its plain form")
    vols.append(rl)
    check("wta4", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:331 _wta4_kernel",
          lambda: sgm_cuda.wta4(vols, p.uniqueness_ratio),
          lambda: sgm_cuda.wta4_plain(vols, p.uniqueness_ratio),
          4 * vol + B * H * Wv * (5 * 4 + 1), n * 10, 10)
    return rows


def phase_small_pipeline(dev) -> None:
    h, w, b = 240, 320, 2
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(b)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    p = PARAMS._replace(num_disparities=64)
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device=dev)
    d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device="cpu")
    if not torch.equal(d_gpu.cpu(), d_cpu):
        raise AssertionError("CUDA and CPU disparities differ at 240x320")
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
    print(f"pipeline 240x320 D=64 B=2: CUDA == CPU (valid share {float((d_cpu > -1).float().mean()):.4f})",
          flush=True)


def phase_main_path(dev, rows: list[dict]) -> dict:
    maps, Q = rig(H, W)
    frames = [scene(seed=s) for s in range(B)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    wrappers = {"cost": cost_cuda.cost_volume, "vertical": sgm_cuda.vertical,
                "horizontal": sgm_cuda.horizontal, "wta4": sgm_cuda.wta4}
    for fn in wrappers.values():
        fn.launches = 0
    disp, pts = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm", params=PARAMS, device=dev)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    print("main path launches:", json.dumps(counts), flush=True)
    for row in rows:
        row["launches"] = counts[row["name"]]
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")

    d = disp.cpu().numpy()
    pz = pts[..., 2].cpu().numpy()
    if d.shape != (B, H, W) or pts.shape != (B, H, W, 3) or not np.isfinite(d).all():
        raise AssertionError(f"bad output: disparity {d.shape}, points {tuple(pts.shape)}")
    valid_share, within1 = quality(d, scene_truth(H, W), PARAMS.min_disparity + D)
    good = d > 0
    if not np.isfinite(pz[good]).all():
        raise AssertionError("non-finite depth at a positive disparity")
    print(f"main path quality: valid share {valid_share:.4f} (floor {VALID_FLOOR}), "
          f"within 1 px {within1:.4f} (floor {WITHIN1_FLOOR})", flush=True)
    if valid_share < VALID_FLOOR or within1 < WITHIN1_FLOOR:
        raise AssertionError("main path quality below its floor")

    reps = 3
    lt, rt = torch.from_numpy(lb).to(dev), torch.from_numpy(rb).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm", params=PARAMS, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    return dict(ms_per_call=ms, frames_per_call=B, mpx_per_s=B * H * W / ms / 1e3,
                frames_per_s=B / ms * 1e3, valid_share=valid_share, within1_share=within1)


def phase_breakdown(dev) -> dict:
    """CUDA-event ms of each stage of one 4-frame main-path call."""
    maps, Q = rig(H, W)
    mx, my = (torch.from_numpy(m).to(dev) for m in maps[:2])
    Qt = torch.from_numpy(Q).to(dev)
    frames = [scene(seed=s) for s in range(B)]
    lt = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    rt = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    p = PARAMS
    minX1 = p.min_disparity + D
    st = {}

    def stage(name, fn):
        out = fn()  # warm-up
        st[name] = event_ms(fn, 1)
        return out

    li = stage("remap", lambda: torch.round(remap_bilinear(lt.float(), mx, my)).to(torch.int32))
    ri = torch.round(remap_bilinear(rt.float(), mx, my)).to(torch.int32)
    C = stage("cost", lambda: cost_cuda.cost_volume(li, ri, ndisp=D, block_size=p.block_size, ftzero=p.ftzero,
                                                    x_offset=minX1))
    vols = list(stage("vertical", lambda: sgm_cuda.vertical(C, p.P1, p.P2, True, p.cost_bound)))
    vols += [stage("horizontal x2", lambda: (sgm_cuda.horizontal(C, p.P1, p.P2, False, p.cost_bound),
                                             sgm_cuda.horizontal(C, p.P1, p.P2, True, p.cost_bound)))]
    vols = vols[:2] + list(vols[2])
    minS, best, sm, s0, sp, uok = stage("wta4", lambda: sgm_cuda.wta4(vols, p.uniqueness_ratio))
    disp = stage("subpixel", lambda: subpixel_disp16(best, sm, s0, sp, D).float() / 16.0)
    fail = stage("lr_check (plain)", lambda: lr_fail(minS, best, disp, W=W, min_x=minX1, ndisp=D, mindisp=0,
                                                     max_diff=p.disp12_max_diff))
    full = torch.full((B, H, W), -1.0, device=dev)
    full[..., minX1:] = torch.where(uok & ~fail, disp, -1.0)
    out = stage("speckle (plain)", lambda: speckle_filter(full, 2.0, 100, -1.0))
    stage("reproject", lambda: reproject_disparity_to_3d(out, Qt))
    return {k: round(v, 4) for k, v in st.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports) or 'nothing (already built)'}", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", file=sys.stderr)

    rows = phase_kernels(dev)
    torch.cuda.empty_cache()
    phase_small_pipeline(dev)
    e2e = phase_main_path(dev, rows)
    print(f"main path 1280x720 D={D} B={B}: {e2e['ms_per_call']:.2f} ms per call, "
          f"{e2e['mpx_per_s']:.2f} Mpx/s, {e2e['frames_per_s']:.2f} frames/s on {card}", flush=True)
    breakdown = phase_breakdown(dev)
    print("breakdown ms per 4-frame call:", json.dumps(breakdown), flush=True)
    print(json.dumps({"card": card, "main_path": e2e}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
