"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Run from the repository root:  python3 chip_smoke.py

Phases, in order (any failure raises and the script exits nonzero):
  1. print the card's name and power limit (nvidia-smi);
  2. build every csrc/*.cu with nvcc for sm_90a (one process per source);
  3. per exact-path kernel, at the main path's shapes (1280x720, D=128,
     4 frames): the CUDA wrapper against its plain PyTorch form on the
     card, exact equality; CUDA-event times of both and the kernel's
     bound; the unpacked LR kernel also at min_disparity 16, ndisp 64;
  4. the pipeline at 240x320, D=64, 2 frames on CUDA and on the CPU:
     disparity exactly equal, points within float32 rtol 1e-6;
  5. the main path, batched_stereo_pipeline(matcher="sgbm") at 1280x720,
     4 frames, the bench's exact8 parameters: every kernel's launch count
     (cost, vertical, horizontal, wta4, LR, speckle) must move; valid share
     and within-1px share against the scene's true disparity must clear
     floors; ms per 4-frame call and Mpx/s, plus a per-stage breakdown;
     one more call recorded (see 7) gives the LR and speckle kernels'
     arguments, on which each is held to its plain form (S=100, uncapped);
  6. the hier main path, batched_stereo_pipeline(matcher="sgbm_hier") at
     1280x720, 32 frames, HIER4_FAST with the bench's p3 parameters: every
     hier kernel's launch count must move; the same quality floors; ms per
     32-frame call, Mpx/s and frames/s;
  7. two more such calls with their stages recorded (CUDA events around
     the path's own functions, swapped for recording wrappers): the first
     gives the per-stage breakdown, the second keeps the arguments each
     kernel wrapper was given;
  8. per hier kernel (downsample, banded cost, vertical, horizontal, wta,
     LR check, speckle cap 4) on those arguments, at the three levels of
     the path (coarse 180x320 K=32, mid 360x640 K=8, full 720x1280 K=4):
     the kernel on all 32 frames against its plain form on the first 4,
     exact; a 6-stat WTA case at K=16; CUDA-event times (kernel at 32
     frames, plain at 4) and bounds;
  9. the hier4x8 main path: the same with num_paths=8 (the full level
     runs the diagonal vertical kernel, both horizontals and a 4-volume
     WTA): launch counts, floors, ms per call, a recorded breakdown, and
     every hier kernel on the arguments of a recorded call against its
     plain form as in 8 (one row each in the kernels line); the diagonal
     kernel also on per-pixel random shift maps (deltas 0, +-G, +-2G and
     beyond);
 10. batched_stereo_pipeline(matcher="sgbm_hier") at 64x256, D=128,
     32 frames (HIER4_FAST) on CUDA and on the CPU, at 3 paths, at
     StereoSGBMParams() (8 paths) and at 8 paths with the bench's speckle
     and LR settings: disparity exactly equal, points within float32
     rtol 1e-6;
 11. the bench's agreement gate: hier4x3 and hier4x8 (32 copies of a scene
     per call) against exact8 on the first frame of three scenes, >= 0.98
     each;
 12. the exact8 main path with sgm_cuda._FUSED_RL_WTA set (the R->L scan
     fused with the WTA): launch counts (horizontal_rl_wta 1, wta4 0), its
     disparity equal to the unfused call's, the fused kernel on a recorded
     call's arguments against its plain form, and ms per call of both forms
     in turns (unfused, fused, fused, unfused);
 13. aggregate_8 (the aggregate_8_pallas sites) at 8 and 4 paths and
     wta_stats (wta_stats_pallas) on one 1280x720, D=128 exact8 cost volume
     against their plain forms, exact, then one counted two-stage call
     (aggregate_8, then wta_stats) whose maps must equal sgm_reduce's;
 14. the BM kernel against its plain form at BASELINE config #1 (640x480,
     StereoBMParams()) and at min_disparity 16; the BM pipeline at 240x320,
     2 frames, on CUDA and on the CPU: disparity exactly equal;
 15. the BM main path, batched_stereo_pipeline(matcher="bm") at 1920x1080,
     8 frames, D=128, block 5 (`stream --matcher bm` at BASELINE config #5):
     the BM kernel's launch count (1), valid and within-1px floors, ms per
     call, Mpx/s and frames/s; two recorded calls: the stage breakdown
     (remap + round, prefilter, kernel, paste, reproject), then the kernel
     on the call's arguments (8 frames) against its plain form (2 frames).
Between 9 and 10 (numbers by the order they were added):
 16. geometry: stereo_rectify and init_undistort_rectify_map of a distorted
     1920x1080 rig (alpha -1 and 0, float64) on the card and on the CPU,
     R1/R2/P1/P2/Q within rtol 1e-9 and the maps within 1e-3 px, and 10^5
     synthetic matches triangulated on both;
 17. the hier16x3 main path: batched_stereo_pipeline(matcher="sgbm_hier") at
     1280x720, 8 frames (seeds 0-7; HIER_FAST, picked by batch size, with
     p3), its maps and Q from stereo_rectify + init_undistort_rectify_map
     of an undistorted parallel rig on the card. Unfused (launch counts,
     floors, ms per call, a recorded breakdown, every kernel on a recorded
     call's arguments), then with hier._FUSED_STATS set: the fused WTA
     (#19) launches once and the 6-stat WTA only at the coarse level, the
     disparity equals the unfused one, the fused kernel on a recorded
     call's arguments against its plain form; ms per call of both forms in
     turns (unfused, fused, fused, unfused);
 18. the per-frame stereo_sgbm_hier at 64x256 on the card and on the CPU
     (HIER_FAST, HIER4_FAST, coarse_stride 2), exact, and the strided banded
     cost kernel at the hier16x3 coarse shape against its plain form.
Phase 11 also gates hier16x3, unfused and fused (8 copies a call): hier4x3
and both hier16x3 forms must equal BENCH_r05.json's per-scene values.
After 18:
 19. the banded horizontal scan (#18) on per-pixel random shift maps at every
     band it takes (K = 4, 8, ..., 64), int16 and int32, both directions,
     exact against its plain form; its int16 and int32 forms timed at the
     hier16x3 full level's shape, and on fewer frames at K=16 and K=4;
 20. settings the card once refused, CUDA against CPU, exact: the exact
     pipeline at 240x320 at block 11 with 8 paths (int32 volumes) and at
     min_disparity -8, and the per-frame stereo_sgbm_hier at band 12.
Every row of the kernels line names the storage type its volumes ran in
("storage"; null for a kernel without a volume) and its ms per level of the
path ("ms_by_level"); every main path stores int16.
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

from stereo_vision_tpu_torch import _build, ops
from stereo_vision_tpu_torch.ops.remap import remap_bilinear
from stereo_vision_tpu_torch.parallel import streaming
from stereo_vision_tpu_torch.parallel.streaming import batched_stereo_pipeline
from stereo_vision_tpu_torch.stereo import banded_cuda, bm, bm_cuda, cost_cuda, hier, lr_cuda, sgbm, sgm_cuda, speckle_cuda
from stereo_vision_tpu_torch.stereo.bm import StereoBMParams
from stereo_vision_tpu_torch.stereo.depth import reproject_disparity_to_3d
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, stereo_sgbm, subpixel_disp16
from stereo_vision_tpu_torch.synth.scenes import agreement, scene, scene_occ, scene_truth

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
SOURCES = {name: f"stereo_vision_tpu_torch/csrc/{name}.cu"
           for name in ("cost", "sgm", "banded", "lr", "speckle", "bm")}
# The hier main path: bench.py's hier4x3 mode (HIER4_FAST with p3, 32 frames
# per call, bench.py:162-188).
HIER_P, HP = 32, hier.HIER4_FAST
P3 = PARAMS._replace(num_paths=3)
P8 = PARAMS  # hier4x8: the same parameters at num_paths=8
PLAIN_FRAMES = 4  # frames the plain forms run on beside the 32-frame kernel calls
# The BM main path: `stream --matcher bm`'s defaults (D 128, block 5, windows
# of 8 frames; stereo_vision_tpu/pipeline/cli.py:292, 311-314) at BASELINE
# config #5's 1080p; the other StereoBMParams at their defaults.
BM_H, BM_W, BM_B = 1080, 1920, 8
BM_PARAMS = StereoBMParams(num_disparities=128, block_size=5)
BM_PLAIN_FRAMES = 2  # frames the plain form runs on beside the 8-frame kernel call
# Floors for the ramp+box scene, from a CPU run of the plain forms at 240x480
# with these parameters and rig() maps (valid 0.8739, within-1px 0.9089 over
# the window centres that see the full disparity range), lowered by a margin.
BM_VALID_FLOOR, BM_WITHIN1_FLOOR = 0.80, 0.85
# BENCH_r05.json's agreement against exact8 (the round-5 run of bench.py), per scene.
BENCH_R05_AGREEMENT = {"hier4x3": {"rampbox": 0.9952, "occl": 0.9966, "jump110": 0.9923},
                       "hier16x3": {"rampbox": 0.9953, "occl": 0.9974, "jump110": 0.9935}}
# The hier16x3 path: bench.py's hier16x3 mode (HIER_FAST with p3, 8 frames a
# call, bench.py:185-186), which matcher="sgbm_hier" picks for 8 frames.
H16_P, H16_HP = 8, hier.HIER_FAST
# The distorted 1920x1080 rig of tests/test_rectify_remap.py.
RIG_K1 = np.array([[1400.0, 0, 960], [0, 1410.0, 540], [0, 0, 1]])
RIG_K2 = np.array([[1390.0, 0, 955], [0, 1402.0, 545], [0, 0, 1]])
RIG_D1 = np.array([-0.28, 0.09, 1.2e-3, -8e-4, -0.012])
RIG_D2 = np.array([-0.25, 0.07, -9e-4, 6e-4, -0.010])
RIG_RVEC, RIG_T, RIG_SIZE = [0.02, -0.35, 0.015], [-3500.0, 25.0, 120.0], (1920, 1080)
GEOMETRY_MATCHES = 100_000  # synthetic matches triangulated on the card and on the CPU
# The kernels checked on recorded main-path arguments: wrapper, source, the
# TPU kernel it replaces. banded_vertical_diag is banded_vertical called with
# with_diagonals=True.
KERNELS = {
    "downsample_box": (banded_cuda.downsample_box, SOURCES["banded"],
                       "stereo_vision_tpu/stereo/banded_pallas.py:395 _downsample_kernel"),
    "banded_cost": (banded_cuda.banded_cost, SOURCES["banded"],
                    "stereo_vision_tpu/stereo/banded_pallas.py:152 _pix_kernel + :512 _aligned_box_kernel_srows"),
    "banded_vertical": (banded_cuda.banded_vertical, SOURCES["banded"],
                        "stereo_vision_tpu/stereo/banded_pallas.py:666 _vert_kernel"),
    "banded_horizontal": (banded_cuda.banded_horizontal, SOURCES["banded"],
                          "stereo_vision_tpu/stereo/banded_pallas.py:759 _horiz_kernel"),
    "banded_wta": (banded_cuda.banded_wta, SOURCES["banded"],
                   "stereo_vision_tpu/stereo/banded_pallas.py:815 _wta_kernel"),
    "lr_fail_packed": (lr_cuda.lr_fail_packed, SOURCES["lr"], "stereo_vision_tpu/stereo/lr_pallas.py:30 _lr_kernel"),
    "speckle_filter": (speckle_cuda.speckle_filter, SOURCES["speckle"],
                       "stereo_vision_tpu/stereo/speckle_pallas.py:81 _speckle_kernel"),
    "lr_fail": (lr_cuda.lr_fail, SOURCES["lr"],
                "stereo_vision_tpu/stereo/lr_pallas.py:30 _lr_kernel (lr_fail_pallas:137)"),
    "banded_vertical_diag": (banded_cuda.banded_vertical, "stereo_vision_tpu_torch/csrc/banded_diag.cuh",
                             "stereo_vision_tpu/stereo/banded_pallas.py:666 _vert_kernel (with_diag)"),
    "horizontal_rl_wta": (sgm_cuda.horizontal_rl_wta, SOURCES["sgm"],
                          "stereo_vision_tpu/stereo/sgm_pallas.py:538 _horizontal_rl_wta_kernel:360"),
    "bm_disparity": (bm_cuda.bm_disparity, SOURCES["bm"],
                     "stereo_vision_tpu/stereo/bm_pallas.py:183 bm_stats_pallas:135 (_bm_kernel:27)"),
    "banded_wta_fused": (banded_cuda.banded_wta_fused, SOURCES["banded"],
                         "stereo_vision_tpu/stereo/banded_pallas.py:1204 _wta_fused_kernel:888"),
}
HIER_KERNEL_NAMES = ("downsample_box", "banded_cost", "banded_vertical", "banded_horizontal", "banded_wta",
                     "lr_fail_packed", "speckle_filter")
RECORDED_HIER_KERNELS = HIER_KERNEL_NAMES + ("banded_wta_fused",)
# Each kernel's plain form, called with the wrapper's arguments.
PLAIN = {
    "downsample_box": banded_cuda.downsample_box_plain,
    "banded_cost": banded_cuda.banded_cost_plain,
    "banded_vertical": lambda C, s, G, P1, P2, *, cost_bound, with_diagonals=False:
        banded_cuda.vertical_plain(C, s, G, P1, P2, with_diagonals),
    "banded_horizontal": lambda C, s, G, P1, P2, *, cost_bound, reverse=False:
        banded_cuda.horizontal_plain(C, s, G, P1, P2, reverse),
    "banded_wta": banded_cuda.banded_wta_plain,
    "lr_fail_packed": lr_cuda.lr_fail_packed_plain,
    "speckle_filter": speckle_cuda.speckle_filter_plain,
    "lr_fail": sgbm.lr_fail,
    "horizontal_rl_wta": sgm_cuda.horizontal_rl_wta_plain,
    "bm_disparity": bm.valid_disparity_plain,
    "banded_wta_fused": lambda volumes, s, uniq, **_: banded_cuda.banded_wta_fused_plain(volumes, s, uniq),
}
PLAIN["banded_vertical_diag"] = PLAIN["banded_vertical"]


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


def max_abs_err(out, ref) -> float:
    """Largest |out - ref| over the tensors, in float64 (exact for the
    int32 maps and volumes and for float32 disparities)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) for a, b in zip(outs, refs))


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def host_ms(fn, reps: int = 3) -> float:
    """Host-clock ms per call of ``fn()`` over ``reps`` calls ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_kernel(name, src, replaces, kern, plain, nbytes, nops, reps: int, path: str, storage=None):
    """``kern()`` against ``plain()``: exact, same shapes. Then CUDA-event ms
    of both (``reps`` kernel runs, one plain run) and the bound. Returns a
    kernels-line row (launches 0 until a path's count is read) and the
    kernel's output. ``storage``: the dtype of the kernel's volumes (None: it
    has none)."""
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    outs, refs = (out if isinstance(out, tuple) else (out,)), (ref if isinstance(ref, tuple) else (ref,))
    err = max_abs_err(outs, refs)
    if err != 0 or len(outs) != len(refs) or any(a.shape != b.shape for a, b in zip(outs, refs)):
        raise AssertionError(f"{name} ({path}): kernel differs from its plain form (max abs err {err})")
    del ref, refs
    ms, plain_ms = event_ms(kern, reps), event_ms(plain, 1)
    b_ms, b_by = bound_ms(nbytes, nops)
    print(f"kernel {name} ({path}): exact, {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by})",
          flush=True)
    storage = None if storage is None else str(storage).removeprefix("torch.")
    return dict(name=name, route="cuda", source=src, replaces=replaces, launches=0, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, path=path, storage=storage,
                ms_by_level={path: ms}), out


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
    st = sgm_cuda.storage_dtype(bound, P2, 3)  # what the main path stores
    if st != torch.int16:
        raise AssertionError(f"the exact8 main path would store {st}, not int16")
    rows = []

    def check(name, src, replaces, kern, plain, nbytes, nops, reps, storage=None):
        row, out = check_kernel(name, src, replaces, kern, plain, nbytes, nops, reps, "exact8", storage)
        rows.append(row)
        return out

    # Operation counts per element, 32-bit integer ops: BT cost of two
    # channels (2 x 9) + shift/add (2) + separable box (2 (bs-1)); one SGM
    # direction step ~8 (3 min, 2 add, add/sub, min-reduce); WTA ~10.
    C = check("cost", SOURCES["cost"], "stereo_vision_tpu/stereo/cost_pallas.py:107 _cost_kernel",
              lambda: cost_cuda.cost_volume(left, right, **ckw),
              lambda: cost_cuda.cost_volume_plain(left, right, **ckw),
              2 * B * H * W * 4 + vol, n * (20 + 2 * (p.block_size - 1)), 10, st)
    vols = list(check("vertical", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:70 _vertical_kernel",
                      lambda: sgm_cuda.vertical(C, P1, P2, True, bound),
                      lambda: sgm_cuda.vertical_plain(C, P1, P2, True),
                      3 * vol, n * (6 * 8 + 4), 5, st))
    vols.append(check("horizontal", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:143 _horizontal_kernel",
                      lambda: sgm_cuda.horizontal(C, P1, P2, False, bound),
                      lambda: sgm_cuda.horizontal_plain(C, P1, P2, False),
                      2 * vol, n * 8, 10, st))
    rl = sgm_cuda.horizontal(C, P1, P2, True, bound)
    if max_abs_err(rl, sgm_cuda.horizontal_plain(C, P1, P2, True)) != 0:
        raise AssertionError("horizontal R->L differs from its plain form")
    vols.append(rl)
    check("wta4", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:331 _wta4_kernel",
          lambda: sgm_cuda.wta4(vols, p.uniqueness_ratio),
          lambda: sgm_cuda.wta4_plain(vols, p.uniqueness_ratio),
          4 * vol + B * H * Wv * (5 * 4 + 1), n * 10, 10, st)

    # The unpacked LR kernel at min_disparity 16, ndisp 64 (the main path runs
    # min_disparity 0; it is checked on the path's own arguments later).
    rng = np.random.default_rng(16)
    nd, md = 64, 16
    shape = (B, H, W - nd - md)
    best = rng.integers(0, nd, shape)
    disp = (best * 16 + rng.integers(-8, 9, shape)) / 16.0 + md
    disp[rng.random(shape) < 0.05] = md - 1
    minS, best, disp = (torch.from_numpy(a).to(dev) for a in (rng.integers(0, 60, shape).astype(np.int32),
                                                               best.astype(np.int32), disp.astype(np.float32)))
    kw = dict(W=W, min_x=nd + md, ndisp=nd, mindisp=md, max_diff=1)
    out, ref = lr_cuda.lr_fail(minS, best, disp, **kw), sgbm.lr_fail(minS, best, disp, **kw)
    if not torch.equal(out, ref) or not ref.any():
        raise AssertionError("lr_fail at min_disparity 16 differs from its plain form")
    print(f"kernel lr_fail min_disparity {md}, ndisp {nd}, {B}x{H}x{shape[-1]}: exact", flush=True)
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


def phase_main_path(dev, rows: list[dict]) -> tuple[dict, dict, torch.Tensor]:
    maps, Q = rig(H, W)
    frames = [scene(seed=s) for s in range(B)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    wrappers = {"cost": cost_cuda.cost_volume, "vertical": sgm_cuda.vertical, "horizontal": sgm_cuda.horizontal,
                "wta4": sgm_cuda.wta4, "lr_fail": lr_cuda.lr_fail, "speckle_filter": speckle_cuda.speckle_filter}
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

    lt, rt = torch.from_numpy(lb).to(dev), torch.from_numpy(rb).to(dev)
    ms = host_ms(lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm", params=PARAMS, device=dev))
    return dict(ms_per_call=ms, frames_per_call=B, mpx_per_s=B * H * W / ms / 1e3,
                frames_per_s=B / ms * 1e3, valid_share=valid_share, within1_share=within1), counts, disp


def record_exact_call(dev, disp_main: torch.Tensor) -> list[dict]:
    """One more exact main-path call with the LR and speckle kernels'
    arguments recorded; its disparity must equal the main path's."""
    maps, Q = rig(H, W)
    frames = [scene(seed=s) for s in range(B)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    targets = {"lr_fail": (lr_cuda, "lr_fail"), "speckle_filter": (sgbm, "speckle_filter")}
    with Recorder(targets, ("exact8",), keep=True) as rec:
        disp, _ = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm", params=PARAMS, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(disp, disp_main):
        raise AssertionError("the recorded exact call differs from the main path")
    return rec.calls


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
    fail = stage("lr_check", lambda: lr_cuda.lr_fail(minS, best, disp, W=W, min_x=minX1, ndisp=D, mindisp=0,
                                                     max_diff=p.disp12_max_diff))
    full = torch.full((B, H, W), -1.0, device=dev)
    full[..., minX1:] = torch.where(uok & ~fail, disp, -1.0)
    out = stage("speckle", lambda: speckle_cuda.speckle_filter(full, 2.0, 100, -1.0))
    stage("reproject", lambda: reproject_disparity_to_3d(out, Qt))
    return {k: round(v, 4) for k, v in st.items()}


def hier_frames(dev):
    """The hier main path's 32 frames (ramp+box scene, seeds 0-31), on the card."""
    frames = [scene(seed=s) for s in range(HIER_P)]
    return (torch.from_numpy(np.stack([f[0] for f in frames])).to(dev),
            torch.from_numpy(np.stack([f[1] for f in frames])).to(dev))


class Recorder:
    """Swaps functions of the port's modules for wrappers that record each
    call's arguments, result and CUDA events around it, for one real call
    of the path; restores the functions on exit. ``targets`` maps a stage
    name to (module, attribute). The first downsample or banded core call
    after a level's core (``core``) starts the next level, so every record
    carries the level it ran in. With ``keep`` False a record holds no
    tensor, so that the caching allocator reuses memory as in an
    unrecorded call."""

    def __init__(self, targets: dict, levels: tuple[str, ...], keep: bool):
        self.targets, self.levels, self.keep, self.calls = targets, levels, keep, []
        self.level, self.core_done = 0, False

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            if name in ("downsample_box", "core") and self.core_done:
                self.level, self.core_done = self.level + 1, False
            level = self.levels[self.level]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.core_done |= name == "core"
            self.calls.append(dict(name=name, level=level, fn=fn, start=start, end=end))
            if self.keep:
                self.calls[-1].update(args=args, kwargs=kwargs, out=out)
            return out

        # The wrapped kernel wrappers count their launches on the name they are
        # bound to, which is this wrapper while it is swapped in.
        for k, v in vars(fn).items():
            if isinstance(v, int):
                setattr(wrapper, k, 0)
        return wrapper

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr)) for mod, attr in self.targets.values()]
        for (name, (mod, attr)), (_, _, fn) in zip(self.targets.items(), self.saved):
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def record_hier_call(dev, lt, rt, disp_main: torch.Tensor, keep: bool, params: StereoSGBMParams = P3,
                     maps_q=None, levels=("coarse", "mid", "full")) -> tuple[dict, list[dict]]:
    """One hier main-path call with its stages recorded: the per-stage
    CUDA-event ms (summed per stage and level) and the records of every
    kernel wrapper's calls, with (``keep``) the arguments the kernel checks
    reuse. The call's disparity must equal the main path's. ``maps_q``:
    the (maps, Q) of the call (default: :func:`rig`)."""
    maps, Q = maps_q or rig(H, W)
    targets = {
        "matcher": (streaming, "stereo_sgbm_hier_batch"), "reproject": (streaming, "reproject_disparity_to_3d"),
        "downsample_box": (hier, "downsample_box"), "core": (hier, "banded_stats_pack"),
        "shift maps (plain)": (hier, "shift_map"), "splice (plain)": (hier, "_splice_coarse"),
        "assemble (plain, with the LR kernel)": (hier, "_assemble_disparity"),
        "assemble fused (plain, with the LR kernel)": (hier, "_assemble_fused"),
        "lr_fail_packed": (hier, "lr_fail_packed"), "speckle_filter": (hier, "speckle_filter"),
        **{k: (banded_cuda, k) for k in ("banded_cost", "banded_vertical", "banded_horizontal", "banded_wta",
                                         "banded_wta_fused")},
    }
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with Recorder(targets, levels, keep) as rec:
        start.record()
        disp, _ = batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm_hier", params=params, device=dev)
        end.record()
    torch.cuda.synchronize()
    if not torch.equal(disp, disp_main):
        raise AssertionError("the recorded hier call differs from the main path")
    st = {"call": start.elapsed_time(end)}
    for c in rec.calls:
        key = f"{c['level']} {c['name']}" if c["name"] in RECORDED_HIER_KERNELS + ("core",) else c["name"]
        st[key] = st.get(key, 0.0) + c["start"].elapsed_time(c["end"])
    matcher = next(c for c in rec.calls if c["name"] == "matcher")
    st["remap + round (with the maps' upload)"] = start.elapsed_time(matcher["start"])
    return {k: round(v, 4) for k, v in st.items()}, [c for c in rec.calls if c["name"] in RECORDED_HIER_KERNELS]


def _head(x, n: int):
    """The first n frames of every tensor in x (tensors, lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        return x[:n]
    if isinstance(x, (list, tuple)):
        return type(x)(_head(e, n) for e in x)
    if isinstance(x, dict):
        return {k: _head(v, n) for k, v in x.items()}
    return x


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(e) for e in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _ops(name: str, args, kwargs, elems: int) -> int:
    """32-bit operations of one kernel call (``elems``: its first output's
    elements): BM ~8 per (valid pixel, disparity) (an absolute difference,
    vertical and horizontal running sums, min and argmin), the fused R->L
    scan + WTA ~21 per (pixel, disparity), banded cost ~20 + 4 bs per lane,
    a scan step ~10 per lane and carry (two directions; three carries each
    with diagonals), WTA ~10
    per lane, LR ~20 per pixel, downsample one add per input pixel, speckle
    ~30 per pixel: uncapped it is cv2.filterSpeckles, which a union-find
    labelling computes in O(1) work a pixel, and the capped form is held to
    the same count, which can only lower its bound (the round-by-round
    design's own work and state traffic grow with R; PERF.md has them)."""
    if name == "banded_cost":
        return elems * (20 + 4 * kwargs["block_size"])
    if name == "banded_vertical":
        return 2 * elems * 10
    if name == "banded_vertical_diag":
        return 6 * elems * 10
    if name == "speckle_filter":
        return elems * 30
    if name in ("banded_wta", "banded_wta_fused"):
        return args[0][0].numel() * 10
    if name == "downsample_box":
        return args[0].numel()
    if name == "horizontal_rl_wta":  # per (pixel, d): scan step ~8, three adds, WTA ~10
        return args[0].numel() * 21
    if name == "bm_disparity":  # per (valid pixel, d), with running sums both ways
        return elems * kwargs["ndisp"] * 8
    return elems * (20 if name in ("lr_fail_packed", "lr_fail") else 10)


def _storage(name: str, args, out) -> torch.dtype | None:
    """The dtype a kernel call's volumes are stored in (None: it has none)."""
    if name in ("banded_cost", "cost"):
        return out.dtype
    if name in ("banded_vertical", "banded_vertical_diag", "banded_horizontal", "horizontal_rl_wta"):
        return args[0].dtype
    if name in ("banded_wta", "banded_wta_fused"):
        return args[0][0].dtype
    return None


def _kernel_name(call: dict) -> str:
    """A record's kernel: banded_vertical with diagonals is its own kernel."""
    if call["name"] == "banded_vertical" and call["kwargs"].get("with_diagonals"):
        return "banded_vertical_diag"
    return call["name"]


def phase_recorded_kernels(records: list[dict], counts: dict, n: int, path: str) -> list[dict]:
    """Each kernel on the arguments a recorded main-path call gave it: the
    kernel on all frames against its plain form on the first ``n``, exact;
    kernel ms, plain ms and bound summed over the call's launches. Bound:
    the bytes of every input and output once over the HBM rate, or the
    operations (:func:`_ops`) over the peak rate. One row per kernel, with
    the launches of the main path's run (``counts``), the storage type of its
    volumes (int16 on every main path) and its ms per level."""
    acc = {}
    for c in records:
        name, fn, args, kwargs = _kernel_name(c), c["fn"], c["args"], c["kwargs"]
        plain = PLAIN[name]
        out, ref = fn(*args, **kwargs), plain(*_head(args, n), **_head(kwargs, n))
        torch.cuda.synchronize()
        outs, refs = (out if isinstance(out, tuple) else (out,)), (ref if isinstance(ref, tuple) else (ref,))
        head = _head(outs, n)
        err = max_abs_err(head, refs)
        if err != 0 or len(head) != len(refs) or any(a.shape != b.shape for a, b in zip(head, refs)):
            raise AssertionError(f"{name} ({c['level']}): kernel differs from its plain form (max abs err {err})")
        if not all(torch.equal(a, b) for a, b in zip(outs, c["out"] if isinstance(c["out"], tuple) else (c["out"],))):
            raise AssertionError(f"{name} ({c['level']}): a second launch differs from the main path's")
        ms = event_ms(lambda: fn(*args, **kwargs), 5)
        plain_ms = event_ms(lambda: plain(*_head(args, n), **_head(kwargs, n)), 1)
        nbytes = _nbytes(args) + _nbytes(kwargs) + _nbytes(outs)
        nops = _ops(name, args, kwargs, outs[0].numel())
        storage = _storage(name, args, outs[0])
        if storage not in (None, torch.int16):
            raise AssertionError(f"{name} ({c['level']}) ran in {storage} on the {path} main path, not int16")
        a = acc.setdefault(name, dict(ms=0.0, plain_ms=0.0, nbytes=0.0, nops=0.0, frames=outs[0].shape[0],
                                      storage=storage, levels={}))
        a["levels"][c["level"]] = a["levels"].get(c["level"], 0.0) + ms
        a["ms"] += ms
        a["plain_ms"] += plain_ms
        a["nbytes"] += nbytes
        a["nops"] += nops
        print(f"kernel {name} {c['level']}: exact, {ms:.3f} ms at {outs[0].shape[0]} frames "
              f"(plain {plain_ms:.3f} ms at {n} frames, bound {bound_ms(nbytes, nops)[0]:.3f} ms)", flush=True)

    rows = []
    for name, a in acc.items():
        b_ms, b_by = bound_ms(a["nbytes"], a["nops"])
        src, replaces = KERNELS[name][1:]
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces, launches=counts[name],
                         max_abs_err=0, ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, path=path, frames=a["frames"], plain_frames=n,
                         storage=None if a["storage"] is None else str(a["storage"]).removeprefix("torch."),
                         ms_by_level=a["levels"]))
    return rows


def check_wta16(records: list[dict]) -> None:
    """The 6-stat WTA at K=16 (HIER_FAST's and HierParams()'s full-res form),
    on 4 frames of the full level's images; on no timed path."""
    full = next(c for c in records if c["name"] == "banded_cost" and c["level"] == "full")
    l, r, s = _head(full["args"], PLAIN_FRAMES)
    p, mx = P3, full["kwargs"]["min_x"]
    kw = dict(full["kwargs"], band=16, G=8)
    s16 = torch.div(s, 8, rounding_mode="floor").mul(8).clamp(max=p.num_disparities - 16)
    C16 = banded_cuda.banded_cost(l, r, s16, **kw)
    sv = s16[:, :, mx:].contiguous()
    v16 = list(banded_cuda.banded_vertical(C16, sv, 8, p.P1, p.P2, cost_bound=p.cost_bound))
    v16.append(banded_cuda.banded_horizontal(C16, sv, 8, p.P1, p.P2, cost_bound=p.cost_bound))
    err = max_abs_err(banded_cuda.banded_wta(v16, p.uniqueness_ratio),
                      banded_cuda.banded_wta_plain(v16, p.uniqueness_ratio))
    if err != 0:
        raise AssertionError(f"banded_wta 6-stat K=16 differs from its plain form (max abs err {err})")
    print("kernel banded_wta 6-stat K=16 (4 frames, 720x1152): exact", flush=True)


def check_diag_random(dev) -> None:
    """The diagonal vertical kernel on per-pixel random shift maps (deltas
    0, +-G, +-2G and beyond, on the G grid and off it): at the full level's
    shape (K=4, G=2, where +-2G resets) and at K=8, G=2 (where +-2G shifts)."""
    p = P8
    for K, G, P, h in ((4, 2, PLAIN_FRAMES, H), (8, 2, 2, 64)):
        rng = np.random.default_rng(K)
        Wv = W - D
        C = torch.from_numpy(rng.integers(0, p.cost_bound + 1, (P, h, Wv, K)).astype(np.int16)).to(dev)
        s = rng.integers(0, 6, (P, h, Wv)) * G + (rng.random((P, h, Wv)) < 0.1) * rng.integers(1, 3, (P, h, Wv))
        s = torch.from_numpy(s.astype(np.int32)).to(dev)
        out = banded_cuda.banded_vertical(C, s, G, p.P1, p.P2, cost_bound=p.cost_bound, with_diagonals=True)
        ref = banded_cuda.vertical_plain(C, s, G, p.P1, p.P2, True)
        err = max_abs_err(out, ref)
        if err != 0:
            raise AssertionError(f"banded_vertical_diag K={K} on random shift maps: max abs err {err}")
        print(f"kernel banded_vertical_diag K={K} G={G}, {P}x{h}x{Wv}, per-pixel random shifts: exact", flush=True)


def phase_hier_small_pipeline(dev) -> None:
    """CUDA == CPU for the hier pipeline at 64x256, 32 frames: the bench's
    p3 (3 paths), StereoSGBMParams() (8 paths; no LR, no speckle) and the
    bench's parameters at 8 paths."""
    h, w = 64, 256
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(HIER_P)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    for label, params in (("p3", P3), ("StereoSGBMParams()", StereoSGBMParams()), ("p3 at 8 paths", P8)):
        d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=params, device=dev)
        d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=params, device="cpu")
        if not torch.equal(d_gpu.cpu(), d_cpu):
            raise AssertionError(f"CUDA and CPU hier disparities differ at 64x256 ({label})")
        torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
        print(f"hier pipeline 64x256 D=128 P=32, {label}: CUDA == CPU "
              f"(valid share {float((d_cpu > -1).float().mean()):.4f})", flush=True)


def phase_hier_main_path(dev, lt, rt, params: StereoSGBMParams, label: str, maps_q=None,
                         names: tuple[str, ...] = HIER_KERNEL_NAMES) -> tuple[dict, dict, torch.Tensor]:
    """One hier main-path call of ``lt.shape[0]`` frames with the counts of
    the kernels ``names`` set to 0 before it and read after it (each must
    have launched), its output's shape and quality floors, then ms per call
    over 3 calls. ``maps_q``: the (maps, Q) of the call (default: :func:`rig`)."""
    maps, Q = maps_q or rig(H, W)
    P = lt.shape[0]
    wrappers = {name: KERNELS[name][0] for name in names}
    for fn in wrappers.values():
        fn.launches = 0
    banded_cuda.banded_vertical.diagonal_launches = 0
    disp, pts = batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm_hier", params=params, device=dev)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    if params.num_paths == 8:  # banded_vertical counts both kernels: split them
        counts["banded_vertical_diag"] = banded_cuda.banded_vertical.diagonal_launches
        counts["banded_vertical"] -= counts["banded_vertical_diag"]
    print(f"{label} main path launches:", json.dumps(counts), flush=True)
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the {label} main path never launched: {counts}")

    d = disp.cpu().numpy()
    if d.shape != (P, H, W) or pts.shape != (P, H, W, 3) or not np.isfinite(d).all():
        raise AssertionError(f"bad {label} output: disparity {d.shape}, points {tuple(pts.shape)}")
    if not np.isfinite(pts[..., 2].cpu().numpy()[d > 0]).all():
        raise AssertionError("non-finite depth at a positive disparity")
    valid_share, within1 = quality(d, scene_truth(H, W), D)
    print(f"{label} main path quality: valid share {valid_share:.4f} (floor {VALID_FLOOR}), "
          f"within 1 px {within1:.4f} (floor {WITHIN1_FLOOR})", flush=True)
    if valid_share < VALID_FLOOR or within1 < WITHIN1_FLOOR:
        raise AssertionError(f"{label} main path quality below its floor")

    ms = host_ms(lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm_hier", params=params, device=dev))
    print(f"{label} main path 1280x720 D={D} P={P}: {ms:.2f} ms per call, {P * H * W / ms / 1e3:.2f} "
          f"Mpx/s, {P / ms * 1e3:.2f} frames/s", flush=True)
    return dict(ms_per_call=ms, frames_per_call=P, mpx_per_s=P * H * W / ms / 1e3,
                frames_per_s=P / ms * 1e3, valid_share=valid_share, within1_share=within1), counts, disp


def phase_agreement(dev) -> dict:
    """bench.py's gate: hier4x3 and hier4x8 (32 copies per call) and
    hier16x3 (8 copies, unfused and with ``hier._FUSED_STATS`` set) against
    exact8 on the first frame of each scene, straight to the matchers (no
    remap). hier4x3 and both hier16x3 forms must equal BENCH_r05.json's
    values to its four decimals."""
    scenes = {"rampbox": scene(0), "occl": scene_occ(2), "jump110": scene(3, box_disp=110.0)}
    modes = {"hier4x3": (P3, HP, HIER_P, False), "hier4x8": (P8, HP, HIER_P, False),
             "hier16x3": (P3, H16_HP, H16_P, False), "hier16x3 fused": (P3, H16_HP, H16_P, True)}
    out = {mode: {} for mode in modes}
    prev = hier._FUSED_STATS
    try:
        for name, (l, r) in scenes.items():
            lt, rt = torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev)
            exact = stereo_sgbm(lt[None], rt[None], PARAMS)[0].cpu().numpy()
            for mode, (params, hp, n, fused) in modes.items():
                hier._FUSED_STATS = fused
                disp = hier.stereo_sgbm_hier_batch(lt.expand(n, -1, -1), rt.expand(n, -1, -1), params, hp)[0]
                out[mode][name] = agreement(disp.cpu().numpy(), exact)
            print(f"agreement vs exact8, {name}: " + ", ".join(f"{m} {a[name]:.4f}" for m, a in out.items())
                  + f" (BENCH_r05.json hier4x3 {BENCH_R05_AGREEMENT['hier4x3'][name]}, hier16x3 "
                  f"{BENCH_R05_AGREEMENT['hier16x3'][name]})", flush=True)
    finally:
        hier._FUSED_STATS = prev
    for mode, agree in out.items():
        if min(agree.values()) < 0.98:
            raise AssertionError(f"{mode} agreement below the bench gate 0.98: {agree}")
        want = BENCH_R05_AGREEMENT.get(mode.split()[0]) if mode != "hier4x8" else None
        if want and {k: round(v, 4) for k, v in agree.items()} != want:
            raise AssertionError(f"{mode} agreement {agree} differs from BENCH_r05.json's {want}")
    return out


def phase_fused_rl(dev, disp_main: torch.Tensor) -> tuple[dict, list[dict]]:
    """The exact8 main path with ``sgm_cuda._FUSED_RL_WTA`` set: its launch
    counts, its disparity against the unfused main path's, the fused kernel
    on a recorded call's arguments against its plain form, and ms per call
    of both forms in turns (5 calls each, frames on the card as in
    :func:`phase_main_path`'s timing). The flag is restored."""
    maps, Q = rig(H, W)
    frames = [scene(seed=s) for s in range(B)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    run = lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="sgbm", params=PARAMS, device=dev)
    wrappers = {"vertical": sgm_cuda.vertical, "horizontal": sgm_cuda.horizontal, "wta4": sgm_cuda.wta4,
                "horizontal_rl_wta": sgm_cuda.horizontal_rl_wta}
    prev = sgm_cuda._FUSED_RL_WTA
    try:
        sgm_cuda._FUSED_RL_WTA = True
        for fn in wrappers.values():
            fn.launches = 0
        disp, _ = run()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in wrappers.items()}
        print("exact8 fused main path launches:", json.dumps(counts), flush=True)
        if counts["horizontal_rl_wta"] != 1 or counts["horizontal"] != 1 or counts["wta4"] != 0:
            raise AssertionError(f"the fused exact8 call did not take the fused R->L kernel: {counts}")
        if not torch.equal(disp.cpu(), disp_main):
            raise AssertionError("the fused exact8 disparity differs from the unfused one")
        with Recorder({"horizontal_rl_wta": (sgm_cuda, "horizontal_rl_wta")}, ("exact8 fused",), keep=True) as rec:
            run()
        rows = phase_recorded_kernels(rec.calls, counts, B, "exact8 fused")
        del rec
        torch.cuda.empty_cache()
        timings = {"unfused": [], "fused": []}
        for fused in (False, True, True, False):
            sgm_cuda._FUSED_RL_WTA = fused
            timings["fused" if fused else "unfused"].append(host_ms(run, reps=5))
    finally:
        sgm_cuda._FUSED_RL_WTA = prev
    out = {k: sum(v) / len(v) for k, v in timings.items()}
    print(f"exact8 ms per {B}-frame call: unfused {timings['unfused']}, fused {timings['fused']}", flush=True)
    return {**out, "runs": timings}, rows


def phase_sgm_sites(dev) -> tuple[dict, list[dict]]:
    """aggregate_8 (8 and 4 paths) and wta_stats on one 1280x720, D=128
    exact8 cost volume, each against its plain form, exact; then one
    two-stage call (aggregate_8 then wta_stats) with the counts set to 0
    before it, whose maps must equal sgm_reduce's. The 4-path row goes to
    the summary: the two-stage call runs 8 paths."""
    left, right = (torch.from_numpy(a)[None].to(dev) for a in scene(seed=0))
    p = PARAMS
    C = cost_cuda.cost_volume(left, right, ndisp=D, block_size=p.block_size, ftzero=p.ftzero, x_offset=D)
    n = C.numel()
    agg = {}
    for paths in (8, 4):
        # Bytes: the int16 cost in, the int32 volume out; operations: ~8 a
        # direction step and the adds of the directions, per element.
        agg[paths], _ = check_kernel(
            "aggregate_8", SOURCES["sgm"], "stereo_vision_tpu/stereo/sgm_pallas.py:202 + :240 aggregate_8_pallas:171 "
            "(_vertical_kernel:70, _horizontal_kernel:143)",
            lambda: sgm_cuda.aggregate_8(C, p.P1, p.P2, paths, cost_bound=p.cost_bound),
            lambda: sgm_cuda._aggregate_8(C, p.P1, p.P2, paths), n * 6, n * (9 * paths - 1), 3, f"{paths} paths",
            C.dtype)
        torch.cuda.empty_cache()
    S = sgm_cuda.aggregate_8(C, p.P1, p.P2, 8, cost_bound=p.cost_bound)
    wta, _ = check_kernel("wta_stats", SOURCES["sgm"],
                          "stereo_vision_tpu/stereo/sgm_pallas.py:320 wta_stats_pallas:296 (_wta_kernel:265)",
                          lambda: sgm_cuda.wta_stats(S, p.uniqueness_ratio),
                          lambda: sgm_cuda.wta_scan(S, D, p.uniqueness_ratio), n * 4 + (n // D) * (5 * 4 + 1),
                          n * 10, 10, "two-stage", S.dtype)
    del S
    rows = [dict(agg[8], path="two-stage"), wta]

    counted = (sgm_cuda.aggregate_8, sgm_cuda.wta_stats)
    for fn in counted:
        fn.launches = 0
    maps = sgm_cuda.wta_stats(sgm_cuda.aggregate_8(C, p.P1, p.P2, 8, cost_bound=p.cost_bound), p.uniqueness_ratio)
    torch.cuda.synchronize()
    counts = {"aggregate_8": counted[0].launches, "wta_stats": counted[1].launches}
    print("two-stage reduce launches:", json.dumps(counts), flush=True)
    for row in rows:
        row["launches"] = counts[row["name"]]
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the two-stage reduce never launched: {counts}")
    fused = sgm_cuda.sgm_reduce(C, p.P1, p.P2, p.uniqueness_ratio, cost_bound=p.cost_bound)
    if not all(torch.equal(a, b) for a, b in zip(maps, fused)):
        raise AssertionError("the two-stage reduce differs from sgm_reduce")
    print("two-stage reduce (aggregate_8, wta_stats) == sgm_reduce", flush=True)
    return {"aggregate_8 (4 paths)": {k: agg[4][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}, rows


def check_bm_kernel(dev) -> dict:
    """The BM kernel against its plain form on one 640x480 frame: BASELINE
    config #1 (StereoBMParams(): D 64, block 15) and min_disparity 16."""
    out = {}
    for label, p in (("bm480", StereoBMParams()), ("bm480 min_disparity 16", StereoBMParams(min_disparity=16))):
        lp, rp = (bm.prefilter_xsobel(torch.from_numpy(a)[None].to(dev), p.prefilter_cap)
                  for a in scene(seed=0, H=480, W=640))
        kw = dict(ndisp=p.num_disparities, mindisp=p.min_disparity, block_size=p.block_size, cap=p.prefilter_cap,
                  uniq=p.uniqueness_ratio, tex_thr=p.texture_threshold)
        npix = (480 - p.block_size + 1) * (640 - p.block_size + 1)
        row, res = check_kernel("bm_disparity", SOURCES["bm"], KERNELS["bm_disparity"][2],
                                lambda: bm_cuda.bm_disparity(lp, rp, **kw),
                                lambda: bm.valid_disparity_plain(lp, rp, **kw), 2 * lp.numel() * 4 + npix * 4,
                                npix * p.num_disparities * 8, 10, label)
        out[label] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        out[label]["valid_share"] = float((res > p.min_disparity - 1).float().mean())
    return out


def phase_bm_small_pipeline(dev) -> None:
    h, w, b = 240, 320, 2
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(b)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    p = StereoBMParams()
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="bm", params=p, device=dev)
    d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="bm", params=p, device="cpu")
    if not torch.equal(d_gpu.cpu(), d_cpu):
        raise AssertionError("CUDA and CPU BM disparities differ at 240x320")
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
    print(f"bm pipeline 240x320 StereoBMParams() B=2: CUDA == CPU "
          f"(valid share {float((d_cpu > -1).float().mean()):.4f})", flush=True)


def phase_bm_main_path(dev, lt, rt) -> tuple[dict, dict, torch.Tensor]:
    maps, Q = rig(BM_H, BM_W)
    bm_cuda.bm_disparity.launches = 0
    disp, pts = batched_stereo_pipeline(lt, rt, maps, Q, matcher="bm", params=BM_PARAMS, device=dev)
    torch.cuda.synchronize()
    counts = {"bm_disparity": bm_cuda.bm_disparity.launches}
    print("bm1080 main path launches:", json.dumps(counts), flush=True)
    if counts["bm_disparity"] != 1:
        raise AssertionError(f"the BM main path launched its kernel {counts['bm_disparity']} times, not once")
    d = disp.cpu().numpy()
    if d.shape != (BM_B, BM_H, BM_W) or pts.shape != (BM_B, BM_H, BM_W, 3) or not np.isfinite(d).all():
        raise AssertionError(f"bad bm output: disparity {d.shape}, points {tuple(pts.shape)}")
    if not np.isfinite(pts[..., 2].cpu().numpy()[d > 0]).all():
        raise AssertionError("non-finite depth at a positive disparity")
    # Over the window centres that see the full disparity range.
    r = BM_PARAMS.block_size // 2
    valid_share, within1 = quality(d[:, r : BM_H - r], scene_truth(BM_H, BM_W)[r : BM_H - r],
                                   r + BM_PARAMS.min_disparity + BM_PARAMS.num_disparities - 1)
    print(f"bm1080 main path quality: valid share {valid_share:.4f} (floor {BM_VALID_FLOOR}), "
          f"within 1 px {within1:.4f} (floor {BM_WITHIN1_FLOOR})", flush=True)
    if valid_share < BM_VALID_FLOOR or within1 < BM_WITHIN1_FLOOR:
        raise AssertionError("bm1080 main path quality below its floor")
    ms = host_ms(lambda: batched_stereo_pipeline(lt, rt, maps, Q, matcher="bm", params=BM_PARAMS, device=dev))
    px = BM_B * BM_H * BM_W
    print(f"bm1080 main path {BM_W}x{BM_H} D={BM_PARAMS.num_disparities} block {BM_PARAMS.block_size} B={BM_B}: "
          f"{ms:.2f} ms per call, {px / ms / 1e3:.2f} Mpx/s, {BM_B / ms * 1e3:.2f} frames/s", flush=True)
    return dict(ms_per_call=ms, frames_per_call=BM_B, mpx_per_s=px / ms / 1e3, frames_per_s=BM_B / ms * 1e3,
                valid_share=valid_share, within1_share=within1), counts, disp


def record_bm_call(dev, lt, rt, disp_main: torch.Tensor, keep: bool) -> tuple[dict, list[dict]]:
    """One BM main-path call with its stages recorded: CUDA-event ms of
    remap + round, prefilter (both views), the kernel, the paste (the
    matcher less the two) and reproject, and the kernel call's record."""
    maps, Q = rig(BM_H, BM_W)
    targets = {"matcher": (streaming, "stereo_bm"), "reproject": (streaming, "reproject_disparity_to_3d"),
               "prefilter": (bm, "prefilter_xsobel"), "bm_disparity": (bm_cuda, "bm_disparity")}
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with Recorder(targets, ("bm1080",), keep) as rec:
        start.record()
        disp, _ = batched_stereo_pipeline(lt, rt, maps, Q, matcher="bm", params=BM_PARAMS, device=dev)
        end.record()
    torch.cuda.synchronize()
    if not torch.equal(disp, disp_main):
        raise AssertionError("the recorded BM call differs from the main path")
    st = {"call": start.elapsed_time(end)}
    for c in rec.calls:
        st[c["name"]] = st.get(c["name"], 0.0) + c["start"].elapsed_time(c["end"])
    matcher = next(c for c in rec.calls if c["name"] == "matcher")
    st["remap + round (with the maps' upload)"] = start.elapsed_time(matcher["start"])
    st["paste (matcher less prefilter and kernel)"] = st["matcher"] - st["prefilter"] - st["bm_disparity"]
    return {k: round(v, 4) for k, v in st.items()}, [c for c in rec.calls if c["name"] == "bm_disparity"]


def phase_geometry(dev) -> dict:
    """stereo_rectify and init_undistort_rectify_map of the distorted
    1920x1080 rig (float64, alpha -1 and 0) on the card and on the CPU:
    R1/R2/P1/P2/Q within rtol 1e-9, the float32 maps within 1e-3 px; then
    ``GEOMETRY_MATCHES`` synthetic matches triangulated on both, rtol 1e-9."""
    cpu = [torch.tensor(a, dtype=torch.float64) for a in (RIG_K1, RIG_D1, RIG_K2, RIG_D2, RIG_T)]
    R = ops.rodrigues(torch.tensor(RIG_RVEC, dtype=torch.float64))
    out = {}
    for alpha in (-1.0, 0.0):
        ref = ops.stereo_rectify(*cpu[:4], RIG_SIZE, R, cpu[4], alpha=alpha)
        res = ops.stereo_rectify(*(a.to(dev) for a in cpu[:4]), RIG_SIZE, R.to(dev), cpu[4].to(dev), alpha=alpha)
        for name, a, b in zip(ref._fields, res, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-9, msg=f"stereo_rectify {name}")
        err = 0.0
        for K, dist, Rk, Pk in ((cpu[0], cpu[1], ref.R1, ref.P1), (cpu[2], cpu[3], ref.R2, ref.P2)):
            maps = ops.init_undistort_rectify_map(K.to(dev), dist.to(dev), Rk.to(dev), Pk.to(dev), RIG_SIZE)
            for a, b in zip(maps, ops.init_undistort_rectify_map(K, dist, Rk, Pk, RIG_SIZE)):
                if a.dtype != torch.float32 or a.shape != (RIG_SIZE[1], RIG_SIZE[0]):
                    raise AssertionError(f"bad map {a.dtype} {tuple(a.shape)}")
                err = max(err, float((a.cpu() - b).abs().max()))
        if err > 1e-3:
            raise AssertionError(f"rectification maps differ by {err} px between the card and the CPU")
        out[f"maps alpha {alpha} max px err"] = err
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform([-800, -500, 1800], [800, 500, 4000], (GEOMETRY_MATCHES, 3)))
    p1, p2 = (ops.project_homogeneous(P, X) + torch.from_numpy(rng.normal(0, 0.3, (GEOMETRY_MATCHES, 2)))
              for P in (ref.P1, ref.P2))
    Xc = ops.triangulate_points(ref.P1, ref.P2, p1, p2)
    Xg = ops.triangulate_points(ref.P1.to(dev), ref.P2.to(dev), p1.to(dev), p2.to(dev))
    torch.testing.assert_close(Xg.cpu(), Xc, rtol=1e-9, atol=1e-9, msg="triangulate_points")
    out["triangulation max mm err vs truth"] = float((Xc - X).abs().max())
    print(f"geometry 1920x1080 rig: card == CPU (rtol 1e-9; maps {out}); {GEOMETRY_MATCHES} matches triangulated",
          flush=True)
    return out


def parallel_rig(h: int, w: int, dev):
    """Maps and Q of an undistorted parallel rig (K1 = K2, f = 1000 px, zero
    distortion, R = I, a 0.1 m baseline along x) through stereo_rectify and
    init_undistort_rectify_map on the card, as the stream command builds
    its maps: the rectification is the identity up to rounding, so the
    scene's true disparity survives. The maps stay on the card."""
    K = torch.tensor([[1000.0, 0, (w - 1) / 2], [0, 1000.0, (h - 1) / 2], [0, 0, 1]], dtype=torch.float64)
    zero = torch.zeros(5, dtype=torch.float64)
    eye = torch.eye(3, dtype=torch.float64)
    res = ops.stereo_rectify(K, zero, K, zero, (w, h), eye, torch.tensor([-0.1, 0.0, 0.0], dtype=torch.float64),
                             device=dev)
    if res.Q.device.type != torch.device(dev).type:
        raise AssertionError("stereo_rectify left the card")
    maps = (*ops.init_undistort_rectify_map(K, zero, res.R1, res.P1, (w, h), device=dev),
            *ops.init_undistort_rectify_map(K, zero, res.R2, res.P2, (w, h), device=dev))
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    err = max(float((m - g).abs().max()) for m, g in zip(maps, (xx, yy, xx, yy)))
    if err > 1e-3:
        raise AssertionError(f"the parallel rig's maps are {err} px off the identity")
    return maps, res.Q.to(torch.float32)


def phase_hier16(dev) -> tuple[dict, list[dict]]:
    """The hier16x3 main path (bench.py's hier16x3: 8 frames, HIER_FAST
    picked by batch size, p3) with the parallel rig's maps: unfused, then
    with ``hier._FUSED_STATS`` set (the fused WTA #19 at the full level).
    Each: launch counts (fused: banded_wta_fused 1, banded_wta 1 for the
    coarse level only), floors, ms per call; a recorded breakdown and every
    kernel on a recorded call's arguments, 8 frames against the plain form
    on ``PLAIN_FRAMES``. The two forms' disparities must be equal; then ms
    per call in turns (unfused, fused, fused, unfused; 5 calls each). The
    flag is restored."""
    maps_q = parallel_rig(H, W, dev)
    frames = [scene(seed=s) for s in range(H16_P)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    levels = ("coarse", "full")
    out, rows = {}, []
    prev = hier._FUSED_STATS
    try:
        hier._FUSED_STATS = False
        out["unfused"], counts, disp = phase_hier_main_path(dev, lt, rt, P3, "hier16x3", maps_q)
        out["unfused breakdown"], _ = record_hier_call(dev, lt, rt, disp, False, P3, maps_q, levels)
        print(f"hier16x3 breakdown ms per {H16_P}-frame call:", json.dumps(out["unfused breakdown"]), flush=True)
        _, records = record_hier_call(dev, lt, rt, disp, True, P3, maps_q, levels)
        rows += phase_recorded_kernels(records, counts, PLAIN_FRAMES, "hier16x3")
        del records
        torch.cuda.empty_cache()

        hier._FUSED_STATS = True
        out["fused"], counts, disp_f = phase_hier_main_path(dev, lt, rt, P3, "hier16x3 fused", maps_q,
                                                             RECORDED_HIER_KERNELS)
        if counts["banded_wta_fused"] != 1 or counts["banded_wta"] != 1:
            raise AssertionError(f"the fused hier16x3 call did not take the fused WTA at its full level: {counts}")
        if not torch.equal(disp_f, disp):
            raise AssertionError("the fused hier16x3 disparity differs from the unfused one")
        out["fused breakdown"], _ = record_hier_call(dev, lt, rt, disp, False, P3, maps_q, levels)
        print(f"hier16x3 fused breakdown ms per {H16_P}-frame call:", json.dumps(out["fused breakdown"]), flush=True)
        _, records = record_hier_call(dev, lt, rt, disp, True, P3, maps_q, levels)
        rows += phase_recorded_kernels([c for c in records if c["name"] == "banded_wta_fused"], counts,
                                       PLAIN_FRAMES, "hier16x3 fused")
        del records, disp_f
        torch.cuda.empty_cache()

        run = lambda: batched_stereo_pipeline(lt, rt, *maps_q, matcher="sgbm_hier", params=P3, device=dev)
        timings = {"unfused": [], "fused": []}
        for fused in (False, True, True, False):
            hier._FUSED_STATS = fused
            timings["fused" if fused else "unfused"].append(host_ms(run, reps=5))
    finally:
        hier._FUSED_STATS = prev
    out["turns"] = {**{k: sum(v) / len(v) for k, v in timings.items()}, "runs": timings}
    print(f"hier16x3 ms per {H16_P}-frame call in turns: unfused {timings['unfused']}, fused {timings['fused']}",
          flush=True)
    return out, rows


def phase_hier_per_frame(dev) -> None:
    """The per-frame stereo_sgbm_hier on the card against the CPU at 64x256
    (HIER_FAST, HIER4_FAST, HIER_FAST at coarse_stride 2 with a coarse LR
    check), exact; then the strided banded cost kernel at the hier16x3
    coarse level's shape (8 x 180x320, 16 lanes, stride 2) against its plain
    form on 2 frames, exact."""
    left, right = (torch.from_numpy(a) for a in scene(seed=1, H=64, W=256))
    for label, hp in (("HIER_FAST", hier.HIER_FAST), ("HIER4_FAST", hier.HIER4_FAST),
                      ("HIER_FAST coarse_stride 2", hier.HIER_FAST._replace(coarse_stride=2, coarse_lr=1))):
        ref = hier.stereo_sgbm_hier(left, right, P3, hp)
        got = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), P3, hp)
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"per-frame stereo_sgbm_hier ({label}) differs between the card and the CPU")
        print(f"per-frame stereo_sgbm_hier 64x256 {label}: CUDA == CPU (valid share "
              f"{float((ref > -1).float().mean()):.4f})", flush=True)
    frames = [scene(seed=s) for s in range(H16_P)]
    lc, rc = (banded_cuda.downsample_box(torch.from_numpy(np.stack([f[i] for f in frames])).to(dev).to(torch.int32),
                                         4) for i in (0, 1))
    s0 = torch.zeros_like(lc)
    kw = dict(band=16, G=8, ndisp=D // 4, ftzero=P3.ftzero, block_size=P3.block_size, min_x=D // 4, stride=2)
    err = max_abs_err(_head(banded_cuda.banded_cost(lc, rc, s0, **kw), 2),
                      banded_cuda.banded_cost_plain(lc[:2], rc[:2], s0[:2], **kw))
    if err != 0:
        raise AssertionError(f"the strided banded cost kernel differs from its plain form (max abs err {err})")
    print(f"kernel banded_cost stride 2 ({H16_P}x{lc.shape[1]}x{lc.shape[2]}, K=16): exact", flush=True)


def phase_horizontal_bands(dev) -> dict:
    """The banded horizontal scan (#18) on per-pixel random shift maps at
    every band it takes (K = 4, 8, ..., 64; G varying with K), int16 and
    int32, both directions, against its plain form on the card, exact. Rows
    that leave a warp's last groups empty and columns that leave the last
    prefetched chunk short are in the shape. Then ms and bounds at the full
    level's shape (720 rows x 1152 columns, a shift map constant on 4-px
    tiles): K=16 int16 and int32 at hier16x3's 8 frames and int16 on 1
    frame, K=4 at hier4x3's 32 frames and on 4 (how the time grows with the
    rows)."""
    P, h, Wv = 2, 9, 203
    P1, P2 = P3.P1, P3.P2
    for K in range(4, 65, 4):
        G = K // 2 if (K // 4) % 2 else K // 4
        rng = np.random.default_rng(K)
        s = rng.integers(0, 6, (P, h, Wv)) * G + (rng.random((P, h, Wv)) < 0.1) * rng.integers(1, 3, (P, h, Wv))
        s = torch.from_numpy(s.astype(np.int32)).to(dev)
        for dtype, bound in ((torch.int16, 2325), (torch.int32, 40000)):
            C = torch.from_numpy(rng.integers(0, bound + 1, (P, h, Wv, K))).to(dtype).to(dev)
            for rev in (False, True):
                out = banded_cuda.banded_horizontal(C, s, G, P1, P2, cost_bound=bound, reverse=rev)
                err = max_abs_err(out, banded_cuda.horizontal_plain(C, s, G, P1, P2, rev))
                if out.dtype != dtype or err != 0:
                    raise AssertionError(f"banded_horizontal K={K} G={G} {dtype} reverse={rev}: {out.dtype}, "
                                         f"max abs err {err}")
    print(f"kernel banded_horizontal K=4..64, int16 and int32, both directions, {P}x{h}x{Wv}, per-pixel random "
          "shifts: exact", flush=True)
    out = {}
    Wf = W - D
    for K, G, dtype, frames in ((16, 8, torch.int16, H16_P), (16, 8, torch.int32, H16_P), (16, 8, torch.int16, 1),
                                (4, 2, torch.int16, HIER_P), (4, 2, torch.int16, 4)):
        rng = np.random.default_rng(K)
        tiles = rng.integers(0, (D - K) // G + 1, (frames, H // 4, Wf // 4)) * G
        s = torch.from_numpy(np.repeat(np.repeat(tiles, 4, 1), 4, 2).astype(np.int32)).to(dev)
        bound = P3.cost_bound if dtype == torch.int16 else 40000
        C = torch.randint(0, bound + 1, (frames, H, Wf, K), device=dev, dtype=torch.int32).to(dtype)
        ms = event_ms(lambda: banded_cuda.banded_horizontal(C, s, G, P1, P2, cost_bound=bound), 10)
        b_ms, b_by = bound_ms(2 * C.numel() * C.element_size() + s.numel() * 4, C.numel() * 10)
        out[f"K={K} {str(dtype).removeprefix('torch.')} {frames} frames"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
        del C, s
    print(f"banded_horizontal at {H} rows x {Wf} columns, 4-px tiles: {json.dumps(out)}", flush=True)
    return out


def phase_settings(dev) -> dict:
    """Settings the card once refused, CUDA against CPU, exact: the exact
    pipeline at 240x320, D=64, 2 frames at block 11 with 8 paths (whose
    direction sums leave int16) and at min_disparity -8 (no LR check: the
    reference asserts min_disparity >= 0 there), points within float32
    rtol 1e-6; then the per-frame stereo_sgbm_hier at band 12 (64x256)."""
    h, w, b = 240, 320, 2
    maps, Q = rig(h, w)
    frames = [scene(seed=s, H=h, W=w) for s in range(b)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    out = {}
    cases = {"block 11, 8 paths": PARAMS._replace(num_disparities=64, block_size=11),
             "min_disparity -8": PARAMS._replace(num_disparities=64, min_disparity=-8, disp12_max_diff=-1)}
    for label, p in cases.items():
        storage = sgm_cuda.storage_dtype(p.cost_bound, p.P2, 3)
        n = cost_cuda.cost_volume.launches
        d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device=dev)
        d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device="cpu")
        if cost_cuda.cost_volume.launches != n + 1 or not torch.equal(d_gpu.cpu(), d_cpu):
            raise AssertionError(f"CUDA and CPU disparities differ at 240x320 ({label})")
        torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
        valid = float((d_cpu > p.min_disparity - 1).float().mean())
        out[label] = dict(storage=str(storage).removeprefix("torch."), valid_share=valid)
        print(f"pipeline 240x320 D=64 B=2, {label}: CUDA == CPU ({storage}, valid share {valid:.4f})", flush=True)
    if out["block 11, 8 paths"]["storage"] != "int32":
        raise AssertionError("block 11 at 8 paths did not take the int32 kernels")
    left, right = (torch.from_numpy(a) for a in scene(seed=1, H=64, W=256))
    hp = hier.HierParams(band=12, granularity=4)
    ref = hier.stereo_sgbm_hier(left, right, P3, hp)
    n = banded_cuda.banded_horizontal.launches
    got = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), P3, hp)
    if banded_cuda.banded_horizontal.launches == n or not torch.equal(got.cpu(), ref):
        raise AssertionError("per-frame stereo_sgbm_hier at band 12 differs between the card and the CPU")
    out["hier band 12 valid share"] = float((ref > -1).float().mean())
    print(f"per-frame stereo_sgbm_hier 64x256 band 12: CUDA == CPU (valid share "
          f"{out['hier band 12 valid share']:.4f})", flush=True)
    return out


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
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  {name}: {line.strip()}", file=sys.stderr)

    rows = phase_kernels(dev)
    torch.cuda.empty_cache()
    phase_small_pipeline(dev)
    e2e, counts, disp = phase_main_path(dev, rows)
    print(f"main path 1280x720 D={D} B={B}: {e2e['ms_per_call']:.2f} ms per call, "
          f"{e2e['mpx_per_s']:.2f} Mpx/s, {e2e['frames_per_s']:.2f} frames/s on {card}", flush=True)
    rows += phase_recorded_kernels(record_exact_call(dev, disp), counts, B, "exact8")
    breakdown = phase_breakdown(dev)
    print("breakdown ms per 4-frame call:", json.dumps(breakdown), flush=True)
    disp_exact = disp.cpu()  # the fused R->L phase compares with it later
    del disp
    torch.cuda.empty_cache()

    lt, rt = hier_frames(dev)
    hier_e2e, counts, hier_disp = phase_hier_main_path(dev, lt, rt, P3, "hier4x3")
    hier_breakdown, _ = record_hier_call(dev, lt, rt, hier_disp, keep=False)
    _, records = record_hier_call(dev, lt, rt, hier_disp, keep=True)
    print(f"hier4x3 breakdown ms per {HIER_P}-frame call:", json.dumps(hier_breakdown), flush=True)
    rows += phase_recorded_kernels(records, counts, PLAIN_FRAMES, "hier4x3")
    check_wta16(records)
    del hier_disp, records
    torch.cuda.empty_cache()

    h8_e2e, counts, h8_disp = phase_hier_main_path(dev, lt, rt, P8, "hier4x8")
    h8_breakdown, _ = record_hier_call(dev, lt, rt, h8_disp, keep=False, params=P8)
    _, records = record_hier_call(dev, lt, rt, h8_disp, keep=True, params=P8)
    print(f"hier4x8 breakdown ms per {HIER_P}-frame call:", json.dumps(h8_breakdown), flush=True)
    rows += phase_recorded_kernels(records, counts, PLAIN_FRAMES, "hier4x8")
    del lt, rt, h8_disp, records
    torch.cuda.empty_cache()
    check_diag_random(dev)
    torch.cuda.empty_cache()

    geometry = phase_geometry(dev)
    h16, h16_rows = phase_hier16(dev)
    rows += h16_rows
    torch.cuda.empty_cache()
    phase_hier_per_frame(dev)
    torch.cuda.empty_cache()
    horizontal_bands = phase_horizontal_bands(dev)
    torch.cuda.empty_cache()
    settings = phase_settings(dev)
    torch.cuda.empty_cache()

    phase_hier_small_pipeline(dev)
    agree = phase_agreement(dev)
    torch.cuda.empty_cache()

    fused, fused_rows = phase_fused_rl(dev, disp_exact)
    rows += fused_rows
    del disp_exact
    torch.cuda.empty_cache()
    sites, site_rows = phase_sgm_sites(dev)
    rows += site_rows
    torch.cuda.empty_cache()

    bm480 = check_bm_kernel(dev)
    phase_bm_small_pipeline(dev)
    frames = [scene(seed=s, H=BM_H, W=BM_W) for s in range(BM_B)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    bm_e2e, counts, bm_disp = phase_bm_main_path(dev, lt, rt)
    bm_breakdown, _ = record_bm_call(dev, lt, rt, bm_disp, keep=False)
    print(f"bm1080 breakdown ms per {BM_B}-frame call:", json.dumps(bm_breakdown), flush=True)
    _, records = record_bm_call(dev, lt, rt, bm_disp, keep=True)
    rows += phase_recorded_kernels(records, counts, BM_PLAIN_FRAMES, "bm1080")
    del lt, rt, bm_disp, records
    torch.cuda.empty_cache()

    names = [r["name"] for r in rows]
    for r in rows:  # a kernel that runs on several paths: one row each
        if names.count(r["name"]) > 1:
            r["name"] = f"{r['name']} ({r['path']})"
    print(json.dumps({"card": card, "main_path": e2e, "breakdown": breakdown, "hier_main_path": hier_e2e,
                      "hier_breakdown": hier_breakdown, "hier4x8_main_path": h8_e2e, "hier4x8_breakdown": h8_breakdown,
                      "agreement": agree, "exact8_fused_rl_wta": fused, "sgm_sites": sites, "bm480": bm480,
                      "bm_main_path": bm_e2e, "bm_breakdown": bm_breakdown, "hier16x3": h16,
                      "geometry": geometry, "banded_horizontal_full_shape": horizontal_bands,
                      "settings": settings}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
