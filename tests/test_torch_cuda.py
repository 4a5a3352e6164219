"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Every test here needs an NVIDIA GPU with nvcc (they skip elsewhere); the
file imports neither JAX nor the JAX package, so on a machine without
them it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Exact equality throughout: every value is an integer (disparities are
k/16); the geometry ops, float64 on both sides, are held within 1e-9;
detected checkerboard corners (window sums reduced in other orders) within
5e-3 px; the two in-repo networks in IEEE float32 (TF32 off) within 1e-4
of their raw outputs' values (cuDNN and the CPU sum in other orders), the
letterbox resize bit for bit, the pose fusion and smoothing (float64)
within 1e-9.
"""

import numpy as np
import pytest
import torch

from stereo_vision_tpu_torch import calib, detect, ops, sync, track
from stereo_vision_tpu_torch.models import pretrained
from stereo_vision_tpu_torch.parallel.mesh import create_mesh
from stereo_vision_tpu_torch.parallel.streaming import StereoStreamProcessor, batched_stereo_pipeline
from stereo_vision_tpu_torch.stereo import banded_cuda, bm, bm_cuda, cost_cuda, hier, lr_cuda, sgm_cuda, speckle_cuda
from stereo_vision_tpu_torch.stereo.hier import HIER4_FAST, HIER_FAST
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, lr_fail, stereo_sgbm
from stereo_vision_tpu_torch.synth import scenes
from stereo_vision_tpu_torch.synth.boards import add_glare, add_noise, board_views, motion_blur, render_board_view
from stereo_vision_tpu_torch.synth.scenes import ball_frame, flash_streams, scene, speckle_patterns

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (B, H, W)).astype(np.int32)) for _ in range(2))


@pytest.mark.parametrize(
    "H,W,D,bs,mindisp,x_off",
    [(21, 80, 16, 5, 0, 16), (17, 70, 48, 3, 2, 50), (9, 300, 128, 11, 0, 128), (12, 100, 200, 7, 1, 0)],
)
def test_cost_kernel_matches_plain(dev, H, W, D, bs, mindisp, x_off):
    left, right = _images(D, 2, H, W)
    kw = dict(ndisp=D, mindisp=mindisp, block_size=bs, ftzero=15, x_offset=x_off)
    ref = cost_cuda.cost_volume_plain(left, right, **kw)
    n = cost_cuda.cost_volume.launches
    out = cost_cuda.cost_volume(left.to(dev), right.to(dev), **kw)
    torch.cuda.synchronize()
    assert cost_cuda.cost_volume.launches == n + 1
    assert out.dtype == torch.int16 and out.shape == ref.shape
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("D", [16, 48, 64, 128, 200])
@pytest.mark.parametrize("num_paths,uniq", [(8, 10), (4, 0), (3, 10), (2, 0)])
def test_sgm_kernels_match_plain(dev, D, num_paths, uniq):
    rng = np.random.default_rng(D + num_paths)
    C = torch.from_numpy(rng.integers(0, 2326, (2, 13, 37, D)).astype(np.int16))
    P1, P2 = 200, 800
    ref = sgm_cuda.sgm_reduce_plain(C, P1, P2, uniq, num_paths=num_paths)
    out = sgm_cuda.sgm_reduce(C.to(dev), P1, P2, uniq, cost_bound=2325, num_paths=num_paths)
    torch.cuda.synchronize()
    for name, a, b in zip(("minS", "best", "sm", "s0", "sp", "uok"), out, ref):
        assert torch.equal(a.cpu(), b), name


def test_direction_volumes_match_plain(dev):
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.integers(0, 2326, (3, 19, 29, 64)).astype(np.int16))
    Cd = C.to(dev)
    for a, b in zip(sgm_cuda.vertical(Cd, 100, 900, True, 2325), sgm_cuda.vertical_plain(C, 100, 900, True)):
        assert torch.equal(a.cpu().to(torch.int32), b)
    for rev in (False, True):
        a = sgm_cuda.horizontal(Cd, 100, 900, rev, 2325)
        assert torch.equal(a.cpu().to(torch.int32), sgm_cuda.horizontal_plain(C, 100, 900, rev))


def test_int16_bound_is_enforced(dev):
    """A bound past int16 takes the int32 form of the kernels: no refusal,
    and the volumes equal the plain form's."""
    rng = np.random.default_rng(32)
    C = torch.from_numpy(rng.integers(0, 101, (1, 4, 8, 32)).astype(np.int16))
    out = sgm_cuda.vertical(C.to(dev), 8, 32000, True, 100)
    for a, b in zip(out, sgm_cuda.vertical_plain(C, 8, 32000, True)):
        assert a.dtype == torch.int32 and torch.equal(a.cpu(), b)


def test_pipeline_cuda_matches_cpu(dev):
    H, W, B = 96, 200, 2
    left, right = scene(H=H, W=W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    mx = xx + 0.3 * np.sin(yy / 11.0)
    my = yy + 0.2 * np.cos(xx / 13.0)
    maps = (mx, my, mx - 0.1, my)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 500.0], [0, 0, 10.0, 0]], np.float32)
    p = StereoSGBMParams(num_disparities=64, uniqueness_ratio=10, disp12_max_diff=1,
                         speckle_window_size=20, speckle_range=2)
    lb, rb = np.stack([left] * B), np.stack([right] * B)
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p)
    d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device="cpu")
    assert d_gpu.device.type == "cuda"
    assert torch.equal(d_gpu.cpu(), d_cpu)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)


def _shift_map(seed, P, H, W, D, K, G, tile):
    """Random shift maps on the G grid in [0, D - K]: tile-constant for
    tile > 0 (deltas beyond +-G included), per pixel for tile == 0."""
    rng = np.random.default_rng(seed)
    if tile == 0:
        return torch.from_numpy((rng.integers(0, (D - K) // G + 1, (P, H, W)) * G).astype(np.int32))
    v = rng.integers(0, (D - K) // G + 1, (P, -(-H // tile), -(-W // tile))) * G
    return torch.from_numpy(np.repeat(np.repeat(v, tile, 1), tile, 2)[:, :H, :W].astype(np.int32))


@pytest.mark.parametrize(
    "K,G,D,min_x,tile",
    [(4, 2, 128, 128, 4), (4, 4, 16, 3, 4), (8, 4, 64, 64, 0), (16, 8, 64, 20, 8), (32, 2, 32, 32, 4),
     (64, 16, 128, 64, 8), (8, 2, 64, 10, 4)],
)
def test_banded_cost_kernel_matches_plain(dev, K, G, D, min_x, tile):
    P, H, W = 3, 13, 150
    left, right = _images(K + G, P, H, W)
    s = _shift_map(K, P, H, W, D, K, G, tile)
    kw = dict(band=K, G=G, ndisp=D, ftzero=15, block_size=5, min_x=min_x)
    ref = banded_cuda.banded_cost_plain(left, right, s, **kw)
    n = banded_cuda.banded_cost.launches
    out = banded_cuda.banded_cost(left.to(dev), right.to(dev), s.to(dev), **kw)
    torch.cuda.synchronize()
    assert banded_cuda.banded_cost.launches == n + 1
    assert out.dtype == torch.int16 and out.shape == ref.shape
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("K,G", [(4, 2), (8, 4), (16, 8), (32, 2), (64, 16), (4, 4), (8, 16)])
@pytest.mark.parametrize("tile", [4, 0])
def test_banded_scans_match_plain(dev, K, G, tile):
    P, H, Wv = 2, 11, 45
    rng = np.random.default_rng(K * 7 + tile)
    C = torch.from_numpy(rng.integers(0, 2326, (P, H, Wv, K)).astype(np.int16))
    s = _shift_map(K + tile, P, H, Wv + 5, 128, K, max(G, 1), tile)[:, :, 5:]  # a column slice, as the core passes
    P1, P2 = 200, 800
    Cd, sd = C.to(dev), s.to(dev)
    dn, up = banded_cuda.banded_vertical(Cd, sd, G, P1, P2, cost_bound=2325)
    ref_dn, ref_up = banded_cuda.vertical_plain(C, s, G, P1, P2)
    assert torch.equal(dn.cpu().to(torch.int32), ref_dn) and torch.equal(up.cpu().to(torch.int32), ref_up)
    for rev in (False, True):
        h = banded_cuda.banded_horizontal(Cd, sd, G, P1, P2, cost_bound=2325, reverse=rev)
        assert torch.equal(h.cpu().to(torch.int32), banded_cuda.horizontal_plain(C, s, G, P1, P2, rev))


@pytest.mark.parametrize("K", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("nvol,sub", [(2, True), (3, True), (4, False), (3, False)])
def test_banded_wta_matches_plain(dev, K, nvol, sub):
    rng = np.random.default_rng(K + nvol)
    vols = [torch.from_numpy(rng.integers(0, 3000, (2, 7, 33, K)).astype(np.int16)) for _ in range(nvol)]
    ref = banded_cuda.banded_wta_plain(vols, 10, sub)
    out = banded_cuda.banded_wta([v.to(dev) for v in vols], 10, sub)
    torch.cuda.synchronize()
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("num_paths", [2, 3, 4, 8])
def test_banded_stats_pack_cuda_matches_cpu(dev, num_paths):
    P, H, W, D, K, G = 2, 16, 96, 64, 8, 4
    left, right = _images(num_paths, P, H, W)
    s = _shift_map(num_paths, P, H, W, D, K, G, 4)
    p = StereoSGBMParams(num_disparities=D, uniqueness_ratio=10, num_paths=num_paths)
    for sub in (False, True):
        ref = banded_cuda.banded_stats_pack(left, right, s, p, K, G, min_x=D, sub=sub)
        out = banded_cuda.banded_stats_pack(left.to(dev), right.to(dev), s.to(dev), p, K, G, min_x=D, sub=sub)
        for a, b in zip(out, ref):
            assert torch.equal(a.cpu(), b)


def test_banded_eight_paths_raise_on_cuda(dev):
    """8 paths store the sum of three carries: a P2 that fits int16 for one
    carry but not for three takes the int32 kernels at 8 paths only, and
    both equal the CPU."""
    P, H, W, D, K, G = 1, 8, 80, 64, 8, 4
    left, right = _images(0, P, H, W)
    s = torch.zeros((P, H, W), dtype=torch.int32)
    p = StereoSGBMParams(num_disparities=D, p2=9000)
    for paths in (4, 8):
        ref = banded_cuda.banded_stats_pack(left, right, s, p._replace(num_paths=paths), K, G, D)
        out = banded_cuda.banded_stats_pack(left.to(dev), right.to(dev), s.to(dev), p._replace(num_paths=paths), K,
                                            G, D)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))


def test_hier_pipeline_cuda_matches_cpu(dev):
    H, W, B = 48, 192, 8
    frames = [scene(seed=s, H=H, W=W) for s in range(B)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (xx + 0.3 * np.sin(yy / 11.0), yy + 0.2 * np.cos(xx / 13.0), xx - 0.1, yy)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 500.0], [0, 0, 10.0, 0]], np.float32)
    p = StereoSGBMParams(num_disparities=128, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=20,
                         speckle_range=2, num_paths=4)
    n_ds, n_lr = banded_cuda.downsample_pyramid.launches, lr_cuda.lr_fail_packed.launches
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=p, hier_params=HIER_FAST)
    assert banded_cuda.downsample_pyramid.launches == n_ds + 1 and lr_cuda.lr_fail_packed.launches == n_lr + 1
    d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=p, hier_params=HIER_FAST,
                                           device="cpu")
    assert d_gpu.device.type == "cuda" and (d_cpu > -1).float().mean() > 0.2
    assert torch.equal(d_gpu.cpu(), d_cpu)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.parametrize("f,fx,H,W", [(2, None, 48, 97), (4, None, 45, 130), (4, 8, 32, 64), (3, 2, 17, 26)])
def test_downsample_kernel_matches_plain(dev, f, fx, H, W):
    img = next(_images(f * H, 3, H, W))
    img[0, :2, :4] = torch.tensor([[0, 1, 1, 2], [1, 0, 1, 2]])  # .5 ties at f=2
    ref = banded_cuda.downsample_box_plain(img, f, fx)
    n = banded_cuda.downsample_box.launches
    out = banded_cuda.downsample_box(img.to(dev), f, fx)
    torch.cuda.synchronize()
    assert banded_cuda.downsample_box.launches == n + 1
    assert out.dtype == torch.int32 and torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("H,W,ndisp,max_diff", [(40, 256, 64, 1), (7, 1280, 128, 1), (13, 100, 32, 0), (5, 96, 16, 2)])
def test_lr_kernel_matches_plain(dev, H, W, ndisp, max_diff):
    rng = np.random.default_rng(W + ndisp)
    shape = (3, H, W - ndisp)
    best = rng.integers(0, ndisp, shape)
    pack = torch.from_numpy((rng.integers(0, 60, shape) * 2048 + best).astype(np.int32))
    d16 = torch.from_numpy((best * 16 + rng.integers(-8, 9, shape)).astype(np.int32))
    kw = dict(W=W, ndisp=ndisp, max_diff=max_diff)
    ref = lr_cuda.lr_fail_packed_plain(pack, d16, **kw)
    n = lr_cuda.lr_fail_packed.launches
    out = lr_cuda.lr_fail_packed(pack.to(dev), d16.to(dev), **kw)
    torch.cuda.synchronize()
    assert lr_cuda.lr_fail_packed.launches == n + 1
    assert out.dtype == torch.bool and torch.equal(out.cpu(), ref) and ref.any()


def _speckle_maps(seed, P, H, W, kind):
    """Float32 disparity maps (invalid -1): random quantised blobs, snakes
    of one blob, single valid pixels, or one full-frame blob."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        d = rng.integers(0, 6, (P, H, W)).astype(np.float32) * 1.5
        d[rng.random(d.shape) < 0.35] = -1.0
    elif kind == "snake":
        d = np.full((P, H, W), -1.0, np.float32)
        for y in range(1, H - 1, 4):
            d[:, y, 1:-1] = 10.0
            d[:, y: y + 4, -2 if (y // 4) % 2 == 0 else 1] = 10.0
        d[:, H - 1] = -1.0
    elif kind == "single":
        d = np.full((P, H, W), -1.0, np.float32)
        d[rng.random(d.shape) < 0.2] = 7.0
    else:  # one blob filling the frame, with a few fractional steps
        d = np.full((P, H, W), 20.0) + (rng.random((P, H, W)) < 0.1) * 0.5
    return torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "snake", "single", "full"])
@pytest.mark.parametrize("S,cap", [(1, None), (8, None), (30, 1), (30, 4), (30, 8), (100, None)])
def test_speckle_kernel_matches_plain(dev, kind, S, cap):
    disp = _speckle_maps(S + len(kind), 3, 37, 150, kind)
    ref = speckle_cuda.speckle_filter_plain(disp, 2.0, S, -1.0, max_diameter=cap)
    n = speckle_cuda.speckle_filter.launches
    out = speckle_cuda.speckle_filter(disp.to(dev), 2.0, S, -1.0, max_diameter=cap)
    torch.cuda.synchronize()
    assert speckle_cuda.speckle_filter.launches == n + 1
    assert out.dtype == torch.float32 and torch.equal(out.cpu(), ref)


def test_speckle_kernel_single_frame_and_fractions(dev):
    disp = _speckle_maps(3, 1, 64, 96, "random")[0] / 16.0  # (H, W), steps of 3/32
    for md in (0.09375, 0.1):
        ref = speckle_cuda.speckle_filter_plain(disp, md, 12, -1.0 / 16.0)
        out = speckle_cuda.speckle_filter(disp.to(dev), md, 12, -1.0 / 16.0)
        assert out.shape == disp.shape and torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("H,W,ndisp,mindisp,max_diff", [(40, 256, 64, 0, 1), (7, 1280, 128, 0, 1),
                                                         (13, 200, 64, 16, 1), (5, 96, 16, 16, 0)])
def test_lr_unpacked_kernel_matches_plain(dev, H, W, ndisp, mindisp, max_diff):
    rng = np.random.default_rng(W + mindisp)
    min_x = ndisp + mindisp
    shape = (3, H, W - min_x)
    best = rng.integers(0, ndisp, shape)
    best[:, :, :2] = [0, ndisp - 1]  # edge columns at both ends of the range
    best[:, :, -2:] = [ndisp - 1, 0]
    minS = torch.from_numpy(rng.integers(0, 60, shape).astype(np.int32))
    disp = (best * 16 + rng.integers(-8, 9, shape)) / 16.0 + mindisp
    disp[rng.random(shape) < 0.05] = mindisp - 1
    best, disp = torch.from_numpy(best.astype(np.int32)), torch.from_numpy(disp.astype(np.float32))
    kw = dict(W=W, min_x=min_x, ndisp=ndisp, mindisp=mindisp, max_diff=max_diff)
    ref = lr_fail(minS, best, disp, **kw)
    n = lr_cuda.lr_fail.launches
    out = lr_cuda.lr_fail(minS.to(dev), best.to(dev), disp.to(dev), **kw)
    torch.cuda.synchronize()
    assert lr_cuda.lr_fail.launches == n + 1
    assert out.dtype == torch.bool and torch.equal(out.cpu(), ref) and ref.any()


@pytest.mark.parametrize("K,G,Wv", [(4, 2, 45), (4, 1, 1152), (8, 2, 45), (8, 4, 2100), (16, 4, 300), (32, 2, 45),
                                    (32, 8, 1000), (64, 16, 45)])
def test_banded_diagonal_vertical_matches_plain(dev, K, G, Wv):
    """Per-pixel random shift maps: deltas of 0, +-G, +-2G and beyond, on
    the G grid and off it; wide rows take several columns a thread, and
    large K * Wv the device-memory carry rows."""
    P, H = 2, 11
    P1, P2 = 200, 800
    for W in (Wv, 1, 31, 33, 1152):  # and widths across warp, block and cluster edges
        rng = np.random.default_rng(K * W + G)
        C = torch.from_numpy(rng.integers(0, 2326, (P, H, W, K)).astype(np.int16))
        s = rng.integers(0, 5, (P, H, W)) * G + (rng.random((P, H, W)) < 0.1) * rng.integers(1, 3, (P, H, W))
        s = torch.from_numpy(s.astype(np.int32))
        n, nd = banded_cuda.banded_vertical.launches, banded_cuda.banded_vertical.diagonal_launches
        dn, up = banded_cuda.banded_vertical(C.to(dev), s.to(dev), G, P1, P2, cost_bound=2325, with_diagonals=True)
        torch.cuda.synchronize()
        assert banded_cuda.banded_vertical.launches == n + 1 and banded_cuda.banded_vertical.diagonal_launches == nd + 1
        ref_dn, ref_up = banded_cuda.vertical_plain(C, s, G, P1, P2, True)
        assert dn.dtype == torch.int16
        assert torch.equal(dn.cpu().to(torch.int32), ref_dn) and torch.equal(up.cpu().to(torch.int32), ref_up)


def test_banded_diagonal_vertical_refuses_wide_rows(dev):
    """Rows wider than 4096 columns, which the first 8-path kernel refused:
    the card now equals the plain form there (the cluster form at 4097 and
    8192 columns, the strips form beyond what a cluster covers)."""
    rng = np.random.default_rng(4097)
    for Wv, form in ((4097, "cluster"), (8192, "cluster"), (20000, "strips")):
        C = torch.from_numpy(rng.integers(0, 2326, (1, 5, Wv, 4)).astype(np.int16))
        s = _random_shift_map(rng, 1, 5, Wv, 2)
        out = banded_cuda.banded_vertical(C.to(dev), s.to(dev), 2, 200, 800, cost_bound=2325, with_diagonals=True)
        assert banded_cuda.banded_vertical.plan["form"] == form
        ref = banded_cuda.vertical_plain(C, s, 2, 200, 800, True)
        assert all(torch.equal(a.cpu().to(torch.int32), r) for a, r in zip(out, ref))


def test_hier_pipeline_eight_paths_cuda_matches_cpu(dev):
    H, W, B = 48, 192, 32
    frames = [scene(seed=s, H=H, W=W) for s in range(B)]
    lb, rb = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (xx + 0.3 * np.sin(yy / 11.0), yy + 0.2 * np.cos(xx / 13.0), xx - 0.1, yy)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 500.0], [0, 0, 10.0, 0]], np.float32)
    p = StereoSGBMParams(num_disparities=128, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=100,
                         speckle_range=2)
    nd, ns = banded_cuda.banded_vertical.diagonal_launches, speckle_cuda.speckle_filter.launches
    d_gpu, _ = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=p, hier_params=HIER4_FAST)
    assert banded_cuda.banded_vertical.diagonal_launches == nd + 1 and speckle_cuda.speckle_filter.launches == ns + 1
    d_cpu, _ = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=p, hier_params=HIER4_FAST,
                                       device="cpu")
    assert (d_cpu > -1).float().mean() > 0.2 and torch.equal(d_gpu.cpu(), d_cpu)


@pytest.mark.parametrize(
    "W,D,bs,mindisp,uniq,tex",
    [(101, 16, 9, 0, 15, 10), (163, 64, 15, 0, 15, 10), (301, 128, 5, 0, 15, 10), (95, 48, 7, 16, 0, 0),
     (77, 32, 11, -4, 15, 10), (333, 200, 5, 3, 10, 5), (400, 256, 3, 0, 0, 10), (40, 64, 5, 0, 15, 10),
     (71, 1, 5, 2, 15, 10), (65, 2, 1, -1, 15, 10)],
)
def test_bm_kernel_matches_plain(dev, W, D, bs, mindisp, uniq, tex):
    """Odd widths, ranges wider than the frame, D of 1-256, negative and
    positive minimum disparities, against the plain form."""
    rng = np.random.default_rng(W + D)
    base = rng.integers(0, 256, (2, 37, W + 40))
    left, right = base[..., 20 : 20 + W], base[..., 13 : 13 + W] + rng.integers(-3, 4, (2, 37, W))
    lp, rp = (bm.prefilter_xsobel(torch.from_numpy(a.astype(np.int32))) for a in (left, right))
    kw = dict(ndisp=D, mindisp=mindisp, block_size=bs, cap=31, uniq=uniq, tex_thr=tex)
    ref = bm_cuda.bm_disparity(lp, rp, **kw)
    n = bm_cuda.bm_disparity.launches
    out = bm_cuda.bm_disparity(lp.to(dev), rp.to(dev), **kw)
    torch.cuda.synchronize()
    assert bm_cuda.bm_disparity.launches == n + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.equal(out.cpu(), ref)


def test_bm_kernel_refuses_what_it_does_not_take(dev):
    """ndisp 1040, once refused, equals the plain form (the kernel's wide
    form); int16 images are still refused."""
    left, right = _images(1040, 1, 16, 1100)
    lp, rp = bm.prefilter_xsobel(left), bm.prefilter_xsobel(right)
    kw = dict(ndisp=16, mindisp=0, block_size=5, cap=31, uniq=15, tex_thr=10)
    wide = dict(kw, ndisp=1040)
    assert torch.equal(bm_cuda.bm_disparity(lp.to(dev), rp.to(dev), **wide).cpu(),
                       bm_cuda.bm_disparity(lp, rp, **wide))
    lp = lp.to(dev)
    with pytest.raises(TypeError, match="int32"):
        bm_cuda.bm_disparity(lp.to(torch.int16), lp.to(torch.int16), **kw)


def test_bm_pipeline_cuda_matches_cpu(dev):
    H, W, B = 96, 200, 2
    left, right = scene(H=H, W=W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (xx + 0.3 * np.sin(yy / 11.0), yy + 0.2 * np.cos(xx / 13.0), xx - 0.1, yy)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 500.0], [0, 0, 10.0, 0]], np.float32)
    lb, rb = np.stack([left] * B), np.stack([right] * B)
    for p in (bm.StereoBMParams(), bm.StereoBMParams(num_disparities=128, block_size=5),
              bm.StereoBMParams(num_disparities=48, block_size=9, min_disparity=8)):
        n = bm_cuda.bm_disparity.launches
        d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="bm", params=p)
        assert bm_cuda.bm_disparity.launches == n + 1
        d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="bm", params=p, device="cpu")
        assert d_gpu.device.type == "cuda" and (d_cpu > p.min_disparity - 1).float().mean() > 0.2
        assert torch.equal(d_gpu.cpu(), d_cpu)
        torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.parametrize("D", [16, 48, 128, 200])
@pytest.mark.parametrize("num_paths", [2, 3, 4, 8])
def test_aggregate_8_matches_plain(dev, D, num_paths):
    C = torch.from_numpy(np.random.default_rng(D * num_paths).integers(0, 2326, (2, 11, 31, D)).astype(np.int16))
    ref = sgm_cuda._aggregate_8(C, 200, 800, num_paths)
    n = sgm_cuda.aggregate_8.launches
    out = sgm_cuda.aggregate_8(C.to(dev), 200, 800, num_paths, cost_bound=2325)
    torch.cuda.synchronize()
    assert sgm_cuda.aggregate_8.launches == n + 1
    assert out.dtype == torch.int32 and torch.equal(out.cpu(), ref)


def test_aggregate_8_int16_bound_is_enforced(dev):
    """8 paths store three-direction sums, so a P2 that fits one direction
    in int16 but not three takes the int32 kernels at 8 paths; both equal
    the plain form."""
    rng = np.random.default_rng(9)
    C = torch.from_numpy(rng.integers(0, 2326, (1, 4, 8, 32)).astype(np.int16))
    for paths in (4, 8):
        n = (sgm_cuda.aggregate_8.launches, sgm_cuda.vertical.launches)
        out = sgm_cuda.aggregate_8(C.to(dev), 8, 9000, paths, cost_bound=2325)
        assert (sgm_cuda.aggregate_8.launches, sgm_cuda.vertical.launches) == (n[0] + 1, n[1] + 1)
        assert torch.equal(out.cpu(), sgm_cuda._aggregate_8(C, 8, 9000, paths))


@pytest.mark.parametrize("D", [16, 48, 64, 128, 200])
@pytest.mark.parametrize("uniq", [0, 10])
def test_wta_stats_and_fused_rl_wta_match_plain(dev, D, uniq):
    rng = np.random.default_rng(D + uniq)
    C = torch.from_numpy(rng.integers(0, 2326, (2, 9, 37, D)).astype(np.int16))
    S = sgm_cuda._aggregate_8(C, 200, 800, 8)
    S[:, :, :5, D // 2] = S[:, :, :5].amin(dim=-1)  # ties
    ref = sgm_cuda.wta_scan(S, D, uniq)
    n = sgm_cuda.wta_stats.launches
    out = sgm_cuda.wta_stats(S.to(dev), uniq)
    torch.cuda.synchronize()
    assert sgm_cuda.wta_stats.launches == n + 1
    for name, a, b in zip(("minS", "best", "sm", "s0", "sp", "uok"), out, ref):
        assert torch.equal(a.cpu(), b), name

    Cd = C.to(dev)
    vols = list(sgm_cuda.vertical(Cd, 200, 800, True, 2325)) + [sgm_cuda.horizontal(Cd, 200, 800, False, 2325)]
    ref = sgm_cuda.horizontal_rl_wta_plain(C, *(v.cpu() for v in vols), 200, 800, uniq)
    n = sgm_cuda.horizontal_rl_wta.launches
    out = sgm_cuda.horizontal_rl_wta(Cd, *vols, 200, 800, uniq)
    torch.cuda.synchronize()
    assert sgm_cuda.horizontal_rl_wta.launches == n + 1
    for name, a, b in zip(("minS", "best", "sm", "s0", "sp", "uok"), out, ref):
        assert torch.equal(a.cpu(), b), name


def test_fused_rl_wta_pipeline_equals_unfused(dev, monkeypatch):
    H, W, B = 64, 200, 2
    left, right = scene(H=H, W=W)
    lb, rb = (torch.from_numpy(np.stack([a] * B)).to(dev) for a in (left, right))
    p = StereoSGBMParams(num_disparities=64, uniqueness_ratio=10, disp12_max_diff=1)
    ref = stereo_sgbm(lb, rb, p)
    monkeypatch.setattr(sgm_cuda, "_FUSED_RL_WTA", True)
    n = sgm_cuda.horizontal_rl_wta.launches
    out = stereo_sgbm(lb, rb, p)
    assert sgm_cuda.horizontal_rl_wta.launches == n + 1 and torch.equal(out, ref)


@pytest.mark.parametrize("K,G,D,stride", [(16, 8, 32, 2), (8, 4, 32, 4), (32, 16, 64, 2), (16, 8, 64, 1)])
def test_strided_banded_cost_kernel_matches_plain(dev, K, G, D, stride):
    """The coarse level's strided search (s == 0, lane k = disparity
    stride * k) and a stride-1 call of the same shapes."""
    P, H, W = 3, 13, 150
    left, right = _images(K * stride, P, H, W)
    s = torch.zeros((P, H, W), dtype=torch.int32)
    kw = dict(band=K, G=G, ndisp=D, ftzero=15, block_size=5, min_x=D, stride=stride)
    ref = banded_cuda.banded_cost_plain(left, right, s, **kw)
    out = banded_cuda.banded_cost(left.to(dev), right.to(dev), s.to(dev), **kw)
    assert out.dtype == torch.int16 and torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("nvol,tile", [(3, 4), (4, 4), (3, 0), (4, 8), (2, 0)])
def test_fused_wta_kernel_matches_plain(dev, nvol, tile):
    """Random volumes and shift maps (tile-constant or per pixel), ties
    included, up to the largest shift the pack takes."""
    P, H, Wv, K = 3, 9, 70, 16
    rng = np.random.default_rng(nvol * 10 + tile)
    vols = [torch.from_numpy(rng.integers(100, 3000, (P, H, Wv, K)).astype(np.int16)) for _ in range(nvol)]
    for v in vols:  # ties at the minimum in the first columns: the smaller k wins
        v[:, :, :4, 9] = v[:, :, :4, 5] = 0
    s = _shift_map(nvol + tile, P, H, Wv, 2040, K, 8, tile)
    s[0, 0, :3] = torch.tensor([0, 2031, 2031])  # the widest range that packs: ndisp 2047
    ref = banded_cuda.banded_wta_fused_plain(vols, s, 10)
    n = banded_cuda.banded_wta_fused.launches
    out = banded_cuda.banded_wta_fused([v.to(dev) for v in vols], s.to(dev), 10, ndisp=2047)
    torch.cuda.synchronize()
    assert banded_cuda.banded_wta_fused.launches == n + 1
    for a, b in zip(out, ref):
        assert a.dtype == torch.int32 and torch.equal(a.cpu(), b)
    assert (ref[1] >= 32768).any() and (ref[1] < 32768).any()


def test_fused_hier_batch_equals_unfused(dev, monkeypatch):
    """HIER_FAST's 8-frame batch through the fused WTA at its full level:
    one fused launch, no 6-stat WTA there, the same disparities."""
    H, W = 48, 192
    frames = [scene(seed=s, H=H, W=W) for s in range(8)]
    lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
    p = StereoSGBMParams(num_disparities=128, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=30,
                         speckle_range=2, num_paths=3)
    ref = hier.stereo_sgbm_hier_batch(lt, rt, p, HIER_FAST)
    monkeypatch.setattr(hier, "_FUSED_STATS", True)
    n, nw = banded_cuda.banded_wta_fused.launches, banded_cuda.banded_wta.launches
    out = hier.stereo_sgbm_hier_batch(lt, rt, p, HIER_FAST)
    assert banded_cuda.banded_wta_fused.launches == n + 1 and banded_cuda.banded_wta.launches == nw + 1
    assert (ref > -1).float().mean() > 0.2 and torch.equal(out, ref)


@pytest.mark.parametrize("preset", ["HIER_FAST", "HIER4_FAST", "HIER_FAST_stride2", "HierParams_stride2"])
def test_hier_per_frame_cuda_matches_cpu(dev, preset):
    """The per-frame entry: its exact coarse pass (or the strided banded
    one) and the one-frame banded core, on the card and on the CPU."""
    hp = {"HIER_FAST": HIER_FAST, "HIER4_FAST": HIER4_FAST,
          "HIER_FAST_stride2": HIER_FAST._replace(coarse_stride=2, coarse_lr=1),
          "HierParams_stride2": hier.HierParams(coarse_stride=2)}[preset]
    left, right = (torch.from_numpy(a) for a in scene(seed=1, H=64, W=256))
    p = StereoSGBMParams(num_disparities=128, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=30,
                         speckle_range=2, num_paths=3)
    ref = hier.stereo_sgbm_hier(left, right, p, hp)
    n = banded_cuda.banded_cost.launches
    out = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), p, hp)
    assert banded_cuda.banded_cost.launches > n
    assert out.device.type == "cuda" and (ref > -1).float().mean() > 0.2 and torch.equal(out.cpu(), ref)


def test_geometry_cuda_matches_cpu(dev):
    """Rectification of the distorted 1920x1080 rig, its maps and a
    triangulation, float64 on the card against the CPU."""
    K1 = np.array([[1400.0, 0, 960], [0, 1410.0, 540], [0, 0, 1]])
    K2 = np.array([[1390.0, 0, 955], [0, 1402.0, 545], [0, 0, 1]])
    D1 = np.array([-0.28, 0.09, 1.2e-3, -8e-4, -0.012])
    D2 = np.array([-0.25, 0.07, -9e-4, 6e-4, -0.010])
    args = [torch.from_numpy(a) for a in (K1, D1, K2, D2)]
    R = ops.rodrigues(torch.tensor([0.02, -0.35, 0.015], dtype=torch.float64))
    T = torch.tensor([-3500.0, 25.0, 120.0], dtype=torch.float64)
    for alpha in (-1.0, 0.0, 1.0):
        ref = ops.stereo_rectify(*args[:2], *args[2:], (1920, 1080), R, T, alpha=alpha)
        out = ops.stereo_rectify(*(a.to(dev) for a in args[:2]), *(a.to(dev) for a in args[2:]), (1920, 1080),
                                 R.to(dev), T.to(dev), alpha=alpha)
        for a, b in zip(out, ref):
            assert a.device.type == "cuda"
            torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-9)
    mx, my = ops.init_undistort_rectify_map(args[0], args[1], ref.R1, ref.P1, (1920, 1080))
    gx, gy = ops.init_undistort_rectify_map(args[0].to(dev), args[1].to(dev), ref.R1.to(dev), ref.P1.to(dev),
                                            (1920, 1080))
    torch.testing.assert_close(gx.cpu(), mx, rtol=0, atol=1e-3)
    torch.testing.assert_close(gy.cpu(), my, rtol=0, atol=1e-3)
    rng = np.random.default_rng(0)
    p1, p2 = (torch.from_numpy(rng.uniform(0, 1000, (500, 2))) for _ in range(2))
    X = ops.triangulate_points(ref.P1, ref.P2, p1, p2)
    Xg = ops.triangulate_points(ref.P1.to(dev), ref.P2.to(dev), p1.to(dev), p2.to(dev))
    torch.testing.assert_close(Xg.cpu(), X, rtol=1e-9, atol=1e-9)


# -------------------------------------------------------- storage and bands
# Settings the kernels take: int32 storage, any odd block, a negative
# min_disparity, bands K % 4 == 0 up to 64 (above: the next block); and the
# group-per-row banded horizontal scan.


def _random_shift_map(rng, P, H, W, G, levels=6):
    """Per-pixel random shift maps: deltas of 0, +-G, +-2G and beyond on the
    G grid, and off it."""
    s = rng.integers(0, levels, (P, H, W)) * G + (rng.random((P, H, W)) < 0.1) * rng.integers(1, 3, (P, H, W))
    return torch.from_numpy(s.astype(np.int32))


@pytest.mark.parametrize("K,G", [(4, 2), (8, 4), (12, 4), (16, 8), (20, 4), (32, 16), (64, 16), (12, 16)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_banded_horizontal_random_shifts_match_plain(dev, K, G, dtype):
    """The group-per-row horizontal scan, both directions, on rows that do
    not fill a warp's last groups and columns that do not fill its last
    chunk of prefetched columns."""
    P, H, Wv = 2, 11, 45
    rng = np.random.default_rng(K * 100 + G)
    C = torch.from_numpy(rng.integers(0, 2326, (P, H, Wv, K)).astype(np.int32)).to(dtype)
    s = _random_shift_map(rng, P, H, Wv, G)
    bound = 2325 if dtype == torch.int16 else 40000  # 40000 + P2 takes the int32 form
    for rev in (False, True):
        n = banded_cuda.banded_horizontal.launches
        out = banded_cuda.banded_horizontal(C.to(dev), s.to(dev), G, 200, 800, cost_bound=bound, reverse=rev)
        torch.cuda.synchronize()
        assert banded_cuda.banded_horizontal.launches == n + 1 and out.dtype == dtype
        assert torch.equal(out.cpu().to(torch.int32), banded_cuda.horizontal_plain(C, s, G, 200, 800, rev))


@pytest.mark.parametrize("K,G", [(12, 4), (20, 4), (16, 8)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_banded_vertical_and_wta_bands_match_plain(dev, K, G, dtype):
    """Bands off the powers of two (and K=16 in int32): the vertical scan
    with and without diagonals on random shift maps, and the WTA (6-stat
    and sub) over three volumes."""
    P, H, Wv = 2, 11, 300
    rng = np.random.default_rng(K + G)
    bound = 2325 if dtype == torch.int16 else 40000
    for W in (Wv, 1, 31, 33, 1152):  # and widths across warp, block and cluster edges
        C = torch.from_numpy(rng.integers(0, 2326, (P, H, W, K)).astype(np.int32)).to(dtype)
        s = _random_shift_map(rng, P, H, W, G)
        for diag in (False, True):
            out = banded_cuda.banded_vertical(C.to(dev), s.to(dev), G, 200, 800, cost_bound=bound, with_diagonals=diag)
            ref = banded_cuda.vertical_plain(C, s, G, 200, 800, diag)
            assert all(a.dtype == dtype and torch.equal(a.cpu().to(torch.int32), b) for a, b in zip(out, ref))
    C = torch.from_numpy(rng.integers(0, 2326, (P, H, Wv, K)).astype(np.int32)).to(dtype)
    vols = [torch.from_numpy(rng.integers(0, 9000, (P, H, Wv, K)).astype(np.int32)).to(dtype) for _ in range(3)]
    for v in vols:  # ties at the minimum: the smaller k wins
        v[:, :, :4, K - 3] = v[:, :, :4, 2] = 0
    for sub in (False, True):
        ref = banded_cuda.banded_wta_plain(vols, 10, sub)
        out = banded_cuda.banded_wta([v.to(dev) for v in vols], 10, sub)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))


def test_fused_wta_int32_matches_plain(dev):
    P, H, Wv, K = 2, 9, 70, 16
    rng = np.random.default_rng(5)
    vols = [torch.from_numpy(rng.integers(100, 60000, (P, H, Wv, K)).astype(np.int32)) for _ in range(3)]
    s = _shift_map(5, P, H, Wv, 128, K, 8, 4)
    ref = banded_cuda.banded_wta_fused_plain(vols, s, 10)
    out = banded_cuda.banded_wta_fused([v.to(dev) for v in vols], s.to(dev), 10, ndisp=128, volume_bound=60000)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="volume_bound"):
        banded_cuda.banded_wta_fused([v.to(dev) for v in vols], s.to(dev), 10, ndisp=128)


@pytest.mark.parametrize("H,W,D,bs,mindisp,x_off", [(21, 80, 16, 13, 0, 16), (17, 70, 48, 21, 2, 50),
                                                    (9, 300, 256, 21, 0, 256), (12, 100, 16, 5, -8, 8),
                                                    (12, 100, 32, 15, -31, 1)])
def test_cost_kernel_wide_blocks_and_negative_min_disparity(dev, H, W, D, bs, mindisp, x_off):
    """Any odd block (int32 output past int16's window bound; block 21 at
    D=256 fits the shared memory), and a negative min_disparity with the
    reference's clamp of the shift at 0."""
    left, right = _images(D + bs, 2, H, W)
    kw = dict(ndisp=D, mindisp=mindisp, block_size=bs, ftzero=15, x_offset=x_off)
    ref = cost_cuda.cost_volume(left, right, **kw)
    out = cost_cuda.cost_volume(left.to(dev), right.to(dev), **kw)
    assert out.dtype == ref.dtype == (torch.int16 if bs * bs * 93 < 1 << 15 else torch.int32)
    assert torch.equal(out.cpu(), ref)
    out32 = cost_cuda.cost_volume(left.to(dev), right.to(dev), **kw, dtype=torch.int32)
    assert out32.dtype == torch.int32 and torch.equal(out32.cpu(), ref.to(torch.int32))


@pytest.mark.parametrize("num_paths", [3, 4, 8])
def test_sgm_kernels_int32_match_plain(dev, num_paths):
    """The exact scans, WTA and fused R->L WTA in their int32 forms."""
    rng = np.random.default_rng(num_paths)
    C = torch.from_numpy(rng.integers(0, 40001, (2, 9, 37, 64)).astype(np.int32))
    ref = sgm_cuda.sgm_reduce_plain(C, 200, 800, 10, num_paths=num_paths)
    out = sgm_cuda.sgm_reduce(C.to(dev), 200, 800, 10, cost_bound=40000, num_paths=num_paths)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))
    Cd = C.to(dev)
    vols = list(sgm_cuda.vertical(Cd, 200, 800, True, 40000)) + [sgm_cuda.horizontal(Cd, 200, 800, False, 40000)]
    assert all(v.dtype == torch.int32 for v in vols)
    ref = sgm_cuda.horizontal_rl_wta_plain(C, *(v.cpu() for v in vols), 200, 800, 10)
    out = sgm_cuda.horizontal_rl_wta(Cd, *vols, 200, 800, 10)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))


@pytest.mark.parametrize("case", ["block11_8paths", "block13", "min_disparity_-8"])
def test_exact_settings_card_equals_cpu(dev, case):
    """stereo_sgbm at settings the card once refused, card against CPU."""
    p = {"block11_8paths": StereoSGBMParams(num_disparities=64, block_size=11, uniqueness_ratio=10,
                                            disp12_max_diff=1, speckle_window_size=20, speckle_range=2),
         "block13": StereoSGBMParams(num_disparities=64, block_size=13, num_paths=4, uniqueness_ratio=10),
         "min_disparity_-8": StereoSGBMParams(num_disparities=64, min_disparity=-8, uniqueness_ratio=10,
                                              speckle_window_size=20, speckle_range=2)}[case]
    left, right = (torch.from_numpy(np.stack([a] * 2)) for a in scene(seed=2, H=48, W=160))
    ref = stereo_sgbm(left, right, p)
    n = cost_cuda.cost_volume.launches
    out = stereo_sgbm(left.to(dev), right.to(dev), p)
    assert cost_cuda.cost_volume.launches == n + 1
    assert (ref > p.min_disparity - 1).float().mean() > 0.3 and torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("case", ["block11_8paths", "band12"])
def test_banded_settings_card_equals_cpu(dev, case):
    """The per-frame hier entry at block 11 with 8 paths (int32 diagonal
    sets) and at band 12, card against CPU."""
    p = StereoSGBMParams(num_disparities=128, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=30,
                         speckle_range=2, num_paths=3)
    hp = HIER_FAST
    if case == "block11_8paths":
        p = p._replace(block_size=11, num_paths=8)
    else:
        hp = hier.HierParams(band=12, granularity=4)
    left, right = (torch.from_numpy(a) for a in scene(seed=1, H=64, W=256))
    ref = hier.stereo_sgbm_hier(left, right, p, hp)
    out = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), p, hp)
    assert (ref > -1).float().mean() > 0.2 and torch.equal(out.cpu(), ref)


# ------------------------------------------- the banded cost kernel, wide bands
# The strip-walking cost kernel over its settings, and bands above 64 (K %
# 4 == 0 up to 256) through every banded kernel.


def _cost_shift_map(rng, P, H, W, D, K, G, stride, kind):
    """Per-pixel shift maps: "random" on the G grid in range with steps off
    it (deltas 0, +-G, beyond G), the edge rows and columns at the range's
    ends; "wild" any value in [-3, D + 3) (both forms clamp the disparity);
    "zero" the coarse level's s == 0."""
    if kind == "zero":
        return torch.zeros((P, H, W), dtype=torch.int32)
    if kind == "wild":
        return torch.from_numpy(rng.integers(-3, D + 3, (P, H, W)).astype(np.int32))
    top = max(D - stride * (K - 1) - 1, 0)
    s = rng.integers(0, top // G + 1, (P, H, W)) * G + (rng.random((P, H, W)) < 0.15) * rng.integers(1, 3, (P, H, W))
    s[:, 0, :] = s[:, -1, :] = top
    s[:, :, 0] = s[:, :, -1] = 0
    return torch.from_numpy(np.minimum(s, top).astype(np.int32))


@pytest.mark.parametrize("K,G,D", [(4, 2, 128), (8, 4, 64), (12, 4, 48), (16, 8, 64), (32, 16, 64), (64, 16, 128),
                                   (68, 4, 128), (128, 8, 256), (256, 8, 256)])
@pytest.mark.parametrize("bs,stride,min_x,dtype,kind", [(5, 1, -1, torch.int16, "random"),
                                                        (7, 1, 0, torch.int32, "random"),
                                                        (5, 2, 3, torch.int16, "random"),
                                                        (3, 1, 0, torch.int16, "wild"),
                                                        (1, 2, 5, torch.int32, "zero")])
def test_banded_cost_kernel_settings_match_plain(dev, K, G, D, bs, stride, min_x, dtype, kind):
    """Two strips of rows and several tiles of columns (min_x -1: D), exact."""
    P, H, W = 2, 37, D + 90
    min_x = D if min_x < 0 else min_x
    rng = np.random.default_rng(K * 10 + bs)
    left, right = _images(K + bs, P, H, W)
    s = _cost_shift_map(rng, P, H, W, D, K, G, stride, kind)
    kw = dict(band=K, G=G, ndisp=D, ftzero=15, block_size=bs, min_x=min_x, stride=stride, dtype=dtype)
    ref = banded_cuda.banded_cost_plain(left, right, s, **kw)
    n = banded_cuda.banded_cost.launches
    out = banded_cuda.banded_cost(left.to(dev), right.to(dev), s.to(dev), **kw)
    torch.cuda.synchronize()
    assert banded_cuda.banded_cost.launches == n + 1
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out.cpu(), ref)


def test_banded_cost_kernel_takes_scratch_where_no_tile_fits(dev):
    """Band 256 at block 21: one tile's ring of 21 rows of 256-lane costs
    alone passes the shared memory of a block, so the kernel keeps its rings
    in device scratch; it equals its plain form there."""
    left, right = _images(0, 1, 8, 300)
    s = torch.zeros((1, 8, 300), dtype=torch.int32)
    kw = dict(band=256, G=8, ndisp=256, block_size=21)
    ref = banded_cuda.banded_cost_plain(left, right, s, ftzero=15, min_x=0, **kw)
    out = banded_cuda.banded_cost(left.to(dev), right.to(dev), s.to(dev), **kw)
    assert out.dtype == torch.int32 and torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("K,G", [(68, 4), (128, 8), (132, 64), (256, 16)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("Wv", [45, 300])
def test_wide_band_kernels_match_plain(dev, K, G, dtype, Wv):
    """Bands above 64 (banded_wide.cu / banded_wide32.cu): the vertical scan
    with and without diagonals (carry rows in shared memory at 45 columns,
    in device scratch at 300), both horizontal directions, and the WTA in
    its 6-stat and sub forms, on per-pixel random shift maps; ties at the
    minimum included."""
    P, H = 2, 11
    rng = np.random.default_rng(K + Wv)
    C = torch.from_numpy(rng.integers(0, 2326, (P, H, Wv, K)).astype(np.int32)).to(dtype)
    s = _random_shift_map(rng, P, H, Wv, G)
    bound = 2325 if dtype == torch.int16 else 40000
    Cd, sd = C.to(dev), s.to(dev)
    for diag in (False, True):
        n = banded_cuda.banded_vertical.diagonal_launches
        out = banded_cuda.banded_vertical(Cd, sd, G, 200, 800, cost_bound=bound, with_diagonals=diag)
        ref = banded_cuda.vertical_plain(C, s, G, 200, 800, diag)
        assert banded_cuda.banded_vertical.diagonal_launches == n + int(diag)
        assert all(a.dtype == dtype and torch.equal(a.cpu().to(torch.int32), b) for a, b in zip(out, ref))
    for rev in (False, True):
        out = banded_cuda.banded_horizontal(Cd, sd, G, 200, 800, cost_bound=bound, reverse=rev)
        assert out.dtype == dtype
        assert torch.equal(out.cpu().to(torch.int32), banded_cuda.horizontal_plain(C, s, G, 200, 800, rev))
    vols = [torch.from_numpy(rng.integers(0, 9000, (P, H, Wv, K)).astype(np.int32)).to(dtype) for _ in range(4)]
    for v in vols:  # ties at the minimum: the smaller k wins
        v[:, :, :4, K - 3] = v[:, :, :4, 40] = v[:, :, :4, 2] = 0
    for nvol, sub in ((3, False), (3, True), (4, False), (2, True)):
        ref = banded_cuda.banded_wta_plain(vols[:nvol], 10, sub)
        out = banded_cuda.banded_wta([v.to(dev) for v in vols[:nvol]], 10, sub)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))


def test_hier_band_128_card_equals_cpu(dev):
    """The per-frame hier entry at band 128, D=256 (every banded kernel at a
    wide band), card against CPU."""
    p = StereoSGBMParams(num_disparities=256, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=30,
                         speckle_range=2, num_paths=3)
    hp = hier.HierParams(band=128, granularity=8)
    left, right = (torch.from_numpy(a) for a in scene(seed=6, H=32, W=320))
    ref = hier.stereo_sgbm_hier(left, right, p, hp)
    out = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), p, hp)
    assert (ref[:, 256:] > -1).float().mean() > 0.5 and torch.equal(out.cpu(), ref)


# ------------------------------------- ranges and bands above 256, speckle
# Disparity ranges and bands up to 1024 (ROADMAP C.3) through every kernel
# of the exact, banded and BM families, and the union-find speckle kernel.


@pytest.mark.parametrize("D", [320, 512, 1024, 1040, 2064])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_exact_kernels_wide_ranges_match_plain(dev, D, dtype):
    """The cost kernel and every SGM entry (vertical, both horizontals, the
    WTA, the one-volume WTA and the fused R->L WTA) at D = 320, 512, 1024,
    and above 1024 (the forms that walk the range with their carry in
    device memory)."""
    left, right = _images(D, 1, 5, D + 40)
    kw = dict(ndisp=D, block_size=3, ftzero=15, x_offset=D - 7)
    C = cost_cuda.cost_volume(left.to(dev), right.to(dev), dtype=dtype, **kw)
    assert C.dtype == dtype and torch.equal(C.cpu(), cost_cuda.cost_volume_plain(left, right, **kw).to(dtype))
    bound = 837 if dtype == torch.int16 else 40000
    Cc = C.cpu()
    vols = list(sgm_cuda.vertical(C, 200, 800, True, bound))
    for a, b in zip(vols, sgm_cuda.vertical_plain(Cc, 200, 800, True)):
        assert a.dtype == dtype and torch.equal(a.cpu().to(torch.int32), b)
    for rev in (False, True):
        vols.append(sgm_cuda.horizontal(C, 200, 800, rev, bound))
        assert torch.equal(vols[-1].cpu().to(torch.int32), sgm_cuda.horizontal_plain(Cc, 200, 800, rev))
    for v in vols:  # ties at the minimum: the smaller d wins
        v[..., :3, D - 3] = v[..., :3, 40] = v[..., :3, 2] = 0
    cpu = [v.cpu() for v in vols]
    for got, want in ((sgm_cuda.wta4(vols, 10), sgm_cuda.wta4_plain(cpu, 10)),
                      (sgm_cuda.horizontal_rl_wta(C, *vols[:3], 200, 800, 10),
                       sgm_cuda.horizontal_rl_wta_plain(Cc, *cpu[:3], 200, 800, 10)),
                      (sgm_cuda.wta_stats(sum(v.to(torch.int32) for v in vols), 10),
                       sgm_cuda.wta_scan(sum(v.to(torch.int32) for v in cpu), D, 10))):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    narrow = dict(ndisp=D + 16, block_size=5)  # a range wider than the 40-column frame
    got = cost_cuda.cost_volume(left[:, :, :40].to(dev), right[:, :, :40].to(dev), **narrow)
    assert torch.equal(got.cpu(), cost_cuda.cost_volume_plain(left[:, :, :40], right[:, :, :40], **narrow))


@pytest.mark.parametrize("D,mindisp,bs", [(320, 0, 7), (1024, 0, 7), (512, 16, 7), (1040, 0, 7), (2064, 16, 7),
                                          (1024, 0, 51), (2064, -8, 21), (48, 0, 101)])
def test_bm_kernel_wide_ranges_match_plain(dev, D, mindisp, bs):
    """Up to 1024 the row form (block 101 at 48 in its int32 form); above,
    and where no row layout fits the shared memory (block 51 at 1024), the
    wide form, its sums in device scratch where they do not fit."""
    rng = np.random.default_rng(D)
    W = D + 80 + bs  # the window centres that see the whole range: 80
    base = rng.integers(0, 256, (2, max(21, bs + 4), W + D))
    left, right = base[..., :W], base[..., D - 40 : D - 40 + W] + rng.integers(-3, 4, (2, base.shape[1], W))
    lp, rp = (bm.prefilter_xsobel(torch.from_numpy(a.astype(np.int32))) for a in (left, right))
    kw = dict(ndisp=D, mindisp=mindisp, block_size=bs, cap=31, uniq=15, tex_thr=10)
    ref = bm_cuda.bm_disparity(lp, rp, **kw)
    out = bm_cuda.bm_disparity(lp.to(dev), rp.to(dev), **kw)
    assert (ref > mindisp - 1).float().mean() > 0.02 and torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("K,G", [(260, 4), (320, 8), (512, 16), (1024, 8), (1028, 4), (2052, 8)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_wide_band_kernels_above_256_match_plain(dev, K, G, dtype):
    """Bands 260-1024 (16 and 32 lanes a thread) and above 1024 (a warp
    walking the band): the cost kernel and the vertical scan with and
    without diagonals, both horizontals and the WTA (6-stat, sub), on
    per-pixel random shift maps, as test_wide_band_kernels_match_plain."""
    P, H, Wv = 2, 7, 37
    rng = np.random.default_rng(K + 1)
    ndisp = K + 64
    left, right = _images(K, P, H, ndisp + 30)
    s = _cost_shift_map(rng, P, H, ndisp + 30, ndisp, K, G, 1, "random")
    kw = dict(band=K, G=G, ndisp=ndisp, ftzero=15, block_size=5, min_x=ndisp, dtype=dtype)
    out = banded_cuda.banded_cost(left.to(dev), right.to(dev), s.to(dev), **kw)
    assert out.dtype == dtype and torch.equal(out.cpu(), banded_cuda.banded_cost_plain(left, right, s, **kw))
    C = torch.from_numpy(rng.integers(0, 2326, (P, H, Wv, K)).astype(np.int32)).to(dtype)
    s = _random_shift_map(rng, P, H, Wv, G)
    bound = 2325 if dtype == torch.int16 else 40000
    Cd, sd = C.to(dev), s.to(dev)
    for diag in (False, True):
        out = banded_cuda.banded_vertical(Cd, sd, G, 200, 800, cost_bound=bound, with_diagonals=diag)
        ref = banded_cuda.vertical_plain(C, s, G, 200, 800, diag)
        assert all(a.dtype == dtype and torch.equal(a.cpu().to(torch.int32), b) for a, b in zip(out, ref))
    for rev in (False, True):
        out = banded_cuda.banded_horizontal(Cd, sd, G, 200, 800, cost_bound=bound, reverse=rev)
        assert torch.equal(out.cpu().to(torch.int32), banded_cuda.horizontal_plain(C, s, G, 200, 800, rev))
    vols = [torch.from_numpy(rng.integers(0, 9000, (P, H, Wv, K)).astype(np.int32)).to(dtype) for _ in range(3)]
    for v in vols:
        v[:, :, :4, K - 3] = v[:, :, :4, 40] = v[:, :, :4, 2] = 0
    for sub in (False, True):
        ref = banded_cuda.banded_wta_plain(vols, 10, sub)
        out = banded_cuda.banded_wta([v.to(dev) for v in vols], 10, sub)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref))


def test_wide_range_inputs_card_equal_cpu(dev):
    """The inputs ROADMAP C.3 logged: stereo_sgbm at D = 320 on 48 x 480,
    the per-frame stereo_sgbm_hier at D = 512, band 320, G = 8 on 32 x 640;
    above 1024, stereo_sgbm at D = 1040 with the LR check on 8 x 1100 and
    at D = 2064 without it, stereo_bm at 1040."""
    left, right = (torch.from_numpy(a) for a in scene(seed=2, H=48, W=480))
    p = StereoSGBMParams(num_disparities=320, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=50,
                         speckle_range=2)
    ref = stereo_sgbm(left, right, p)
    assert torch.equal(stereo_sgbm(left.to(dev), right.to(dev), p).cpu(), ref)
    left, right = (torch.from_numpy(a) for a in scene(seed=3, H=32, W=640))
    p = StereoSGBMParams(num_disparities=512, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=30,
                         speckle_range=2, num_paths=3)
    hp = hier.HierParams(band=320, granularity=8)
    ref = hier.stereo_sgbm_hier(left, right, p, hp)
    assert torch.equal(hier.stereo_sgbm_hier(left.to(dev), right.to(dev), p, hp).cpu(), ref)
    for D, W, lr in ((1040, 1100, 1), (2064, 2130, -1)):
        left, right = _images(D, 1, 8, W)
        p = StereoSGBMParams(num_disparities=D, uniqueness_ratio=10, disp12_max_diff=lr, speckle_window_size=20,
                             speckle_range=2, num_paths=8 if lr >= 0 else 4)
        assert torch.equal(stereo_sgbm(left.to(dev), right.to(dev), p).cpu(), stereo_sgbm(left, right, p))
    left, right = _images(7, 1, 16, 1100)
    p = bm.StereoBMParams(num_disparities=1040, block_size=7)
    assert torch.equal(bm.stereo_bm(left.to(dev), right.to(dev), p).cpu(), bm.stereo_bm(left, right, p))


def _speckle_adversarial(P, H, W):
    """The speckle_patterns frames cycled over P frames of H x W (cropped,
    or padded with invalid pixels)."""
    base = np.full((7, max(H, 72), max(W, 100)), -1.0, np.float32)
    base[:, :72, :100] = speckle_patterns()
    return torch.from_numpy(np.stack([base[i % 7, :H, :W] for i in range(P)]))


@pytest.mark.parametrize("P,H,W", [(1, 72, 100), (7, 72, 100), (3, 33, 65), (9, 80, 161)])
@pytest.mark.parametrize("S,cap", [(20, None), (20, 2), (20, 4), (20, 8), (100, 4), (5, None), (1, None)])
def test_speckle_kernel_adversarial_maps_match_plain(dev, P, H, W, S, cap):
    """The union-find kernel on shapes made to break it, frame counts 1-9
    and sizes not a multiple of its 32 x 32 tile, capped and not; its
    device launches do not depend on R."""
    disp = _speckle_adversarial(P, H, W)
    ref = speckle_cuda.speckle_filter_plain(disp, 1.0, S, -1.0, max_diameter=cap)
    n = speckle_cuda.speckle_filter.device_launches
    out = speckle_cuda.speckle_filter(disp.to(dev), 1.0, S, -1.0, max_diameter=cap)
    torch.cuda.synchronize()
    assert speckle_cuda.speckle_filter.device_launches == n + 5
    assert torch.equal(out.cpu(), ref)


# ----------------------------------------------- the exact cost kernel (#1)
# Its grid of blocks, strips, tiles and disparity chunks against the plain
# form: blocks up to 51 (V and the ring in device scratch where no tile
# fits), D to 1040 (several chunks, a partial last one), negative and
# positive min_disparity, x_offset 0 and D, both storage types, a width no
# tile divides and frames shorter than the block.


@pytest.mark.parametrize("bs", [1, 3, 5, 11, 21, 51])
@pytest.mark.parametrize("D", [16, 48, 128, 256, 1024, 1040])
def test_cost_kernel_grid_matches_plain(dev, bs, D):
    H, W = 7, D + 16 + 37
    left, right = _images(D + bs, 2, H, W)
    ld, rd = left.to(dev), right.to(dev)
    for mindisp in (-8, 0, 16):
        full = cost_cuda.cost_volume_plain(left, right, ndisp=D, mindisp=mindisp, block_size=bs)
        for x_off in (0, D):
            want = full[:, :, x_off:]
            for dtype in (torch.int16, torch.int32):
                if dtype == torch.int16 and cost_cuda.window_bound(bs, 15) >= 1 << 15:
                    continue
                n = cost_cuda.cost_volume.launches
                got = cost_cuda.cost_volume(ld, rd, ndisp=D, mindisp=mindisp, block_size=bs, x_offset=x_off,
                                            dtype=dtype)
                assert cost_cuda.cost_volume.launches == n + 1 and got.dtype == dtype
                assert torch.equal(got.cpu(), want.to(dtype)), (mindisp, x_off, dtype)


# The BM row form (its packed and int32 forms) and the cluster vertical scan.


@pytest.mark.parametrize(
    "W,H,D,bs,mindisp,cap,uniq,tex,form",
    [(300, 40, 13, 31, 0, 31, 15, 10, "packed16"), (300, 40, 13, 33, 0, 31, 15, 10, "int32"),
     (200, 30, 22, 21, 0, 63, 15, 10, "packed16"), (200, 30, 22, 23, 0, 63, 15, 10, "int32"),
     (130, 12, 7, 5, 3, 31, 40, 60, "packed16"), (260, 9, 37, 5, -9, 31, 15, 10, "packed16"),
     (60, 7, 30, 7, 16, 31, 15, 10, "packed16"), (500, 5, 64, 5, 0, 31, 15, 10, "packed16"),
     (301, 11, 33, 3, -1, 31, 0, 0, "packed16"), (250, 9, 48, 9, -4, 150, 15, 10, "int32"),
     (400, 16, 128, 5, 0, 31, 15, 10, "packed16")],
)
def test_bm_row_forms_match_plain(dev, W, H, D, bs, mindisp, cap, uniq, tex, form):
    """Both row forms, on either side of the 16-bit packing bound (bs^2 * 2 cap
    < 2^16: 31 / 33 at cap 31, 21 / 23 at cap 63) and at cap 150 (no bytes):
    D not a multiple of 4 or 32, negative and positive min_disparity, W not a
    multiple of the strip and a frame narrower than one, H = bs, thresholds
    that reject pixels, and ties (constant frames)."""
    rng = np.random.default_rng(W + D + bs)
    base = rng.integers(0, 256, (2, H, W + 40))
    left, right = base[..., 20 : 20 + W], base[..., 13 : 13 + W] + rng.integers(-3, 4, (2, H, W))
    lp, rp = (bm.prefilter_xsobel(torch.from_numpy(a.astype(np.int32)), cap) for a in (left, right))
    flat = torch.full((1, H, W), cap, dtype=torch.int32)
    kw = dict(ndisp=D, mindisp=mindisp, block_size=bs, cap=cap, uniq=uniq, tex_thr=tex)
    assert bm_cuda.kernel_form(ndisp=D, mindisp=mindisp, block_size=bs, cap=cap) == form
    for lt, rt in ((lp, rp), (flat, flat)):
        ref = bm_cuda.bm_disparity(lt, rt, **kw)
        n = bm_cuda.bm_disparity.launches_by_form[form]
        out = bm_cuda.bm_disparity(lt.to(dev), rt.to(dev), **kw)
        torch.cuda.synchronize()
        assert bm_cuda.bm_disparity.launches_by_form[form] == n + 1
        assert torch.equal(out.cpu(), ref)
    valid = ref > mindisp - 1  # the constant frame: every disparity ties, texture 0
    assert not valid.any() or tex <= 0


@pytest.mark.parametrize("D", [16, 128, 200, 1000])  # 1, 4, 8 and 32 values a lane
@pytest.mark.parametrize("B,H,W", [(1, 1, 1), (5, 2, 2), (1, 7, 37), (2, 9, 300), (1, 3, 1152)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_vertical_cluster_matches_plain(dev, D, B, H, W, dtype):
    """The cluster vertical scan with and without diagonals: one column, two
    (two blocks of a cluster), 37 and 300 (up to 16 blocks, W not a multiple
    of the strip) and 1152; H = 1 and 2; B = 1, 2 and 5; int16 and int32
    (carries in scratch where they pass the shared memory). One device
    launch a call."""
    rng = np.random.default_rng(D + W + H)
    bound, (P1, P2) = (2325, (200, 800)) if dtype == torch.int16 else (40000, (8, 32000))
    C = torch.from_numpy(rng.integers(0, bound + 1, (B, H, W, D))).to(dtype)
    Cd = C.to(dev)
    plan = sgm_cuda.vertical_plan(Cd)
    assert plan["device_launches"] == 1 and 1 <= plan["cluster"] <= min(16, max(W, 1))
    assert -(-W // plan["columns"]) <= plan["cluster"]
    for diag in (True, False):
        n = sgm_cuda.vertical.device_launches
        got = sgm_cuda.vertical(Cd, P1, P2, diag, bound)
        torch.cuda.synchronize()
        assert sgm_cuda.vertical.device_launches == n + 1
        for a, r in zip(got, sgm_cuda.vertical_plain(C, P1, P2, diag)):
            assert a.dtype == dtype and torch.equal(a.cpu().to(torch.int32), r)


def test_aggregate_8_runs_the_cluster_vertical(dev):
    """aggregate_8 at 8 paths: one device launch of the cluster kernel, exact."""
    rng = np.random.default_rng(8)
    C = torch.from_numpy(rng.integers(0, 2326, (2, 23, 150, 64)).astype(np.int16))
    n = (sgm_cuda.aggregate_8.launches, sgm_cuda.vertical.device_launches)
    out = sgm_cuda.aggregate_8(C.to(dev), 200, 800, 8, cost_bound=2325)
    torch.cuda.synchronize()
    assert (sgm_cuda.aggregate_8.launches, sgm_cuda.vertical.device_launches) == (n[0] + 1, n[1] + 1)
    assert torch.equal(out.cpu(), sgm_cuda._aggregate_8(C, 200, 800, 8))


# The banded vertical scan's forms (#17) across the plan's edges: widths that
# cross warp, block and cluster edges, one row and more rows than a ring
# holds, shift maps constant on 4x4 tiles and per-pixel random, both storage
# types, every power-of-two band and one between.
@pytest.mark.parametrize("K,G", [(4, 2), (8, 4), (12, 4), (16, 8), (32, 8), (64, 16)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_banded_vertical_forms_match_plain(dev, K, G, dtype):
    bound, P1, P2 = (2325, 200, 800) if dtype == torch.int16 else (40000, 8, 32000)
    cost_bound = 2325 if dtype == torch.int16 else 20000
    rng = np.random.default_rng(K * 7 + G)
    for Wv in (1, 31, 33, 1152, 4097, 8192):
        for H in (1, 17):  # 17 rows: more than the deepest ring the plans take at these shapes
            P = 2 if Wv <= 1152 else 1
            C = torch.from_numpy(rng.integers(0, bound + 1, (P, H, Wv, K))).to(dtype)
            if H == 1:
                s = _random_shift_map(rng, P, H, Wv, G)
            else:
                tiles = rng.integers(0, 6, (P, -(-H // 4), -(-Wv // 4))) * G
                s = torch.from_numpy(np.repeat(np.repeat(tiles, 4, 1), 4, 2)[:, :H, :Wv].astype(np.int32))
            for maps in ((s, _random_shift_map(rng, P, H, Wv, G)) if H > 1 else (s,)):
                for diag in (False, True):
                    n = banded_cuda.banded_vertical.launches
                    out = banded_cuda.banded_vertical(C.to(dev), maps.to(dev), G, P1, P2, cost_bound=cost_bound,
                                                      with_diagonals=diag)
                    plan = banded_cuda.banded_vertical.plan
                    assert banded_cuda.banded_vertical.launches == n + 1 and plan["device_launches"] == 1
                    assert plan["form"] in (("cluster", "strips") if diag else ("ring", "group"))
                    ref = banded_cuda.vertical_plain(C, maps, G, P1, P2, diag)
                    assert all(a.dtype == dtype and torch.equal(a.cpu().to(torch.int32), r) for a, r in zip(out, ref)), \
                        (Wv, H, diag, plan)


# The settings the reference computes and the card once refused (ROADMAP C.1,
# C.2, C.3, C.4), card against CPU.
@pytest.mark.parametrize("H,W,D,mindisp", [(8, 16, 16, 0), (8, 12, 16, 0), (8, 16, 8, 8), (8, 17, 16, 0)])
def test_sgbm_frame_no_wider_than_range_card_equals_cpu(dev, H, W, D, mindisp):
    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.int32)) for _ in range(2))
    p = StereoSGBMParams(num_disparities=D, min_disparity=mindisp, block_size=3)
    n = cost_cuda.cost_volume.launches
    got = stereo_sgbm(left.to(dev), right.to(dev), p)
    assert torch.equal(got.cpu(), stereo_sgbm(left, right, p))
    assert (cost_cuda.cost_volume.launches == n) == (W <= mindisp + D)  # no kernel on an empty region


@pytest.mark.parametrize("W", [64, 67])
def test_hier_no_wider_than_range_card_equals_cpu(dev, W):
    left, right = (torch.from_numpy(a.astype(np.int32)) for a in scene(seed=3, H=32, W=W, box_disp=20))
    p = StereoSGBMParams(num_disparities=64)
    hp = hier.HierParams(band=16, granularity=8, tile=1, local_window=1)
    got = hier.stereo_sgbm_hier(left.to(dev), right.to(dev), p, hp)
    assert torch.equal(got.cpu(), hier.stereo_sgbm_hier(left, right, p, hp))
    frames = [scene(seed=s, H=32, W=W, box_disp=20) for s in range(8)]
    L, R = (torch.from_numpy(np.stack([f[i] for f in frames]).astype(np.int32)) for i in (0, 1))
    p = StereoSGBMParams(num_disparities=64, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=30,
                         speckle_range=2)
    got = hier.stereo_sgbm_hier_batch(L.to(dev), R.to(dev), p, hp)
    assert torch.equal(got.cpu(), hier.stereo_sgbm_hier_batch(L, R, p, hp))


@pytest.mark.parametrize("H,W", [(4, 20), (20, 4), (5, 5)])
def test_bm_frame_smaller_than_block_card_equals_cpu(dev, H, W):
    rng = np.random.default_rng(1)
    left, right = (torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.int32)) for _ in range(2))
    p = bm.StereoBMParams(num_disparities=8, block_size=5)
    n = bm_cuda.bm_disparity.launches
    got = bm.stereo_bm(left.to(dev), right.to(dev), p)
    assert torch.equal(got.cpu(), bm.stereo_bm(left, right, p))
    assert (bm_cuda.bm_disparity.launches == n) == (H < 5 or W < 5)


@pytest.mark.parametrize("bs", [2, 4, 6])
def test_even_blocks_card_equal_plain(dev, bs):
    """Both cost kernels at an even block against their plain forms (int16
    and int32, several disparity ranges, stride and shift maps), then
    stereo_sgbm at ROADMAP C.3's input and the per-frame hier, card == CPU."""
    rng = np.random.default_rng(bs)
    left, right = _images(bs, 2, 23, 150)
    for D, md, xo, dtype in ((16, 0, 16, torch.int16), (64, 0, 64, torch.int32), (48, 3, 0, torch.int16),
                             (200, 0, 100, torch.int16)):
        kw = dict(ndisp=D, mindisp=md, block_size=bs, x_offset=xo)
        ref = cost_cuda.cost_volume_plain(left, right, **kw)
        out = cost_cuda.cost_volume(left.to(dev), right.to(dev), dtype=dtype, **kw)
        assert out.dtype == dtype and torch.equal(out.cpu().to(torch.int32), ref.to(torch.int32))
    for K, G, nd, stride, dtype in ((4, 2, 64, 1, torch.int16), (16, 8, 64, 1, torch.int32), (8, 4, 32, 2, torch.int16),
                                    (68, 4, 128, 1, torch.int16)):
        s = (_random_shift_map(rng, 2, 23, 150, G).clamp(max=nd - K) if stride == 1
             else torch.zeros((2, 23, 150), dtype=torch.int32))
        kw = dict(band=K, G=G, ndisp=nd, block_size=bs, min_x=nd, stride=stride, dtype=dtype)
        ref = banded_cuda.banded_cost_plain(left, right, s, ftzero=15, **kw)
        out = banded_cuda.banded_cost(left.to(dev), right.to(dev), s.to(dev), **kw)
        assert torch.equal(out.cpu(), ref)
    rng = np.random.default_rng(7)
    l1, r1 = (torch.from_numpy(rng.integers(0, 256, (12, 56)).astype(np.int32)) for _ in range(2))
    p = StereoSGBMParams(num_disparities=16, block_size=bs, uniqueness_ratio=5)
    assert torch.equal(stereo_sgbm(l1.to(dev), r1.to(dev), p).cpu(), stereo_sgbm(l1, r1, p))
    l2, r2 = (torch.from_numpy(a.astype(np.int32)) for a in scene(seed=2, H=32, W=128))
    p = StereoSGBMParams(num_disparities=64, block_size=bs, uniqueness_ratio=10, disp12_max_diff=1, num_paths=3)
    hp = hier.HierParams(band=16, granularity=8, tile=1, local_window=1)
    got = hier.stereo_sgbm_hier(l2.to(dev), r2.to(dev), p, hp)
    assert torch.equal(got.cpu(), hier.stereo_sgbm_hier(l2, r2, p, hp))


@pytest.mark.parametrize("matcher", ["sgbm", "bm"])
def test_other_matchers_ignore_hier_params_on_the_card(dev, matcher):
    frames = [scene(seed=s, H=24, W=96) for s in range(2)]
    L, R = (np.stack([f[i] for f in frames]) for i in (0, 1))
    yy, xx = np.mgrid[0:24, 0:96].astype(np.float32)
    maps = (xx + 0.2, yy, xx, yy + 0.1)
    Q = np.array([[1, 0, 0, -48], [0, 1, 0, -12], [0, 0, 0, 300.0], [0, 0, 10.0, 0]], np.float32)
    params = (StereoSGBMParams(num_disparities=16, uniqueness_ratio=10) if matcher == "sgbm"
              else bm.StereoBMParams(num_disparities=16, block_size=5))
    d0, _ = batched_stereo_pipeline(L, R, maps, Q, matcher=matcher, params=params, device=dev)
    d1, _ = batched_stereo_pipeline(L, R, maps, Q, matcher=matcher, params=params, hier_params=HIER_FAST, device=dev)
    dc, _ = batched_stereo_pipeline(L, R, maps, Q, matcher=matcher, params=params, device="cpu")
    assert torch.equal(d0, d1) and torch.equal(d0.cpu(), dc)


# Bands off K % 4 == 0 and below 4 (ROADMAP C.7: the strided coarse search
# at 1-3 lanes), the WTA (#20) and the packed LR check (#10) redesigned.
@pytest.mark.parametrize("K,G", [(1, 8), (2, 8), (3, 8), (3, 2), (5, 4), (6, 2), (7, 4), (9, 4), (13, 8), (20, 8),
                                 (36, 8), (65, 16), (70, 8)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_banded_kernels_at_any_band_match_plain(dev, K, G, dtype):
    """Every banded kernel at bands off K % 4 == 0 (a pixel's lanes
    lane_stride(K) apart): the cost at s == 0 with a stride and on random
    shift maps, the vertical scan (every plan form) with and without
    diagonals, both horizontals and the WTA, each fed the card's own output
    (its padded layout) and a contiguous copy."""
    P, H, Wv = 2, 9, 37
    rng = np.random.default_rng(K * 10 + G)
    ndisp = 4 * K + 16
    left, right = _images(K, P, H, ndisp + Wv)
    for stride, kind in ((max(ndisp // K // 2, 1), "zero"), (1, "random")):
        s = _cost_shift_map(rng, P, H, ndisp + Wv, ndisp, K, G, stride, kind)
        kw = dict(band=K, G=G, ndisp=ndisp, ftzero=15, block_size=5, min_x=ndisp, stride=stride, dtype=dtype)
        cost = banded_cuda.banded_cost(left.to(dev), right.to(dev), s.to(dev), **kw)
        assert cost.dtype == dtype and torch.equal(cost.cpu(), banded_cuda.banded_cost_plain(left, right, s, **kw))
    C, s = cost.cpu(), s[:, :, ndisp:].contiguous()
    for Cd in (cost, C.to(dev)):
        for diag in (False, True):
            out = banded_cuda.banded_vertical(Cd, s.to(dev), G, 200, 800, cost_bound=2325, with_diagonals=diag)
            ref = banded_cuda.vertical_plain(C, s, G, 200, 800, diag)
            assert all(torch.equal(a.cpu().to(torch.int32), b) for a, b in zip(out, ref))
        vols = list(out)
        for rev in (False, True):
            out = banded_cuda.banded_horizontal(Cd, s.to(dev), G, 200, 800, cost_bound=2325, reverse=rev)
            assert torch.equal(out.cpu().to(torch.int32), banded_cuda.horizontal_plain(C, s, G, 200, 800, rev))
            vols.append(out)
        for sub in (False, True):
            got = banded_cuda.banded_wta(vols, 10, sub)
            ref = banded_cuda.banded_wta_plain([v.cpu() for v in vols], 10, sub)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))


WTA_GRID_K = (1, 2, 3, 4, 8, 12, 16, 20, 32, 36, 64)
WTA_GRID_PIXELS = (1, 31, 32, 33, 255, 256, 257, 1007)  # a thread a pixel, 32 a warp, 256 a block at K <= 16


@pytest.mark.parametrize("K", WTA_GRID_K)
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_banded_wta_grid_matches_plain(dev, K, dtype):
    """The WTA (#20) over 2-4 volumes, both forms, at pixel counts 1, 31 and
    about a warp's run (32) and a block's (256), and 1000 + 7, on adversarial
    volumes (ties, the minimum at either end, uniqueness at its boundary;
    int32 sums near 2^31), against its plain form, exact."""
    rng = np.random.default_rng(K)
    modes = scenes.WTA_MODES if dtype == torch.int32 else scenes.WTA_MODES[:-1]
    for nvol in (2, 3, 4):
        for n in WTA_GRID_PIXELS:
            for mode in modes:
                store = np.int32 if mode == "near_bound" else np.int16
                vols = [torch.from_numpy(v).to(dtype) for v in scenes.wta_volumes(rng, (1, 1, n, K), mode, nvol, store)]
                for sub in (False, True):
                    got = banded_cuda.banded_wta([v.to(dev) for v in vols], 10, sub)
                    ref = banded_cuda.banded_wta_plain(vols, 10, sub)
                    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)), (nvol, n, mode, sub)


@pytest.mark.parametrize("W,ndisp", [(W, nd) for W in (17, 96, 1280, 4096, 20000) for nd in (16, 128, 1024, 2047)
                                     if nd < W])
def test_lr_packed_grid_matches_plain(dev, W, ndisp):
    """The packed LR check (#10), a warp a row, against its plain form (run
    on the card) on rows of any width (maps whose rows do not start on 16
    bytes), every disparity range of the pack's field, max_diff 0-2, and
    maps made to break it (every scatter of a row colliding, d16 < 0,
    lookups at and past the shifts -1 and ndisp)."""
    rng = np.random.default_rng(W + ndisp)
    for rows in (1, 7, 33):
        for mode in scenes.LR_MODES:
            pack, d16 = scenes.lr_maps(rng, (1, rows, W - ndisp), ndisp, mode)
            for max_diff in (0, 1, 2):
                kw = dict(W=W, ndisp=ndisp, max_diff=max_diff)
                pk, dd = torch.from_numpy(pack).to(dev), torch.from_numpy(d16).to(dev)
                got = lr_cuda.lr_fail_packed(pk, dd, **kw)
                assert torch.equal(got, lr_cuda.lr_fail_packed_plain(pk, dd, **kw)), (rows, mode, max_diff)


@pytest.mark.parametrize("D,stride,W", [(64, 16, 128), (64, 8, 128), (192, 16, 256), (192, 3, 256)])
def test_per_frame_hier_few_coarse_lanes_card_equals_cpu(dev, D, stride, W):
    """ROADMAP C.7: the per-frame stereo_sgbm_hier with the strided coarse
    search at Kc = 1, 2, 3 (D = 64 at strides 16 and 8, D = 192 at stride
    16) and 16 (D = 192, stride 3): the card equals the CPU."""
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, (16, W)).astype(np.int32)
    right = np.roll(left, -8 if D == 64 else -40, axis=1)
    p = StereoSGBMParams(num_disparities=D, block_size=3)
    hp = hier.HierParams(band=16, granularity=8, coarse_stride=stride)
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    got = hier.stereo_sgbm_hier(L.to(dev), R.to(dev), p, hp)
    assert torch.equal(got.cpu(), hier.stereo_sgbm_hier(L, R, p, hp))


@pytest.mark.parametrize("D,stride", [(64, 3), (192, 8)])
def test_per_frame_hier_refuses_kc_5_and_6_on_the_card(dev, D, stride):
    """Where the reference raises (Kc = 5 and 6 at G = 8), the card raises
    before any launch."""
    L = torch.zeros((16, 256), dtype=torch.int32, device=dev)
    n = banded_cuda.downsample_pyramid.launches
    with pytest.raises(ValueError, match="lanes at granularity 8"):
        hier.stereo_sgbm_hier(L, L, StereoSGBMParams(num_disparities=D, block_size=3),
                              hier.HierParams(band=16, granularity=8, coarse_stride=stride))
    assert banded_cuda.downsample_pyramid.launches == n


# The fused R->L scan + WTA (#5) and the fused banded WTA (#19) redesigned:
# #5 a ring of columns in shared memory ahead of the scan (or, where a
# lane's words cannot be copied whole, the direct form), #19 in
# banded_wta.cu beside #20.
@pytest.mark.parametrize("D", [3, 4, 31, 32, 33, 128, 129, 1024])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_fused_rl_wta_forms_match_plain(dev, D, dtype):
    """#5 at the register forms' edges in both storage types, at 1, 2, 31
    and 300 columns and 5 and 9 rows (no multiple of a block's rows), uniq
    0 and 10, every other row's costs zero so that the planted ties,
    minima at either end and uniqueness boundaries of wta_volumes survive
    in the sum; the plan's form is the ring wherever a lane's words copy
    whole."""
    vpl = next(v for v in (1, 2, 4, 8, 16, 32) if 32 * v >= D)
    plan = sgm_cuda.rl_wta_plan(D, dtype)
    ring = D % vpl == 0 and vpl * (2 if dtype == torch.int16 else 4) >= 4
    assert plan["form"] == ("ring" if ring else "direct")
    bound = 2325 if dtype == torch.int16 else 40000
    modes = scenes.WTA_MODES if dtype == torch.int32 else scenes.WTA_MODES[:-1]
    for i, (W, rows) in enumerate(((1, (1, 5)), (2, (3, 3)), (31, (1, 5)), (300, (3, 3)))):
        rng = np.random.default_rng(D * 100 + W)
        C = rng.integers(0, bound + 1, (*rows, W, D))
        C[:, 1::2] = 0
        vols = scenes.wta_volumes(rng, (*rows, W, D), modes[i % len(modes)], 3,
                                  np.int32 if dtype == torch.int32 else np.int16)
        Cc, vc = torch.from_numpy(C).to(dtype), [torch.from_numpy(v).to(dtype) for v in vols]
        for uniq in (0, 10):
            ref = sgm_cuda.horizontal_rl_wta_plain(Cc, *vc, 200, 800, uniq)
            n = sgm_cuda.horizontal_rl_wta.launches
            out = sgm_cuda.horizontal_rl_wta(Cc.to(dev), *(v.to(dev) for v in vc), 200, 800, uniq)
            assert sgm_cuda.horizontal_rl_wta.launches == n + 1 and sgm_cuda.horizontal_rl_wta.plan == plan
            assert all(torch.equal(a.cpu(), b) for a, b in zip(out, ref)), (W, rows, uniq)


def test_fused_rl_wta_plan_fits_every_register_form(dev):
    """The ring's plan over every range the register forms take: 2-8
    columns (a power of two) a row, at most 8 rows and 64 KB a block, the
    slot's bytes (4 x 32 x VPL values) times the ring and rows; the direct
    form where D % VPL != 0 or a lane holds 2 bytes; the wide form above
    1024."""
    for dtype, nbytes in ((torch.int16, 2), (torch.int32, 4)):
        for D in range(3, 1025):
            vpl = next(v for v in (1, 2, 4, 8, 16, 32) if 32 * v >= D)
            p = sgm_cuda.rl_wta_plan(D, dtype)
            if D % vpl or vpl * nbytes < 4:
                assert p["form"] == "direct" and p["smem_bytes"] == 0, (D, dtype, p)
                continue
            assert p["form"] == "ring" and p["ring"] in (2, 4, 8) and 1 <= p["rows_per_block"] <= 8, (D, dtype, p)
            assert p["smem_bytes"] == p["rows_per_block"] * p["ring"] * 4 * 32 * vpl * nbytes <= 64 << 10
        assert sgm_cuda.rl_wta_plan(1040, dtype)["form"] == "wide"
    assert sgm_cuda.rl_wta_plan(128, torch.int16) == dict(form="ring", rows_per_block=8, ring=2, smem_bytes=16384)


def test_fused_rl_wta_refuses_what_it_does_not_take(dev):
    """A tensor that does not start on 16 bytes, mixed types, D < 3: the
    wrapper raises before any launch (no plain form on the card)."""
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.integers(0, 2326, (1, 3, 9, 64)).astype(np.int16)).to(dev)
    vols = [torch.from_numpy(rng.integers(0, 3000, (1, 3, 9, 64)).astype(np.int16)).to(dev) for _ in range(3)]
    flat = torch.zeros(C.numel() + 1, dtype=torch.int16, device=dev)
    flat[1:] = C.flatten()
    n = sgm_cuda.horizontal_rl_wta.launches
    with pytest.raises(TypeError, match="16 bytes"):
        sgm_cuda.horizontal_rl_wta(flat[1:].view(C.shape), *vols, 200, 800, 10)
    with pytest.raises(TypeError, match="one type"):
        sgm_cuda.horizontal_rl_wta(C, vols[0], vols[1], vols[2].to(torch.int32), 200, 800, 10)
    with pytest.raises(ValueError, match="D>=3"):
        sgm_cuda.horizontal_rl_wta(C[..., :2], *(v[..., :2] for v in vols), 200, 800, 10)
    assert sgm_cuda.horizontal_rl_wta.launches == n


@pytest.mark.parametrize("nvol", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_fused_wta_grid_matches_plain(dev, nvol, dtype):
    """#19 in banded_wta.cu: adversarial lanes (ties, minima at either end,
    the uniqueness boundary) at 1-1007 pixels, shift maps at 0, at ndisp -
    16 and random, the widest range the pack takes (2047)."""
    rng = np.random.default_rng(nvol * 10 + (dtype == torch.int32))
    K, nd = banded_cuda.FUSED_BAND, 2047
    for n in (1, 31, 255, 257, 1007):
        for mode in scenes.WTA_MODES[:-1]:
            vols = [torch.from_numpy(v).to(dtype) for v in scenes.wta_volumes(rng, (1, 1, n, K), mode, nvol)]
            for s in (np.zeros((1, 1, n)), np.full((1, 1, n), nd - K), rng.integers(0, nd - K + 1, (1, 1, n))):
                s = torch.from_numpy(s.astype(np.int32))
                ref = banded_cuda.banded_wta_fused_plain(vols, s, 10)
                got = banded_cuda.banded_wta_fused([v.to(dev) for v in vols], s.to(dev), 10, ndisp=nd,
                                                   volume_bound=None if dtype == torch.int16 else 6000)
                assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref)), (n, mode)


def test_fused_wta_refuses_what_it_does_not_take(dev):
    """Band 16 only, 16 * ndisp < 32768, minS < 2^20: the wrapper raises
    before any launch."""
    vols = [torch.zeros((1, 2, 5, 16), dtype=torch.int16, device=dev) for _ in range(3)]
    s = torch.zeros((1, 2, 5), dtype=torch.int32, device=dev)
    n = banded_cuda.banded_wta_fused.launches
    with pytest.raises(ValueError, match="band 16"):
        banded_cuda.banded_wta_fused([v[..., :8].contiguous() for v in vols], s, 10, ndisp=128)
    with pytest.raises(ValueError, match="collide"):
        banded_cuda.banded_wta_fused(vols, s, 10, ndisp=2048)
    with pytest.raises(ValueError, match="int32 pack"):
        banded_cuda.banded_wta_fused([v.to(torch.int32) for v in vols], s, 10, ndisp=128, volume_bound=1 << 19)
    assert banded_cuda.banded_wta_fused.launches == n


# The box-downsample pyramid (#14) and the unpacked LR check (#9)
# redesigned: #14 both images and every level in one launch where the
# factors nest (one launch a level, both images, where they do not); #9 a
# block a row, every load of the row issued before its scatter.
PYRAMID_SETS = [((4, 4), (2, 2)), ((4, 4),), ((8, 8), (4, 4), (2, 2)), ((4, 8), (2, 2)), ((2, 2),),
                ((1, 1), (16, 128)), ((16, 16), (2, 4)), ((3, 3),), ((4, 4), (3, 3)), ((2, 8), (4, 2))]


@pytest.mark.parametrize("factors", PYRAMID_SETS, ids=lambda f: "_".join(f"{a}x{b}" for a, b in f))
@pytest.mark.parametrize("P,H,W", [(1, 720, 1280), (2, 45, 101), (3, 17, 26), (1, 33, 130), (2, 16, 3)])
def test_pyramid_kernel_matches_plain(dev, factors, P, H, W):
    """Odd and unaligned widths (rows off 16 bytes: scalar loads), one
    frame, levels with no output, pixels at 0 and 255."""
    rng = np.random.default_rng(P * H * W)
    levels = sum(H // fy > 0 and W // fx > 0 for fy, fx in factors)
    want = min(levels, 1) if banded_cuda.pyramid_nests(factors) else levels
    for fill in ("random", 0, 255):
        img = rng.integers(0, 256, (2, P, H, W)) if fill == "random" else np.full((2, P, H, W), fill)
        left, right = (torch.from_numpy(a.astype(np.int32)) for a in img)
        ref = banded_cuda.downsample_pyramid_plain(left, right, factors)
        n = banded_cuda.downsample_pyramid.launches
        got = banded_cuda.downsample_pyramid(left.to(dev), right.to(dev), factors)
        torch.cuda.synchronize()
        assert banded_cuda.downsample_pyramid.launches == n + want
        for (lc, rc), (lr, rr) in zip(got, ref):
            assert torch.equal(lc.cpu(), lr) and torch.equal(rc.cpu(), rr), fill


@pytest.mark.parametrize("factors", [((4, 4), (2, 2)), ((8, 8), (4, 4), (2, 2))])
def test_pyramid_kernel_on_frames_off_16_bytes(dev, factors):
    """Frames that start 4 bytes past a 16-byte boundary (W % 4 == 0): the
    kernel reads them a value at a time."""
    P, H, W = 2, 40, 96
    rng = np.random.default_rng(3)
    buf = [torch.from_numpy(rng.integers(0, 256, P * H * W + 1).astype(np.int32)).to(dev) for _ in range(2)]
    left, right = (b[1:].view(P, H, W) for b in buf)
    assert left.data_ptr() % 16 == 4
    got = banded_cuda.downsample_pyramid(left, right, factors)
    ref = banded_cuda.downsample_pyramid_plain(left.cpu(), right.cpu(), factors)
    for (lc, rc), (lr, rr) in zip(got, ref):
        assert torch.equal(lc.cpu(), lr) and torch.equal(rc.cpu(), rr)


@pytest.mark.parametrize("W,ndisp,mindisp", [(17, 8, 0), (96, 16, 16), (1280, 128, 0), (1283, 128, 16), (1157, 64, 0),
                                             (4096, 1024, 0), (20000, 2031, 16)])
def test_lr_unpacked_grid_matches_plain(dev, W, ndisp, mindisp):
    """The unpacked LR check (#9), a block a row, against its plain form
    (run on the card): valid regions aligned to 16 bytes and not (Wv % 4 !=
    0), min_x at and past ndisp + min_disparity, max_diff 0-2, 1 to 2,881
    rows, maps made to break it (every scatter of a row colliding, winners
    outside [0, ndisp), disparities below zero and lookups at and past the
    shifts min_disparity - 1 and min_disparity + ndisp), one launch a call."""
    rng = np.random.default_rng(W + ndisp + mindisp)
    for extra in (0, 3):
        min_x = ndisp + mindisp + extra
        Wv = W - min_x
        for rows in (1, 7, 33, 2881):
            if rows > 33 and (rows * W > 4_000_000 or ndisp > 128):
                continue
            for mode in scenes.LR_MODES:
                pack, d16 = scenes.lr_maps(rng, (1, rows, Wv), ndisp, mode)
                best = pack & 2047
                best[rng.random(best.shape) < 0.02] = rng.choice([-1, ndisp, 2047])
                maps = (pack >> 11, best, d16 / 16.0 + mindisp)
                minS, best, disp = (torch.from_numpy(m.astype(t)).to(dev)
                                    for m, t in zip(maps, (np.int32, np.int32, np.float32)))
                for max_diff in (0, 1, 2):
                    kw = dict(W=W, min_x=min_x, ndisp=ndisp, mindisp=mindisp, max_diff=max_diff)
                    n = lr_cuda.lr_fail.launches
                    got = lr_cuda.lr_fail(minS, best, disp, **kw)
                    assert lr_cuda.lr_fail.launches == n + 1
                    assert torch.equal(got, lr_fail(minS, best, disp, **kw)), (extra, rows, mode, max_diff)


# The distorted camera pair of tests/test_torch_calib.py (K, distortion and a
# converged rig), seen by the card and the CPU.
CAL_K = np.array([[1450.0, 0, 955.0], [0, 1455.0, 545.0], [0, 0, 1.0]])
CAL_DIST = np.array([-0.15, 0.04, 8e-4, -6e-4, -0.006])
CAL_R = ops.rodrigues(torch.tensor([0.01, -0.05, 0.004], dtype=torch.float64), device="cpu").numpy()
CAL_T = np.array([-500.0, 6.0, 20.0])


def _same_fields(a, b, rtol_fields, atol_fields):
    """Card and CPU results within tests/test_torch_calib.py's tolerances of the port against JAX."""
    for name in rtol_fields:
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=1e-5, err_msg=name)
    for name in atol_fields:
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=0, atol=1e-6, err_msg=name)


def test_calibration_cuda_matches_cpu(dev):
    """calibrate_camera (the outlier rounds on, one frame corrupted) and
    calibrate_stereo: LM in float64 on the card against the CPU."""
    obj, c1, c2 = board_views(14, 4, CAL_K, CAL_DIST, (1920, 1080), CAL_K, CAL_DIST, CAL_R, CAL_T,
                              depth=(1800.0, 3200.0))
    c1[5] += np.random.default_rng(1).normal(0, 3.0, c1[5].shape)
    gpu = calib.calibrate_camera(obj, c1, (1920, 1080))
    cpu = calib.calibrate_camera(obj, c1, (1920, 1080), device="cpu")
    np.testing.assert_array_equal(gpu.kept_frames, cpu.kept_frames)
    assert 5 not in gpu.kept_frames
    _same_fields(gpu, cpu, ("K", "dist", "tvecs"), ("rvecs", "per_frame_errors", "rms"))
    args = (obj, c1[gpu.kept_frames], c2[gpu.kept_frames], gpu.K, gpu.dist, CAL_K, CAL_DIST, (1920, 1080))
    sg, sc = calib.calibrate_stereo(*args), calib.calibrate_stereo(*args, device="cpu")
    _same_fields(sg, sc, ("T", "E", "F"), ("R", "per_frame_errors", "rms"))
    assert abs(sg.baseline / np.linalg.norm(CAL_T) - 1) < 0.01


def test_sync_cuda_matches_cpu(dev):
    """synchronize_streams and similarity_matrix on the card against the CPU."""
    left, right = flash_streams(40, 3, 12, H=96, W=200)
    g, c = sync.synchronize_streams(left, right), sync.synchronize_streams(left, right, device="cpu")
    assert g[:3] == c[:3] == (12, 15, 3)
    np.testing.assert_allclose(g[3:], c[3:], rtol=1e-5)
    sg = sync.similarity_matrix(left[:16], right[:20])
    assert sg.device.type == "cuda"
    sc = sync.similarity_matrix(left[:16], right[:20], device="cpu")
    torch.testing.assert_close(sg.cpu(), sc, rtol=0, atol=1e-3)
    gc = sync.find_best_offset_by_content(left, right, 10)
    cc = sync.find_best_offset_by_content(left, right, 10, device="cpu")
    assert gc[0] == cc[0] == 3 and abs(gc[1] - cc[1]) <= 0.05


def test_stream_processor_cuda_matches_batched_pipeline(dev):
    """The processor under a non-default compute stream, three windows
    through both pinned slots (slot 0 again on the third), the caller's
    arrays rewritten after each submit: every drained window equals
    batched_stereo_pipeline's bit for bit; then two submits and one drain
    return the second window."""
    H, W = 64, 256
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (xx + 0.3 * np.sin(yy / 11.0), yy + 0.2 * np.cos(xx / 13.0), xx - 0.1 + 0.3 * np.sin(yy / 11.0),
            yy + 0.2 * np.cos(xx / 13.0))
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 500.0], [0, 0, 10.0, 0]], np.float32)
    params = StereoSGBMParams(num_disparities=128, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                              speckle_window_size=30, speckle_range=2, num_paths=3)
    frames = [scene(seed=s, H=H, W=W) for s in range(24)]
    windows = [tuple(np.stack([f[i] for f in frames[8 * w:8 * w + 8]]).astype(np.uint8) for i in (0, 1))
               for w in range(3)]
    refs = [batched_stereo_pipeline(l, r, maps, Q, "sgbm_hier", params) for l, r in windows]
    proc = StereoStreamProcessor(create_mesh(), maps, Q, "sgbm_hier", params)
    compute = torch.cuda.Stream()
    with torch.cuda.stream(compute):
        for (l, r), ref in zip(windows, refs):
            lc, rc = l.copy(), r.copy()
            proc.submit(lc, rc)
            lc[:] = 0
            rc[:] = 255
            disp, pts = proc.drain()
            np.testing.assert_array_equal(disp, ref[0].cpu().numpy())
            np.testing.assert_array_equal(pts, ref[1].cpu().numpy())
        proc.submit(*windows[0])
        proc.submit(*windows[1])
        disp, _ = proc.drain()
    np.testing.assert_array_equal(disp, refs[1][0].cpu().numpy())
    assert proc.drain() is None


def _serpentine(n):
    m = np.zeros((n, n), bool)
    m[::2] = True
    for i in range(1, n, 2):
        m[i, n - 1 if (i // 2) % 2 == 0 else 0] = True
    return m


def test_gray_and_otsu_cuda_match_cpu(dev):
    """rgb_to_gray (the 256 gray levels, 10^5 random triples) bit for bit and
    Otsu's threshold on 100 random bimodal images, card against CPU."""
    rng = np.random.default_rng(16)
    levels = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)[None]
    for img in (levels, rng.integers(0, 256, (1, 100_000, 3), dtype=np.uint8)):
        g = detect.rgb_to_gray(torch.from_numpy(img).to(dev)).cpu()
        assert torch.equal(g.view(torch.int32), detect.rgb_to_gray(torch.from_numpy(img)).view(torch.int32))
    for _ in range(100):
        H, W = rng.integers(8, 120, 2)
        img = np.clip(np.where(rng.random((H, W)) < rng.uniform(0.2, 0.8), rng.normal(rng.uniform(20, 120), 20, (H, W)),
                               rng.normal(rng.uniform(120, 230), 30, (H, W))), 0, 255).astype(np.float32)
        t = torch.from_numpy(img)
        assert float(detect.otsu_threshold(t.to(dev))) == float(detect.otsu_threshold(t))


@pytest.mark.parametrize("shape,p", [((37, 53), 0.6), ((256, 320), 0.55), ((1, 900), 0.8), ((720, 1280), 0.5)])
def test_connected_component_labels_cuda_match_cpu(dev, shape, p):
    """The labels and largest_component_mask, bit for bit; the serpentine
    whose fixed rounds stop short of convergence too."""
    from stereo_vision_tpu_torch.stereo.postprocess import connected_component_labels

    masks = [np.random.default_rng(sum(shape)).random(shape) < p, _serpentine(64)]
    for mask in masks:
        m = torch.from_numpy(mask)
        H, W = mask.shape
        pad = torch.nn.functional.pad(m, (1, 1, 1, 1))
        adj = [m & pad[1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx] for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1))]
        cpu = connected_component_labels(adj, m)
        card = connected_component_labels([a.to(dev) for a in adj], m.to(dev))
        assert torch.equal(card.cpu(), cpu)
        assert torch.equal(detect.largest_component_mask(m.to(dev)).cpu(), detect.largest_component_mask(m))


def test_hough_accumulator_cuda_matches_cpu(dev):
    """Exact integer counts over the ring size on both, at the ball frame's
    edges and on random edge maps."""
    frame = ball_frame(2, 240, 320, 160.0, 120.0, 40.0)
    mag = detect.sobel_magnitude(detect.rgb_to_gray(torch.from_numpy(frame)))[0]
    edges = [(mag > 100.0).float(), torch.from_numpy((np.random.default_rng(3).random((200, 260)) < 0.2)
                                                     .astype(np.float32))]
    for e in edges:
        radii = tuple(range(10, 101, 2))
        assert torch.equal(detect.hough_accumulator(e.to(dev), radii).cpu(), detect.hough_accumulator(e, radii))
    gray = detect.rgb_to_gray(torch.from_numpy(frame))
    assert detect.hough_circles(gray.to(dev), 20, 60) == detect.hough_circles(gray, 20, 60)


def test_hough_accumulator_edge_strength_cuda_matches_cpu(dev):
    """A float edge-strength map keeps its unrounded sums on both: within
    rtol 1e-6 (float64 FFTs in other orders, rounded to float32)."""
    frame = ball_frame(2, 240, 320, 160.0, 120.0, 40.0)
    mag = detect.sobel_magnitude(detect.rgb_to_gray(torch.from_numpy(frame)))[0]
    radii = tuple(range(10, 101, 6))
    cpu = detect.hough_accumulator(mag, radii)
    torch.testing.assert_close(detect.hough_accumulator(mag.to(dev), radii).cpu(), cpu, rtol=1e-6,
                               atol=1e-6 * float(cpu.abs().max()))


def test_edge_width_means_cuda_match_cpu(dev):
    """find_chessboard_corners' blur measure (float64 sums of the same
    float32 terms) within 1 float32 ulp, card against CPU."""
    from stereo_vision_tpu_torch.detect.checkerboard import _edge_width_means

    img = np.random.default_rng(4).integers(0, 256, (1080, 1920), dtype=np.uint8)
    t = torch.from_numpy(img)
    torch.testing.assert_close(_edge_width_means(t.to(dev)).cpu(), _edge_width_means(t), rtol=1.2e-7, atol=0)


def test_find_chessboard_corners_cuda_matches_cpu(dev):
    """Rendered 1920x1080 views of the CLI's 7x4 board, clean and degraded:
    the same ok flags, corners within 5e-3 px; every clean view found,
    within 0.5 px of the truth."""
    K = np.array([[1500.0, 0, 959.5], [0, 1500.0, 539.5], [0, 0, 1]])
    _, corners, (rvecs, tvecs) = board_views(3, 5, K, np.zeros(5), (1920, 1080), cols=7, rows=4, noise=0.0,
                                            margin=150.0, depth=(1800.0, 3500.0), return_poses=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        img, truth = render_board_view(K, rvecs[i], tvecs[i], (1920, 1080), 7, 4, device=dev)
        np.testing.assert_allclose(truth, corners[i], atol=1e-6)
        for j, view in enumerate((img, add_noise(img, 12.0, rng), motion_blur(img, 9, 40.0 * i), add_glare(img, rng))):
            ok, c = detect.find_chessboard_corners(view, (7, 4))
            ok_cpu, c_cpu = detect.find_chessboard_corners(view, (7, 4), device="cpu")
            assert ok == ok_cpu and (ok or j > 0)
            if ok:
                assert np.abs(c - c_cpu).max() <= 5e-3
            if j == 0:
                assert np.abs(c - truth).max() <= 0.5


@pytest.mark.parametrize("name", ["ball", "pose"])
def test_networks_cuda_match_cpu_in_float32(dev, name):
    load = pretrained.load_ball_detector if name == "ball" else pretrained.load_pose_net
    hw = pretrained.BALL_IMG_HW if name == "ball" else pretrained.POSE_IMG_HW
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (4, *hw, 3)).astype(np.float32))
    allow = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        out, ref = load(dev)(x.to(dev)), load("cpu")(x)
    assert torch.backends.cudnn.allow_tf32 == allow  # the forward restores the caller's setting
    for a, b in zip(out if name == "ball" else [out], ref if name == "ball" else [ref]):
        assert torch.allclose(a.cpu(), b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,out", [((1080, 1920), (72, 128)), ((1080, 1920), (144, 256)), ((77, 53), (31, 40))])
def test_letterbox_resize_cuda_equals_cpu(dev, shape, out):
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, *shape, 3), dtype=np.uint8))
    assert torch.equal(detect.image_ops.resize_bilinear_u8(img.to(dev), *out).cpu(),
                       detect.image_ops.resize_bilinear_u8(img, *out))


def test_pose_fusion_and_smoothing_cuda_match_cpu(dev):
    rng = np.random.default_rng(3)
    T = 40
    lm = np.zeros((2, T, 33, 4))
    base = np.cumsum(rng.normal(0, 2.0, (T, 33, 2)), axis=0) + [640, 360]
    lm[0, :, :, :2], lm[1, :, :, :2] = base, base - [40.0, 0.0]
    lm[..., 3] = np.where(rng.random((2, T, 33)) < 0.15, 0.1, 0.99)
    K = np.array([[1000.0, 0, 640], [0, 1000.0, 360], [0, 0, 1]])
    rig = track.StereoRig(K1=K, d1=np.zeros(8), K2=K, d2=np.zeros(8), R=np.eye(3), T=np.array([-500.0, 0, 0]))
    for dtype in (np.float64, np.float32):
        a = track.fusion.fuse_pose_sequence(lm[0].astype(dtype), lm[1].astype(dtype), rig.as_arrays(dev), device=dev)
        b = track.fusion.fuse_pose_sequence(lm[0].astype(dtype), lm[1].astype(dtype), rig.as_arrays("cpu"),
                                            device="cpu")
        assert torch.equal(a.isnan().cpu(), b.isnan())
        assert torch.allclose(a.cpu(), b, rtol=1e-9, atol=1e-8, equal_nan=True)
    poses = b.numpy()
    for method in ("savgol", "moving_average", "one_euro"):
        sa = track.MotionSmoother("smalliphone", device=dev, smoothing_method=method).smooth_pose_sequence(poses)
        sb = track.MotionSmoother("smalliphone", device="cpu", smoothing_method=method).smooth_pose_sequence(poses)
        np.testing.assert_allclose(sa, sb, rtol=1e-9, atol=1e-8)


def test_ball_detector_and_local_transport_cuda_match_cpu(dev):
    rig = track.StereoRig(K1=np.array([[350.0, 0, 160], [0, 350.0, 120], [0, 0, 1]]), d1=np.zeros(8),
                          K2=np.array([[350.0, 0, 160], [0, 350.0, 120], [0, 0, 1]]), d2=np.zeros(8), R=np.eye(3),
                          T=np.array([-500.0, 0, 0]))
    lf, *_ = scenes.render_ball_drop_stereo(rig, T=60, hold_frames=25, ball_radius_mm=80.0, seed=3)
    a = pretrained.detect_balls_in_frames(lf[::10], device=dev)
    b = pretrained.detect_balls_in_frames(lf[::10], device="cpu")
    assert [d is None for d in a] == [d is None for d in b]
    for d, e in zip(a, b):
        if d is not None:
            np.testing.assert_allclose(d, e, rtol=1e-4, atol=1e-3)
    hosted = [detect.HostedDetectorClient(detect.local_transport(device=d), hsv_range=None, radius_range=(2.0, 300.0),
                                          device=d).detect(lf[30]) for d in (dev, "cpu")]
    assert hosted[0] is not None and hosted[1] is not None
    np.testing.assert_allclose(hosted[0], hosted[1], rtol=1e-4, atol=1e-3)
