"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Every test here needs an NVIDIA GPU with nvcc (they skip elsewhere); the
file imports neither JAX nor the JAX package, so on a machine without
them it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Exact equality throughout: every value is an integer (disparities are
k/16); the geometry ops, float64 on both sides, are held within 1e-9.
"""

import numpy as np
import pytest
import torch

from stereo_vision_tpu_torch import ops
from stereo_vision_tpu_torch.parallel.streaming import batched_stereo_pipeline
from stereo_vision_tpu_torch.stereo import banded_cuda, bm, bm_cuda, cost_cuda, hier, lr_cuda, sgm_cuda, speckle_cuda
from stereo_vision_tpu_torch.stereo.hier import HIER4_FAST, HIER_FAST
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, lr_fail, stereo_sgbm
from stereo_vision_tpu_torch.synth.scenes import scene

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
    n_ds, n_lr = banded_cuda.downsample_box.launches, lr_cuda.lr_fail_packed.launches
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, matcher="sgbm_hier", params=p, hier_params=HIER_FAST)
    assert banded_cuda.downsample_box.launches == n_ds + 2 and lr_cuda.lr_fail_packed.launches == n_lr + 1
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
    rng = np.random.default_rng(K * Wv + G)
    C = torch.from_numpy(rng.integers(0, 2326, (P, H, Wv, K)).astype(np.int16))
    s = rng.integers(0, 5, (P, H, Wv)) * G + (rng.random((P, H, Wv)) < 0.1) * rng.integers(1, 3, (P, H, Wv))
    s = torch.from_numpy(s.astype(np.int32))
    P1, P2 = 200, 800
    n, nd = banded_cuda.banded_vertical.launches, banded_cuda.banded_vertical.diagonal_launches
    dn, up = banded_cuda.banded_vertical(C.to(dev), s.to(dev), G, P1, P2, cost_bound=2325, with_diagonals=True)
    torch.cuda.synchronize()
    assert banded_cuda.banded_vertical.launches == n + 1 and banded_cuda.banded_vertical.diagonal_launches == nd + 1
    ref_dn, ref_up = banded_cuda.vertical_plain(C, s, G, P1, P2, True)
    assert dn.dtype == torch.int16
    assert torch.equal(dn.cpu().to(torch.int32), ref_dn) and torch.equal(up.cpu().to(torch.int32), ref_up)


def test_banded_diagonal_vertical_refuses_wide_rows(dev):
    C = torch.zeros((1, 2, 4097, 4), dtype=torch.int16, device=dev)
    s = torch.zeros((1, 2, 4097), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="does not take 4097 columns"):
        banded_cuda.banded_vertical(C, s, 2, 200, 800, cost_bound=2325, with_diagonals=True)


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
    lp = torch.zeros((1, 16, 300), dtype=torch.int32, device=dev)
    kw = dict(ndisp=16, mindisp=0, block_size=5, cap=31, uniq=15, tex_thr=10)
    with pytest.raises(ValueError, match="256"):
        bm_cuda.bm_disparity(lp, lp, **dict(kw, ndisp=272))
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
# min_disparity, bands K % 4 == 0 up to 64; and the group-per-row banded
# horizontal scan.


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
    C = torch.from_numpy(rng.integers(0, 2326, (P, H, Wv, K)).astype(np.int32)).to(dtype)
    s = _random_shift_map(rng, P, H, Wv, G)
    bound = 2325 if dtype == torch.int16 else 40000
    for diag in (False, True):
        out = banded_cuda.banded_vertical(C.to(dev), s.to(dev), G, 200, 800, cost_bound=bound, with_diagonals=diag)
        ref = banded_cuda.vertical_plain(C, s, G, 200, 800, diag)
        assert all(a.dtype == dtype and torch.equal(a.cpu().to(torch.int32), b) for a, b in zip(out, ref))
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
