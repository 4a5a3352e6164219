"""The port's exact-SGBM plain forms against the JAX package (exact equality).

The same numpy arrays (seeded, int32 images / float32 maps) go to
``stereo_vision_tpu`` (scan backend on the CPU) and to
``stereo_vision_tpu_torch`` (plain PyTorch forms on the CPU).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_vision_tpu.ops import remap as jremap
from stereo_vision_tpu.stereo import depth as jdepth
from stereo_vision_tpu.stereo import postprocess as jpost
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch.convert import sgbm_params_from_reference
from stereo_vision_tpu_torch.ops import remap as tremap
from stereo_vision_tpu_torch.stereo import cost_cuda
from stereo_vision_tpu_torch.stereo import depth as tdepth
from stereo_vision_tpu_torch.stereo import postprocess as tpost
from stereo_vision_tpu_torch.stereo import sgbm as tsgbm
from stereo_vision_tpu_torch.stereo import sgm_cuda


def _pair(seed, H, W, D, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 2 * D)).astype(np.int32)
    return base[:, D : D + W].copy(), base[:, D - shift : D - shift + W].copy()


def _jparams(**kw):
    return jsgbm.StereoSGBMParams(backend="scan", **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mindisp,bs", [(0, 5), (3, 3), (2, 7), (-2, 5)])
def test_cost_volume_matches_jax(mindisp, bs):
    left, right = _pair(0, 21, 56, 16, 5)
    jp = _jparams(num_disparities=16, min_disparity=mindisp, block_size=bs)
    ref = np.asarray(jsgbm.compute_cost_volume(jnp.asarray(left), jnp.asarray(right), jp))
    mine = tsgbm.compute_cost_volume(_t(left), _t(right), sgbm_params_from_reference(jp)).numpy()
    assert mine.dtype == np.int16 and ref.dtype == np.int16
    np.testing.assert_array_equal(mine, ref)


def test_xsobel_matches_jax():
    left, _ = _pair(1, 13, 30, 8, 2)
    for ftz in (15, 31):
        ref = np.asarray(jsgbm._xsobel_clipped(jnp.asarray(left), ftz))
        np.testing.assert_array_equal(cost_cuda._xsobel_clipped(_t(left), ftz).numpy(), ref)


@pytest.mark.parametrize("num_paths", [2, 3, 4, 8])
def test_aggregate_8_matches_jax(num_paths):
    rng = np.random.default_rng(num_paths)
    C = rng.integers(0, 4700, (17, 23, 16)).astype(np.int32)
    ref = np.asarray(jsgbm._aggregate_8(jnp.asarray(C), 200, 800, backend="scan", num_paths=num_paths))
    mine = tsgbm._aggregate_8(_t(C)[None], 200, 800, num_paths=num_paths)[0].numpy()
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("uniq", [0, 10])
def test_wta_scan_matches_jax(uniq):
    rng = np.random.default_rng(7 + uniq)
    S = rng.integers(0, 300, (9, 14, 16)).astype(np.int32)  # many ties
    ref = jsgbm.wta_scan(jnp.asarray(S), 16, uniq)
    mine = sgm_cuda.wta_scan(_t(S), 16, uniq)
    for name, a, b in zip(("minS", "best", "sm", "s0", "sp", "uok"), mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_subpixel_disp16_matches_jax():
    rng = np.random.default_rng(3)
    D = 32
    best = rng.integers(0, D, (40, 50)).astype(np.int32)
    s0 = rng.integers(0, 5000, best.shape).astype(np.int32)
    sm = s0 + rng.integers(0, 800, best.shape).astype(np.int32)
    sp = s0 + rng.integers(0, 800, best.shape).astype(np.int32)
    ref = np.asarray(jsgbm.subpixel_disp16(*(jnp.asarray(a) for a in (best, sm, s0, sp)), D))
    mine = tsgbm.subpixel_disp16(*(_t(a) for a in (best, sm, s0, sp)), D).numpy()
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("mindisp,max_diff", [(0, 1), (4, 0)])
def test_lr_fail_matches_jax(mindisp, max_diff):
    rng = np.random.default_rng(11)
    H, W, ndisp = 12, 64, 16
    minX1 = mindisp + ndisp
    Wv = W - minX1
    minS = rng.integers(0, 2000, (H, Wv)).astype(np.int32)
    best = rng.integers(0, ndisp, (H, Wv)).astype(np.int32)
    disp = (best * 16 + rng.integers(-8, 9, (H, Wv))).astype(np.float32) / 16.0 + mindisp
    kw = dict(W=W, min_x=minX1, ndisp=ndisp, mindisp=mindisp, max_diff=max_diff)
    ref = np.asarray(jsgbm.lr_fail(jnp.asarray(minS), jnp.asarray(best), jnp.asarray(disp), backend="scan", **kw))
    mine = tsgbm.lr_fail(_t(minS)[None], _t(best)[None], _t(disp)[None], **kw)[0].numpy()
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("S,max_diameter", [(12, None), (25, 6)])
def test_speckle_filter_matches_jax(S, max_diameter):
    rng = np.random.default_rng(S)
    disp = rng.integers(0, 6, (2, 30, 41)).astype(np.float32)
    disp[rng.random(disp.shape) < 0.2] = -1.0
    ref = np.asarray(jpost.speckle_filter(jnp.asarray(disp), 1.0, S, -1.0, max_diameter=max_diameter))
    mine = tpost.speckle_filter(_t(disp), 1.0, S, -1.0, max_diameter=max_diameter).numpy()
    np.testing.assert_array_equal(mine, ref)


def test_remap_and_depth_match_jax():
    rng = np.random.default_rng(5)
    H, W = 24, 40
    img = rng.integers(0, 256, (H, W)).astype(np.int32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    mx = (xx + 0.37 * np.sin(yy / 3.0) - 0.5).astype(np.float32)
    my = (yy + 0.41 * np.cos(xx / 5.0) + 0.25).astype(np.float32)
    ref = np.asarray(jremap.remap_bilinear(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    mine = tremap.remap_bilinear(_t(img), _t(mx), _t(my)).numpy()
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(np.round(mine), np.asarray(jnp.round(jnp.asarray(ref))))

    disp = (rng.integers(-16, 40 * 16, (H, W)) / 16.0).astype(np.float32)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 700.0], [0, 0, 8.0, 0.5]], np.float32)
    # float32 on both sides; 1e-6 allows one rounding step of a fused
    # multiply-add that XLA may form where torch rounds twice.
    refp = np.asarray(jdepth.reproject_disparity_to_3d(jnp.asarray(disp), jnp.asarray(Q)))
    np.testing.assert_allclose(tdepth.reproject_disparity_to_3d(_t(disp), _t(Q)).numpy(), refp, rtol=1e-6)
    refz = np.asarray(jdepth.depth_from_disparity(jnp.asarray(disp), jnp.asarray(Q)))
    np.testing.assert_allclose(tdepth.depth_from_disparity(_t(disp), _t(Q)).numpy(), refz, rtol=1e-6)


# (num_paths, uniqueness, LR max diff, speckle window, min_disparity)
_CASES = [
    (8, 10, 1, 20, 0),
    (8, 0, -1, 0, 0),
    (8, 10, 0, 0, 4),
    (4, 10, 1, 0, 0),
    (4, 0, -1, 15, 2),
    (3, 10, 1, 10, 0),
    (2, 0, 1, 0, 0),
    (2, 10, -1, 20, 3),
    (8, 0, -1, 0, -8),
    (4, 10, -1, 15, -8),
]


@pytest.mark.parametrize("num_paths,uniq,lr,speckle,mindisp", _CASES)
def test_stereo_sgbm_matches_jax(num_paths, uniq, lr, speckle, mindisp):
    left, right = _pair(num_paths * 100 + uniq, 26, 72, 16, 6)
    jp = _jparams(num_disparities=16, min_disparity=mindisp, block_size=3, uniqueness_ratio=uniq,
                  disp12_max_diff=lr, speckle_window_size=speckle, speckle_range=2, num_paths=num_paths)
    ref = np.asarray(jsgbm.stereo_sgbm(jnp.asarray(left), jnp.asarray(right), jp))
    mine = tsgbm.stereo_sgbm(_t(left), _t(right), sgbm_params_from_reference(jp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref > mindisp - 1).mean() > 0.2  # the case exercises valid matches
