"""Disparity ranges and bands above 1024, and blocks whose exact cost kernel
once passed a block's shared memory: the port's plain forms against the
JAX package, exact (every value is an integer or k/16).

- ``stereo_sgbm`` at D = 1040 with the LR check (8 paths) and at D = 2064
  without it (4 paths), against JAX's ``stereo_sgbm`` (scan backend);
- ``stereo_bm`` at ndisp 1040, against JAX's XLA path;
- the banded core at K = 1028: the cost against JAX's ``banded_cost_volume``,
  the aggregation against ``aggregate_banded_scan`` and the statistics
  against ``banded_stats_scan``;
- ``compute_pixel_cost`` and ``cost_volume_plain`` at blocks 45 and 51.

The card takes each of these through the forms that walk a range in steps
of 32 (``csrc/wide_range.cuh``) and the exact cost kernel's disparity
chunks; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold them to
these plain forms there. Inputs are numpy-seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import banded as jb
from stereo_vision_tpu.stereo import bm as jbm
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.stereo import banded as tb
from stereo_vision_tpu_torch.stereo import banded_cuda, bm, cost_cuda, sgbm


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(seed, B, H, W, shift, noise=3):
    """A random pair of disparity ``shift``: right[x - shift] = left[x], with noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, H, W + shift)).astype(np.int32)
    right = np.clip(base[..., shift:] + rng.integers(-noise, noise + 1, (B, H, W)), 0, 255)
    return base[..., :W].copy(), right.astype(np.int32)


@pytest.mark.parametrize("D,W,num_paths,lr,speckle", [(1040, 1100, 8, 1, 20), (2064, 2112, 4, -1, 0)])
def test_stereo_sgbm_any_range_matches_jax(D, W, num_paths, lr, speckle):
    left, right = _pair(D, 1, 4, W, D - 21)
    jp = jsgbm.StereoSGBMParams(num_disparities=D, block_size=3, uniqueness_ratio=10, disp12_max_diff=lr,
                                speckle_window_size=speckle, speckle_range=2, num_paths=num_paths, backend="scan")
    ref = np.asarray(jsgbm.stereo_sgbm(jnp.asarray(left[0]), jnp.asarray(right[0]), jp))
    mine = sgbm.stereo_sgbm(_t(left[0]), _t(right[0]), convert.sgbm_params_from_reference(jp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref[:, D:] == D - 21).mean() > 0.3  # the columns that see the whole range match


def test_stereo_bm_range_1040_matches_jax():
    left, right = _pair(11, 1, 16, 1120, 1001)
    jp = jbm.StereoBMParams(num_disparities=1040, block_size=7, uniqueness_ratio=15, texture_threshold=10,
                            backend="xla")
    ref = np.asarray(jbm.stereo_bm(jnp.asarray(left[0]), jnp.asarray(right[0]), jp))
    mine = bm.stereo_bm(_t(left[0]), _t(right[0]), convert.bm_params_from_reference(jp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (np.abs(ref[:, 1050:] - 1001) <= 1).mean() > 0.5  # the window centres that see the whole range


K, G, ND, BH, BW = 1028, 4, 1040, 4, 1100  # band, granularity, range and the banded tests' frame


def _band_inputs(seed):
    rng = np.random.default_rng(seed)
    left, right = _pair(seed, 1, BH, BW, 5)
    s = rng.integers(0, (ND - K) // G + 1, (1, BH, BW)) * G  # per pixel: every delta case
    s = np.minimum(s + (rng.random((1, BH, BW)) < 0.1) * rng.integers(1, 3, (1, BH, BW)), ND - K)
    return left, right, s.astype(np.int32)


def test_banded_cost_band_1028_matches_jax():
    left, right, s = _band_inputs(1)
    jp = jsgbm.StereoSGBMParams(num_disparities=ND, block_size=5, backend="scan")
    ref = np.asarray(jax.jit(lambda a, b, sv: jb.banded_cost_volume(a, b, sv, jp, K, G))(left[0], right[0], s[0]))
    out = banded_cuda.banded_cost(_t(left), _t(right), _t(s), band=K, G=G, ndisp=ND, min_x=40)
    np.testing.assert_array_equal(out[0].numpy(), ref[:, 40:])


@pytest.mark.parametrize("num_paths", [3, 8])
def test_banded_scans_band_1028_match_jax(num_paths):
    """aggregate_banded_scan on a (1, 4, 24, 1028) volume, and the sum of
    the wrappers' plain forms."""
    rng = np.random.default_rng(num_paths)
    C = rng.integers(0, 2326, (1, BH, 24, K)).astype(np.int32)
    s = np.minimum(rng.integers(0, (ND - K) // G + 1, (1, BH, 24)) * G + (rng.random((1, BH, 24)) < 0.2), ND - K)
    s = s.astype(np.int32)
    P1, P2 = 200, 800
    ref = np.asarray(jax.jit(lambda c, sv: jb.aggregate_banded_scan(c, sv, G, P1, P2, num_paths))(C[0], s[0]))
    Ct, st = _t(C).to(torch.int16), _t(s)
    dn, up = banded_cuda.banded_vertical(Ct, st, G, P1, P2, cost_bound=2325, with_diagonals=num_paths == 8)
    S = dn + up + banded_cuda.banded_horizontal(Ct, st, G, P1, P2, cost_bound=2325)
    if num_paths == 8:
        S = S + banded_cuda.banded_horizontal(Ct, st, G, P1, P2, cost_bound=2325, reverse=True)
    np.testing.assert_array_equal(S[0].numpy(), ref)


def test_banded_stats_band_1028_match_jax():
    """banded_stats_scan at 3 paths, and banded_stats_pack's plain forms
    (the WTA's sub form at this band)."""
    left, right, s = _band_inputs(2)
    left, right, s = left[:, :, :80], right[:, :, :80], s[:, :, :80]
    jp = jsgbm.StereoSGBMParams(num_disparities=ND, block_size=5, uniqueness_ratio=10, num_paths=3, backend="scan")
    ref = jax.jit(lambda a, b, sv: jb.banded_stats_scan(a, b, sv, jp, K, G, 40, sub=True))(left[0], right[0], s[0])
    tp = convert.sgbm_params_from_reference(jp)
    packed = banded_cuda.banded_stats_pack(_t(left), _t(right), _t(s), tp, K, G, 40, sub=True)
    assert len(packed) == len(ref) == 4
    for a, want in zip(packed, ref):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(want))
    mine = tb.banded_stats_scan(_t(left), _t(right), _t(s), tp, K, G, 40, sub=True)
    assert all(torch.equal(a, b) for a, b in zip(mine, packed))


@pytest.mark.parametrize("block_size", [45, 51])
def test_cost_volume_large_blocks_match_jax(block_size):
    """Blocks whose windows at D = 1024 once passed the exact cost kernel's
    shared memory (it now keeps its column sums in device scratch there):
    the per-pixel cost and the windowed volume (int32), frames shorter than
    the block included."""
    left, right = _pair(block_size, 1, 30, 160, 9)
    jp = jsgbm.StereoSGBMParams(num_disparities=64, block_size=block_size, backend="scan")
    tp = convert.sgbm_params_from_reference(jp)
    for rows in (30, 7):
        l, r = left[0, :rows], right[0, :rows]
        pix = sgbm.compute_pixel_cost(_t(l), _t(r), tp)
        np.testing.assert_array_equal(pix.numpy(), np.asarray(jsgbm.compute_pixel_cost(l, r, jp)))
        ref = np.asarray(jsgbm.compute_cost_volume(l, r, jp))
        mine = cost_cuda.cost_volume(_t(l)[None], _t(r)[None], ndisp=64, block_size=block_size, x_offset=64)
        assert mine.dtype == torch.int32
        np.testing.assert_array_equal(mine[0].numpy(), ref[:, 64:])
