"""Bands above 64 (K % 4 == 0 up to 256), which the card takes through
``csrc/banded_wide.cu`` / ``banded_wide32.cu`` and the cost kernel: the
port's plain forms against the JAX package's ``stereo/banded.py`` at
K = 68 and 128, and the per-frame hierarchical entry at band 128, D=256,
against JAX's per-frame ``stereo_sgbm_hier`` (exact equality: every value
is an integer).

Inputs are numpy-seeded; shift maps are random per pixel on the G grid with
some steps off it, so neighbours differ by 0, +-G, +-2G and more (carry
shifts, resets and centre substitution all occur). The JAX side runs its
scan reference on the CPU. The kernels are held to these plain forms on the
card (``tests/test_torch_cuda.py``).
"""

import jax
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import banded as jb
from stereo_vision_tpu.stereo import hier as jh
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.stereo import banded as tb
from stereo_vision_tpu_torch.stereo import banded_cuda, hier
from stereo_vision_tpu_torch.synth.scenes import scene

H, W = 10, 40
# K -> (G, D, min_x)
BANDS = {68: (4, 96, 8), 128: (16, 256, 0)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _shift_map(rng, D, K, G, P=1):
    """Per-pixel shifts in [0, D - K]: on the G grid, one in ten off it."""
    s = rng.integers(0, (D - K) // G + 1, (P, H, W)) * G
    s = s + (rng.random((P, H, W)) < 0.1) * rng.integers(1, 3, (P, H, W))
    return np.minimum(s, D - K).astype(np.int32)


def _pair(rng):
    left = rng.integers(0, 256, (1, H, W)).astype(np.int32)
    right = np.clip(np.roll(left, -7, axis=2) + rng.integers(-3, 4, left.shape), 0, 255).astype(np.int32)
    return left, right


def _jparams(D, **kw):
    return jsgbm.StereoSGBMParams(num_disparities=D, block_size=5, uniqueness_ratio=10, backend="scan", **kw)


@pytest.mark.parametrize("K", list(BANDS))
def test_wide_band_cost_matches_jax(K):
    G, D, min_x = BANDS[K]
    rng = np.random.default_rng(K)
    left, right = _pair(rng)
    s = _shift_map(rng, D, K, G)
    ref = jax.jit(lambda a, b, sv: jb.banded_cost_volume(a, b, sv, _jparams(D), K, G))(left[0], right[0], s[0])
    mine = tb.banded_cost_volume(_t(left), _t(right), _t(s), band=K, G=G, ndisp=D)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref))
    out = banded_cuda.banded_cost(_t(left), _t(right), _t(s), band=K, G=G, ndisp=D, min_x=min_x)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref)[:, min_x:])


@pytest.mark.parametrize("K,num_paths", [(68, 3), (68, 8), (128, 3), (128, 8)])
def test_wide_band_aggregation_matches_jax(K, num_paths):
    """aggregate_banded_scan, and the sum of the wrappers' plain forms."""
    G, D, _ = BANDS[K]
    rng = np.random.default_rng(K + num_paths)
    C = rng.integers(0, 2326, (1, H, W, K)).astype(np.int32)
    s = _shift_map(rng, D, K, G)
    P1, P2 = 200, 800
    ref = np.asarray(jax.jit(lambda c, sv: jb.aggregate_banded_scan(c, sv, G, P1, P2, num_paths))(C[0], s[0]))
    np.testing.assert_array_equal(tb.aggregate_banded_scan(_t(C), _t(s), G, P1, P2, num_paths)[0].numpy(), ref)
    Ct, st = _t(C).to(torch.int16), _t(s)
    dn, up = banded_cuda.banded_vertical(Ct, st, G, P1, P2, cost_bound=2325, with_diagonals=num_paths == 8)
    S = dn + up + banded_cuda.banded_horizontal(Ct, st, G, P1, P2, cost_bound=2325)
    if num_paths == 8:
        S = S + banded_cuda.banded_horizontal(Ct, st, G, P1, P2, cost_bound=2325, reverse=True)
    np.testing.assert_array_equal(S[0].numpy(), ref)


@pytest.mark.parametrize("K,num_paths,sub", [(68, 3, True), (128, 8, False)])
def test_wide_band_stats_match_jax(K, num_paths, sub):
    """banded_stats_scan, and banded_stats_pack's plain forms (the WTA's
    6-stat and sub forms at these bands)."""
    G, D, min_x = BANDS[K]
    rng = np.random.default_rng(3 * K)
    left, right = _pair(rng)
    s = _shift_map(rng, D, K, G)
    jp = _jparams(D, num_paths=num_paths)
    ref = jax.jit(lambda a, b, sv: jb.banded_stats_scan(a, b, sv, jp, K, G, min_x, sub=sub))(left[0], right[0], s[0])
    tp = convert.sgbm_params_from_reference(jp)
    mine = tb.banded_stats_scan(_t(left), _t(right), _t(s), tp, K, G, min_x, sub=sub)
    packed = banded_cuda.banded_stats_pack(_t(left), _t(right), _t(s), tp, K, G, min_x, sub=sub)
    assert len(mine) == len(packed) == len(ref) == (4 if sub else 6)
    for a, b, want in zip(mine, packed, ref):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(want))
        assert torch.equal(a, b)


def test_hier_band_128_matches_jax():
    """The per-frame entry at band 128, granularity 8, D=256 (valid for both
    packages: 256 % 64 == 0, (256 - 128) % 8 == 0; the card took no band
    above 64 before), against JAX's per-frame ``stereo_sgbm_hier`` under one
    jit."""
    left, right = (a.astype(np.int32) for a in scene(seed=6, H=32, W=320))
    jp = jsgbm.StereoSGBMParams(num_disparities=256, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                                speckle_window_size=30, speckle_range=2, num_paths=3, backend="scan")
    jhp = jh.HierParams(band=128, granularity=8)
    ref = np.asarray(jax.jit(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, jhp))(left, right))
    mine = hier.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                                 convert.hier_params_from_reference(jhp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref[:, 256:] > -1).mean() > 0.5  # the columns x >= D that can be valid

