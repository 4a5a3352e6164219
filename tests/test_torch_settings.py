"""Settings the reference computes and the port's CUDA kernels once refused,
held to the JAX package on the CPU (exact equality):

- a negative ``min_disparity`` on the exact path, with the JAX cost's
  ``dynamic_slice`` clamp (a plane d with ``min_disparity + d < 0`` is the
  plane of shift 0);
- blocks whose windowed cost or 8-path direction sums leave int16 (block 11
  at 8 paths, block 13), which the kernels now store as int32;
- a band off the powers of two (12) in the per-frame hierarchical entry.

The same numpy-seeded arrays go to ``stereo_vision_tpu`` (scan backend on
the CPU) and to ``stereo_vision_tpu_torch`` (plain forms on the CPU). The
kernels themselves are held to these plain forms on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import banded as jb
from stereo_vision_tpu.stereo import hier as jh
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.stereo import banded_cuda, cost_cuda, hier, sgm_cuda
from stereo_vision_tpu_torch.stereo import sgbm as tsgbm
from stereo_vision_tpu_torch.synth.scenes import scene


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_negative_min_disparity_matches_jax():
    """The 24x96 pair of ROADMAP.md's C.1 entry: right = left shifted by 5."""
    left = np.random.default_rng(0).integers(0, 255, (24, 96)).astype(np.int32)
    right = np.roll(left, -5, axis=1)
    jp = jsgbm.StereoSGBMParams(num_disparities=16, min_disparity=-8, disp12_max_diff=-1, speckle_window_size=0,
                                backend="scan")
    ref = np.asarray(jsgbm.stereo_sgbm(jnp.asarray(left), jnp.asarray(right), jp))
    mine = tsgbm.stereo_sgbm(_t(left), _t(right), convert.sgbm_params_from_reference(jp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref > -9).mean() > 0.5 and (ref[:, 8:] == 5.0).mean() > 0.5
    # The cost wrapper takes it too (a CPU tensor runs the plain form).
    C = cost_cuda.cost_volume(_t(left)[None], _t(right)[None], ndisp=16, mindisp=-8, x_offset=8)
    assert C.shape == (1, 24, 88, 16) and C.dtype == torch.int16


def test_bt_channel_cost_clamps_negative_shifts_as_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 255, (6, 20)).astype(np.int32)
    b = np.roll(a, -3, axis=1)
    ref = np.asarray(jsgbm._bt_channel_cost(jnp.asarray(a), jnp.asarray(b), 4, -2))
    mine = cost_cuda._bt_channel_cost(_t(a), _t(b), 4, -2).numpy()
    np.testing.assert_array_equal(mine, ref)
    at0 = cost_cuda._bt_channel_cost(_t(a), _t(b), 4, 0).numpy()
    for d in range(3):  # shifts -2, -1 and 0 all read shift 0
        np.testing.assert_array_equal(mine[..., d], at0[..., 0])
    np.testing.assert_array_equal(mine[..., 3], at0[..., 1])
    with pytest.raises(ValueError, match="no disparity >= 0"):
        cost_cuda._bt_channel_cost(_t(a), _t(b), 4, -5)


@pytest.mark.parametrize("block,num_paths", [(11, 8), (13, 8), (13, 3)])
def test_wide_blocks_match_jax(block, num_paths):
    left, right = scene(seed=block + num_paths, H=24, W=96)
    jp = jsgbm.StereoSGBMParams(num_disparities=16, block_size=block, uniqueness_ratio=10, disp12_max_diff=1,
                                num_paths=num_paths, backend="scan")
    ref = np.asarray(jsgbm.stereo_sgbm(jnp.asarray(left), jnp.asarray(right), jp))
    params = convert.sgbm_params_from_reference(jp)
    mine = tsgbm.stereo_sgbm(_t(left), _t(right), params).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref > -1).mean() > 0.3
    # What the kernels store these settings in: int32 past int16's bound.
    ndir = 3 if num_paths == 8 else 1
    want = torch.int32 if (block, num_paths) != (13, 3) else torch.int16
    assert sgm_cuda.storage_dtype(params.cost_bound, params.P2, ndir) == want


def test_banded_cost_wide_block_matches_jax():
    """Block 19: a window's bound (361 x 93) passes int16, so the cost is int32."""
    rng = np.random.default_rng(13)
    left = rng.integers(0, 256, (2, 20, 80)).astype(np.int32)
    right = np.clip(np.roll(left, -7, axis=2) + rng.integers(-3, 4, left.shape), 0, 255).astype(np.int32)
    s = (rng.integers(0, 9, (2, 20, 80)) * 4).astype(np.int32)
    jp = jsgbm.StereoSGBMParams(num_disparities=48, block_size=19, backend="scan")
    ref = jax.vmap(lambda a, b, sv: jb.banded_cost_volume(a, b, sv, jp, 12, 4))(left, right, s)
    out = banded_cuda.banded_cost(_t(left), _t(right), _t(s), band=12, G=4, ndisp=48, block_size=19, min_x=48)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref)[:, :, 48:])


def test_hier_band_12_matches_jax():
    """The per-frame entry at band 12, granularity 4 (no mid level; D=128,
    so (D - band) % granularity == 0), against JAX's per-frame
    ``stereo_sgbm_hier`` under one jit."""
    left, right = (a.astype(np.int32) for a in scene(seed=4, H=32, W=192))
    jp = jsgbm.StereoSGBMParams(num_disparities=128, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                                speckle_window_size=30, speckle_range=2, num_paths=3, backend="scan")
    jhp = jh.HierParams(band=12, granularity=4)
    ref = np.asarray(jax.jit(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, jhp))(left, right))
    mine = hier.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                                 convert.hier_params_from_reference(jhp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref > -1).mean() > 0.2
