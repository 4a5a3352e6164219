"""A frame no wider than its disparity range, which the reference computes
and the port once refused, held to the JAX package on the CPU (exact
equality: the disparities are k/16): ``stereo_sgbm``, the per-frame and
batched hier and ``batched_stereo_pipeline`` return the reference's map,
all invalid where no column sees the full range (the even blocks, small BM
frames and ``hier_params`` are in ``test_torch_small_settings.py``).

The same numpy-seeded inputs go to ``stereo_vision_tpu`` (scan / XLA
backends on the CPU; the hier paths through the per-frame
``stereo_sgbm_hier`` under one jit) and to ``stereo_vision_tpu_torch``
(plain forms on the CPU). The kernels are held to these plain forms on
the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.parallel import streaming as jstream
from stereo_vision_tpu.stereo import hier as jh
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.parallel import streaming as tstream
from stereo_vision_tpu_torch.stereo import hier
from stereo_vision_tpu_torch.stereo import sgbm as tsgbm
from stereo_vision_tpu_torch.synth.scenes import scene

# ROADMAP C.1's hier input: 32x64, D=64, band 16, G 8, tile 1, local window 1.
NARROW_HP = jh.HierParams(band=16, granularity=8, tile=1, local_window=1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pairs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape).astype(np.int32) for _ in range(2))


@pytest.mark.parametrize("H,W,D,mindisp", [(8, 16, 16, 0), (8, 12, 16, 0), (8, 16, 8, 8), (8, 17, 16, 0)])
def test_sgbm_frame_no_wider_than_range_matches_jax(H, W, D, mindisp):
    """ROADMAP C.1's exact-path inputs: at W <= min_disparity + D every
    pixel is invalid (min_disparity - 1); 8x17 is the first width with a
    column."""
    left, right = _pairs(0, (H, W))
    jp = jsgbm.StereoSGBMParams(num_disparities=D, min_disparity=mindisp, block_size=3, backend="scan")
    ref = np.asarray(jsgbm.stereo_sgbm(jnp.asarray(left), jnp.asarray(right), jp))
    mine = tsgbm.stereo_sgbm(_t(left), _t(right), convert.sgbm_params_from_reference(jp))
    assert mine.shape == (H, W) and mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert (ref == mindisp - 1).all() == (W <= mindisp + D)


@pytest.mark.parametrize("W", [64, 67])
def test_hier_per_frame_no_wider_than_range_matches_jax(W):
    """ROADMAP C.1's per-frame hier input (W = 64: the coarse level and the
    full level have no column) and W = 67 (the coarse level has none, the
    full level three), against JAX's per-frame ``stereo_sgbm_hier``."""
    left, right = (a.astype(np.int32) for a in scene(seed=3, H=32, W=W, box_disp=20))
    jp = jsgbm.StereoSGBMParams(num_disparities=64, backend="scan")
    ref = np.asarray(jax.jit(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, NARROW_HP))(left, right))
    mine = hier.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                                 convert.hier_params_from_reference(NARROW_HP))
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert (ref == -1).all() == (W == 64)


def test_hier_batch_and_pipeline_no_wider_than_range_match_jax():
    """``stereo_sgbm_hier_batch`` (8 frames, band 16) and the streaming
    pipeline at 32x64, D=64: each frame equals JAX's per-frame hier; the
    exact pipeline's frames equal JAX's ``batched_stereo_pipeline``."""
    frames = [scene(seed=s, H=32, W=64, box_disp=20) for s in range(8)]
    L, R = (np.stack([f[i] for f in frames]).astype(np.int32) for i in (0, 1))
    jp = jsgbm.StereoSGBMParams(num_disparities=64, uniqueness_ratio=10, disp12_max_diff=1, speckle_window_size=30,
                                speckle_range=2, backend="scan")
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, NARROW_HP)))(L[:2], R[:2]))
    params, hp = convert.sgbm_params_from_reference(jp), convert.hier_params_from_reference(NARROW_HP)
    mine = hier.stereo_sgbm_hier_batch(_t(L), _t(R), params, hp)
    np.testing.assert_array_equal(mine[:2].numpy(), ref)
    assert (mine == -1).all()
    yy, xx = np.mgrid[0:32, 0:64].astype(np.float32)
    maps, Q = (xx, yy, xx, yy), np.eye(4, dtype=np.float32)
    disp, pts = tstream.batched_stereo_pipeline(L, R, maps, Q, matcher="sgbm_hier", params=params, hier_params=hp,
                                                device="cpu")
    assert torch.equal(disp, mine) and pts.shape == (8, 32, 64, 3)
    jd, _ = jstream.batched_stereo_pipeline(jnp.asarray(L[:2]), jnp.asarray(R[:2]), maps, Q, matcher="sgbm", params=jp)
    td, _ = tstream.batched_stereo_pipeline(L[:2], R[:2], maps, Q, matcher="sgbm", params=params, device="cpu")
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
