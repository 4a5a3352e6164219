"""Settings the reference computes and the port once refused, held to the
JAX package on the CPU (exact equality: every map is an integer or k/16):

- a frame smaller than the BM block: the reference's map is all invalid;
- an even ``block_size`` on the SGBM paths: a window from -bs//2 to
  bs//2 - 1 on each axis, on the exact path, the banded cost and the
  per-frame hier;
- ``hier_params`` with ``matcher="sgbm"`` or ``"bm"``: ignored, as the
  reference ignores it (``test_torch_pipeline.py`` holds those matchers'
  pipelines to JAX's).

The same numpy-seeded inputs go to ``stereo_vision_tpu`` (scan / XLA
backends on the CPU; the hier through the per-frame ``stereo_sgbm_hier``
under one jit) and to ``stereo_vision_tpu_torch`` (plain forms on the
CPU). The kernels are held to these plain forms on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import banded as jb
from stereo_vision_tpu.stereo import bm as jbm
from stereo_vision_tpu.stereo import hier as jh
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.parallel import streaming as tstream
from stereo_vision_tpu_torch.stereo import banded_cuda, cost_cuda, hier
from stereo_vision_tpu_torch.stereo import bm as tbm
from stereo_vision_tpu_torch.stereo import sgbm as tsgbm
from stereo_vision_tpu_torch.stereo.bm import StereoBMParams
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams
from stereo_vision_tpu_torch.synth.scenes import scene

NARROW_HP = jh.HierParams(band=16, granularity=8, tile=1, local_window=1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pairs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape).astype(np.int32) for _ in range(2))


@pytest.mark.parametrize("H,W", [(4, 20), (20, 4), (5, 5)])
def test_bm_frame_smaller_than_block_matches_jax(H, W):
    """ROADMAP C.2's inputs (D=8, block 5): no window fits 4x20 or 20x4,
    and the reference's XLA path returns an all-invalid map; 5x5 holds one
    window."""
    left, right = _pairs(1, (H, W))
    jp = jbm.StereoBMParams(num_disparities=8, block_size=5, backend="xla")
    ref = np.asarray(jbm.stereo_bm(jnp.asarray(left), jnp.asarray(right), jp))
    mine = tbm.stereo_bm(_t(left), _t(right), convert.bm_params_from_reference(jp))
    assert mine.shape == (H, W)
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert (ref == -1).all()


@pytest.mark.parametrize("block,num_paths", [(4, 8), (2, 3), (6, 8)])
def test_even_block_stereo_sgbm_matches_jax(block, num_paths):
    """ROADMAP C.3's input (12x56, D=16, block 4, pairs from
    default_rng(7)) and blocks 2 and 6: P1 and P2 default from the block."""
    left, right = _pairs(7, (12, 56))
    jp = jsgbm.StereoSGBMParams(num_disparities=16, block_size=block, num_paths=num_paths, uniqueness_ratio=5,
                                backend="scan")
    ref = np.asarray(jsgbm.stereo_sgbm(jnp.asarray(left), jnp.asarray(right), jp))
    params = convert.sgbm_params_from_reference(jp)
    assert (params.P1, params.P2) == (8 * block * block, 32 * block * block)
    mine = tsgbm.stereo_sgbm(_t(left), _t(right), params).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref > -1).mean() > 0.2
    assert cost_cuda.cost_dtype(block, params.ftzero) == torch.int16


@pytest.mark.parametrize("block", [2, 4, 6])
def test_even_block_banded_cost_matches_jax(block):
    """The banded cost's even window (rows, then columns, each aligned into
    the centre's band) on per-pixel random shift maps."""
    rng = np.random.default_rng(5)
    left = rng.integers(0, 256, (2, 20, 80)).astype(np.int32)
    right = np.clip(np.roll(left, -7, axis=2) + rng.integers(-3, 4, left.shape), 0, 255).astype(np.int32)
    s = (rng.integers(0, 9, (2, 20, 80)) * 4).astype(np.int32)
    jp = jsgbm.StereoSGBMParams(num_disparities=48, block_size=block, backend="scan")
    ref = jax.vmap(lambda a, b, sv: jb.banded_cost_volume(a, b, sv, jp, 12, 4))(left, right, s)
    out = banded_cuda.banded_cost(_t(left), _t(right), _t(s), band=12, G=4, ndisp=48, block_size=block, min_x=48)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref)[:, :, 48:])


def test_even_block_hier_per_frame_matches_jax():
    """The per-frame hier at block 4 (its exact coarse pass and its banded
    levels both take the even window)."""
    left, right = (a.astype(np.int32) for a in scene(seed=2, H=32, W=128))
    jp = jsgbm.StereoSGBMParams(num_disparities=64, block_size=4, uniqueness_ratio=10, disp12_max_diff=1,
                                num_paths=3, backend="scan")
    ref = np.asarray(jax.jit(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, NARROW_HP))(left, right))
    mine = hier.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                                 convert.hier_params_from_reference(NARROW_HP))
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert (ref > -1).mean() > 0.2


@pytest.mark.parametrize("matcher", ["sgbm", "bm"])
def test_other_matchers_ignore_hier_params(matcher):
    """ROADMAP C.4: the reference reads ``hier_params`` only in its hier
    branch (``stereo_vision_tpu/parallel/streaming.py:74-128``); the port's
    other matchers return what they return without it."""
    frames = [scene(seed=s, H=24, W=96) for s in range(2)]
    L, R = (np.stack([f[i] for f in frames]) for i in (0, 1))
    yy, xx = np.mgrid[0:24, 0:96].astype(np.float32)
    maps = (xx + 0.2, yy, xx, yy + 0.1)
    Q = np.array([[1, 0, 0, -48], [0, 1, 0, -12], [0, 0, 0, 300.0], [0, 0, 10.0, 0]], np.float32)
    params = (StereoSGBMParams(num_disparities=16, uniqueness_ratio=10) if matcher == "sgbm"
              else StereoBMParams(num_disparities=16, block_size=5))
    run = lambda **kw: tstream.batched_stereo_pipeline(L, R, maps, Q, matcher=matcher, params=params, device="cpu",
                                                       **kw)
    (d0, p0), (d1, p1) = run(), run(hier_params=hier.HIER_FAST)
    assert torch.equal(d0, d1)
    torch.testing.assert_close(p1, p0, rtol=0, atol=0, equal_nan=True)
    assert (d0 > -1).any()
