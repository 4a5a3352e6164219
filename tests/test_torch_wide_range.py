"""Disparity ranges and bands above 256, which the card takes up to 1024:
the port's plain forms against the JAX package, exact (every value is an
integer or k/16).

- ``stereo_sgbm`` at D = 320 (8 and 4 paths, LR check and speckle on) and
  D = 512 (3 paths), against JAX's ``stereo_sgbm`` (scan backend);
- ``stereo_bm`` at ndisp 320, against JAX's XLA path;
- the per-frame ``stereo_sgbm_hier`` at D = 512, band 320, G = 8, against
  JAX's per-frame entry under one jit (never the batch entry in interpret
  mode: its compile alone takes about a minute);
- ``banded_cost_plain`` at band 256, block 21 (where no tile of the cost
  kernel fits a block's shared memory), against JAX's ``banded_cost_volume``.

The CUDA kernels are held to these plain forms on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); the limit test holds the
refusals left to the reference's own. Inputs are numpy-seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import banded as jb
from stereo_vision_tpu.stereo import bm as jbm
from stereo_vision_tpu.stereo import lr_pallas as jlr
from stereo_vision_tpu.stereo import hier as jh
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.stereo import banded_cuda, bm, cost_cuda, hier, sgbm
from stereo_vision_tpu_torch.synth.scenes import scene


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(seed, B, H, W, shift, noise=3):
    """A random pair of disparity ``shift``: right[x - shift] = left[x], with noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, H, W + shift)).astype(np.int32)
    right = np.clip(base[..., shift:] + rng.integers(-noise, noise + 1, (B, H, W)), 0, 255)
    return base[..., :W].copy(), right.astype(np.int32)


@pytest.mark.parametrize("D,W,num_paths,lr,speckle", [(320, 352, 8, 1, 20), (320, 344, 4, -1, 0),
                                                      (512, 536, 3, 1, 10)])
def test_stereo_sgbm_wide_range_matches_jax(D, W, num_paths, lr, speckle):
    left, right = _pair(D + num_paths, 1, 8, W, D - 13)
    jp = jsgbm.StereoSGBMParams(num_disparities=D, block_size=3, uniqueness_ratio=10, disp12_max_diff=lr,
                                speckle_window_size=speckle, speckle_range=2, num_paths=num_paths, backend="scan")
    ref = np.asarray(jsgbm.stereo_sgbm(jnp.asarray(left[0]), jnp.asarray(right[0]), jp))
    mine = sgbm.stereo_sgbm(_t(left[0]), _t(right[0]), convert.sgbm_params_from_reference(jp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref[:, D:] > -1).mean() > 0.5  # the columns that see the whole range match
    assert (ref[:, D:] == D - 13).mean() > 0.3


def test_stereo_bm_wide_range_matches_jax():
    left, right = _pair(7, 2, 24, 380, 301)
    jp = jbm.StereoBMParams(num_disparities=320, block_size=9, uniqueness_ratio=15, texture_threshold=10,
                            backend="xla")
    ref = np.asarray(jax.jit(jax.vmap(lambda l, r: jbm.stereo_bm(l, r, jp)))(jnp.asarray(left), jnp.asarray(right)))
    mine = bm.stereo_bm(_t(left), _t(right), convert.bm_params_from_reference(jp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (np.abs(ref[..., 330:] - 301) <= 1).mean() > 0.5  # the window centres that see the whole range


def test_hier_band_320_matches_jax():
    """The per-frame entry at D = 512, band 320, granularity 8 (512 % 64 ==
    0, (512 - 320) % 8 == 0): its coarse level runs the exact path at D = 128
    and its full level the banded core at K = 320."""
    left, right = (a.astype(np.int32) for a in scene(seed=3, H=32, W=576))
    # No LR check: JAX's unrolls its 512 shifts, a 15 s compile (the exact
    # path's cases above run the LR check at D = 320 and 512).
    jp = jsgbm.StereoSGBMParams(num_disparities=512, block_size=5, uniqueness_ratio=10, speckle_window_size=30,
                                speckle_range=2, num_paths=3, backend="scan")
    jhp = jh.HierParams(band=320, granularity=8)
    ref = np.asarray(jax.jit(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, jhp))(left, right))
    mine = hier.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                                 convert.hier_params_from_reference(jhp)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert (ref[:, 512:] > -1).mean() > 0.4


def test_banded_cost_where_no_tile_fits_matches_jax():
    """Band 256, G = 8, ndisp 256, block 21: the input where a one-column
    tile's rings pass a block's shared memory (the kernel then keeps them in
    device scratch)."""
    left, right = _pair(21, 1, 8, 300, 40)
    s = np.zeros((1, 8, 300), np.int32)  # the band is the whole range
    jp = jsgbm.StereoSGBMParams(num_disparities=256, block_size=21, backend="scan")
    ref = np.asarray(jax.jit(lambda a, b, sv: jb.banded_cost_volume(a, b, sv, jp, 256, 8))(left[0], right[0], s[0]))
    kw = dict(band=256, G=8, ndisp=256, ftzero=15, block_size=21, min_x=0)
    mine = banded_cuda.banded_cost_plain(_t(left), _t(right), _t(s), **kw)
    assert mine.dtype == cost_cuda.cost_dtype(21, 15) == torch.int32  # 21^2 * 93 leaves int16
    np.testing.assert_array_equal(mine[0].numpy(), ref)


def test_wide_range_limits():
    """The refusals left are the reference's own: the LR check's 11-bit pack
    field (ndisp + |min_disparity| < 2048), where JAX's LR check asserts the
    same; bands are taken at every K % 4 == 0, above 1024 too."""
    for n in (1028, 2052, 4096):
        banded_cuda.check_band(n)
    rng = np.random.default_rng(0)
    for ndisp, mindisp in ((2032, 15), (2048, 0), (2040, 8), (1040, 1100)):
        refused = ndisp + abs(mindisp) >= 1 << 11
        Wv = 6
        W = ndisp + mindisp + Wv
        best = rng.integers(0, ndisp, (1, 2, Wv)).astype(np.int32)
        disp = best.astype(np.float32) + mindisp
        maps = (_t(best * 0 + 5), _t(best), _t(disp))
        kw = dict(W=W, min_x=ndisp + mindisp, ndisp=ndisp, mindisp=mindisp, max_diff=1)
        if refused:
            with pytest.raises(ValueError, match="pack field"):
                sgbm.lr_fail(*maps, **kw)
            with pytest.raises(AssertionError, match="pack field"):
                jlr.lr_fail_pallas(*(jnp.asarray(a[0]) for a in (best * 0 + 5, best, best, best)), W, ndisp, mindisp, 1)
        else:
            assert sgbm.lr_fail(*maps, **kw).shape == (1, 2, Wv)
