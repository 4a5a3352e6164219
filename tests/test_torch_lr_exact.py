"""The port's unpacked LR check (``lr_cuda.lr_fail``) against the JAX package.

On CPU tensors the wrapper runs its plain form, the shift-chain
``stereo/sgbm.py::lr_fail``, which is what the CUDA kernel is held to on the
card. Here it is held, exactly, to JAX's Pallas ``lr_fail_pallas`` (the
exact path's LR kernel) in interpret mode, with min_disparity 0 and > 0.
"""

import functools as ft

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import lr_pallas as jlr
from stereo_vision_tpu_torch.stereo import lr_cuda


def _inputs(B, H, W, ndisp, mindisp, seed):
    """WTA-like maps: costs with ties, winners over the full range, subpixel
    disparities within half a pixel of the winner, some invalid pixels."""
    rng = np.random.default_rng(seed)
    Wv = W - ndisp - mindisp
    minS = rng.integers(0, 60, (B, H, Wv)).astype(np.int32)
    best = rng.integers(0, ndisp, (B, H, Wv)).astype(np.int32)
    disp = ((best * 16 + rng.integers(-8, 9, (B, H, Wv))) / 16.0 + mindisp).astype(np.float32)
    disp[rng.random(disp.shape) < 0.05] = mindisp - 1.0
    return minS, best, disp


@pytest.mark.parametrize("H,W,ndisp,mindisp,max_diff,seed", [(12, 96, 32, 0, 1, 0), (10, 100, 16, 16, 0, 1),
                                                              (9, 80, 16, 5, 1, 2)])
def test_lr_fail_matches_jax_pallas(H, W, ndisp, mindisp, max_diff, seed):
    minS, best, disp = _inputs(2, H, W, ndisp, mindisp, seed)
    kw = dict(W=W, ndisp=ndisp, mindisp=mindisp, max_diff=max_diff)
    n = lr_cuda.lr_fail.launches
    mine = lr_cuda.lr_fail(*(torch.from_numpy(a) for a in (minS, best, disp)), min_x=ndisp + mindisp, **kw)
    assert lr_cuda.lr_fail.launches == n  # CPU tensors take the plain form
    assert mine.dtype == torch.bool and mine.shape == minS.shape
    pallas = ft.partial(jlr.lr_fail_pallas.__wrapped__, interpret=True)
    for b in range(2):
        ref = pallas(jnp.asarray(minS[b]), jnp.asarray(best[b]), jnp.asarray(np.floor(disp[b]).astype(np.int32)),
                     jnp.asarray(np.ceil(disp[b]).astype(np.int32)), **kw)
        np.testing.assert_array_equal(mine[b].numpy(), np.asarray(ref))
    assert mine.any() and not mine.all()


def test_lr_fail_checks_its_arguments():
    m = torch.zeros((1, 4, 32), dtype=torch.int32)
    d = torch.zeros((1, 4, 32))
    kw = dict(W=64, ndisp=32, mindisp=0, max_diff=1)
    with pytest.raises(ValueError, match="min_x"):
        lr_cuda.lr_fail(m, m, d, min_x=40, **kw)
    with pytest.raises(ValueError, match="three"):
        lr_cuda.lr_fail(m, m[0], d, min_x=32, **kw)
    with pytest.raises(ValueError, match="min_disparity"):
        lr_cuda.lr_fail(m, m, d, min_x=32, **dict(kw, mindisp=-1))
    with pytest.raises(ValueError, match="11-bit"):
        lr_cuda.lr_fail(m, m, d, min_x=32, **dict(kw, ndisp=2048))
