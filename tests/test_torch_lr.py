"""The port's packed LR check (``stereo/lr_cuda.py``) against the JAX package.

The plain form of ``lr_fail_packed`` is held, on the CPU and exactly, to
JAX's Pallas ``lr_fail_pallas_packed`` in interpret mode (as
``tests/test_lr_pallas.py`` runs it) and to JAX's shift-chain ``lr_fail``.
Inputs are WTA-like: winners over the full range, costs with ties, and
16x fixed-point disparities within half a pixel of the winner, so that the
floor and ceil lookups differ and inconsistent pixels fire.
"""

import functools as ft

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import lr_pallas as jlr
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch.stereo import lr_cuda


def _inputs(P, H, W, ndisp, seed):
    rng = np.random.default_rng(seed)
    Wv = W - ndisp
    minS = rng.integers(0, 60, (P, H, Wv)).astype(np.int32)  # a narrow range: ties in the projection
    best = rng.integers(0, ndisp, (P, H, Wv)).astype(np.int32)
    d16 = np.clip(best * 16 + rng.integers(-8, 9, (P, H, Wv)), 0, None).astype(np.int32)
    return minS * 2048 + best, d16, minS, best


@pytest.mark.parametrize("H,W,ndisp,max_diff,seed", [(40, 256, 64, 1, 0), (50, 320, 32, 1, 1), (9, 96, 16, 0, 2)])
def test_lr_fail_packed_plain_matches_jax(H, W, ndisp, max_diff, seed):
    pack, d16, minS, best = _inputs(2, H, W, ndisp, seed)
    n = lr_cuda.lr_fail_packed.launches
    mine = lr_cuda.lr_fail_packed(torch.from_numpy(pack), torch.from_numpy(d16), W=W, ndisp=ndisp, max_diff=max_diff)
    assert lr_cuda.lr_fail_packed.launches == n  # CPU tensors take the plain form
    assert mine.dtype == torch.bool and mine.shape == pack.shape
    pallas = ft.partial(jlr.lr_fail_pallas_packed.__wrapped__, interpret=True)
    for b in range(2):
        ref = np.asarray(pallas(jnp.asarray(pack[b]), jnp.asarray(d16[b]), W=W, ndisp=ndisp, mindisp=0,
                                max_diff=max_diff))
        np.testing.assert_array_equal(mine[b].numpy(), ref)
        scan = np.asarray(jsgbm.lr_fail(jnp.asarray(minS[b]), jnp.asarray(best[b]), jnp.asarray(d16[b] / 16.0),
                                        W=W, min_x=ndisp, ndisp=ndisp, mindisp=0, max_diff=max_diff, backend="scan"))
        np.testing.assert_array_equal(mine[b].numpy(), scan)
    assert mine.any() and not mine.all()


def test_lr_fail_packed_checks_its_arguments():
    pack = torch.zeros((1, 4, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="Wv == W - ndisp"):
        lr_cuda.lr_fail_packed(pack, pack, W=64, ndisp=16, max_diff=1)
    with pytest.raises(TypeError):
        lr_cuda.lr_fail_packed(pack.to(torch.int64), pack, W=64, ndisp=32, max_diff=1)
    with pytest.raises(ValueError, match="two"):
        lr_cuda.lr_fail_packed(pack, pack[0], W=64, ndisp=32, max_diff=1)
