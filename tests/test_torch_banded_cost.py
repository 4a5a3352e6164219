"""The banded cost (the plain form the CUDA cost kernel is held to) against
the JAX package's ``stereo/banded.py::banded_cost_volume`` on per-pixel
random shift maps (exact equality).

The maps hit every case of the window's alignment: neighbour deltas of 0,
+-G and beyond G, off the G grid, and the image edges, where rows and
columns clamp for the cost and for the shift alike; at blocks 5 and 7 and
in the coarse level's strided search (stride 2 at s = 0, and at random s).
The same numpy-seeded arrays go to both packages; the JAX side runs on the
CPU, vmapped over frames under one jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import banded as jb
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch.stereo import banded_cuda

P, H, W = 2, 11, 70
# case -> (K, G, D, block, stride, shift map kind)
CASES = {
    "k4_g2_block5": (4, 2, 32, 5, 1, "random"),
    "k8_g4_block7": (8, 4, 48, 7, 1, "random"),
    "k16_g8_block5": (16, 8, 64, 5, 1, "random"),
    "k12_g4_block7": (12, 4, 48, 7, 1, "random"),
    "k16_stride2_s0": (16, 8, 32, 5, 2, "zero"),
    "k8_stride2_block7": (8, 4, 48, 7, 2, "random"),
}


def _inputs(name):
    K, G, D, bs, stride, kind = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    left = rng.integers(0, 256, (P, H, W)).astype(np.int32)
    right = np.clip(np.roll(left, -6, axis=2) + rng.integers(-4, 5, left.shape), 0, 255).astype(np.int32)
    top = D - stride * (K - 1) - 1  # the largest shift whose band stays in range
    if kind == "zero":
        s = np.zeros((P, H, W), np.int32)
    else:
        s = rng.integers(0, top // G + 1, (P, H, W)) * G
        s = s + (rng.random((P, H, W)) < 0.15) * rng.integers(1, 3, (P, H, W))
        s[:, 0, :] = s[:, -1, :] = top  # the edge rows and columns at the top of the range
        s[:, :, 0] = s[:, :, -1] = 0
        s = np.minimum(s, top).astype(np.int32)
    deltas = np.concatenate([(s[:, 1:] - s[:, :-1]).ravel(), (s[:, :, 1:] - s[:, :, :-1]).ravel()])
    return left, right, s, deltas, K, G, D, bs, stride


@pytest.mark.parametrize("name", list(CASES))
def test_banded_cost_random_shifts_match_jax(name):
    left, right, s, deltas, K, G, D, bs, stride = _inputs(name)
    if CASES[name][5] == "random":  # every delta case occurs
        assert {0, G, -G}.issubset(set(deltas.tolist())) and (np.abs(deltas) > G).any()
        assert ((deltas % G) != 0).any()
    jp = jsgbm.StereoSGBMParams(num_disparities=D, block_size=bs, backend="scan")
    ref = jax.jit(jax.vmap(lambda a, b, sv: jb.banded_cost_volume(a, b, sv, jp, K, G, stride)))(left, right, s)
    ref = np.asarray(ref)
    for min_x in (0, D // 2):
        out = banded_cuda.banded_cost(torch.from_numpy(left), torch.from_numpy(right), torch.from_numpy(s), band=K,
                                      G=G, ndisp=D, ftzero=jp.ftzero, block_size=bs, min_x=min_x, stride=stride)
        assert out.dtype == torch.int16 and out.shape == (P, H, W - min_x, K)
        np.testing.assert_array_equal(out.numpy(), ref[:, :, min_x:])
