"""The hier image pyramid, ``banded_cuda.downsample_pyramid``, against JAX.

On the CPU the pyramid runs its plain form (``downsample_box_plain`` a
level and image). Each level of each image is held to the JAX package's
Pallas ``downsample_box_pack`` (interpret mode) where its constraints hold
(a square factor f with 8 % f == 0, H % 8 == 0), which the JAX hier path
runs on the TPU, and to ``hier._downsample_box`` elsewhere. Exact: the
block sums are integers and the one float32 division is by the same
factor. Numpy-seeded frames with half-to-even ties.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import hier as jh
from stereo_vision_tpu.stereo.banded_pallas import downsample_box_pack
from stereo_vision_tpu_torch.stereo import banded_cuda
from stereo_vision_tpu_torch.stereo import hier as th

FACTOR_SETS = [((4, 4), (2, 2)), ((4, 4),), ((8, 8), (4, 4), (2, 2)), ((4, 8), (2, 2)), ((3, 3),)]
# (H, W): multiples of every factor, and neither
SHAPES = [(48, 96), (45, 101)]
P = 2


def _frames(H: int, W: int) -> np.ndarray:
    """The left and right frames of one shape stacked, (2P, H, W) int32."""
    rng = np.random.default_rng(H * W)
    img = rng.integers(0, 256, (2 * P, H, W)).astype(np.int32)
    img[0, :2, :4] = [[0, 1, 1, 2], [1, 0, 1, 2]]  # 2x2 block sums 2 and 6: means 0.5, 1.5
    img[1, :4, :8] = 1  # a block of ones (mean exactly 1) beside .5 ties below
    img[1, 4:8, :8] = [0, 1, 0, 1, 0, 1, 0, 1]
    img[2] = 255 - img[1]
    return img


@functools.lru_cache(maxsize=None)
def _jax_level(H: int, W: int, fy: int, fx: int) -> np.ndarray:
    img = jnp.asarray(_frames(H, W))
    if fy == fx and 8 % fy == 0 and H % 8 == 0:
        return np.asarray(downsample_box_pack(img, fy, interpret=True))
    return np.asarray(jax.vmap(lambda a: jh._downsample_box(a, fy, fx))(img))


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("factors", FACTOR_SETS, ids=lambda f: "_".join(f"{a}x{b}" for a, b in f))
def test_pyramid_matches_jax(factors, H, W):
    img = _frames(H, W)
    left, right = torch.from_numpy(img[:P]), torch.from_numpy(img[P:])
    n = banded_cuda.downsample_pyramid.launches
    levels = banded_cuda.downsample_pyramid(left, right, factors)
    assert banded_cuda.downsample_pyramid.launches == n  # CPU tensors take the plain form
    assert len(levels) == len(factors)
    for (fy, fx), (lc, rc) in zip(factors, levels):
        ref = _jax_level(H, W, fy, fx)
        assert lc.dtype == rc.dtype == torch.int32 and lc.shape == (P, H // fy, W // fx)
        np.testing.assert_array_equal(lc.numpy(), ref[:P])
        np.testing.assert_array_equal(rc.numpy(), ref[P:])


def test_pyramid_keeps_half_to_even_ties():
    lc, _ = banded_cuda.downsample_pyramid(*(torch.from_numpy(_frames(48, 96)[:P]),) * 2, ((2, 2),))[0]
    assert lc[0, 0, :2].tolist() == [0, 2]


@pytest.mark.parametrize("factors,nests", [
    (((4, 4), (2, 2)), True), (((2, 2), (4, 4)), True), (((4, 4),), True), (((8, 8), (4, 4), (2, 2)), True),
    (((4, 8), (2, 2)), True), (((1, 1), (16, 128)), True), (((3, 3),), False), (((6, 6), (3, 3)), False),
    (((2, 8), (4, 2)), False), (((32, 32),), False), (((4, 256),), False), (((2, 2),) * 9, False)])
def test_pyramid_nests(factors, nests):
    """One launch covers power-of-two factors that order the same way in
    both axes (fy <= 16, fx <= 128, at most 8 levels); the rest take one
    launch a level."""
    assert banded_cuda.pyramid_nests(factors) is nests


@pytest.mark.parametrize("bad", [
    dict(right=torch.zeros((2, 8, 9), dtype=torch.int32)),  # shapes differ
    dict(right=torch.zeros((2, 8, 8), dtype=torch.int64)),  # not int32
    dict(left=torch.zeros((8, 8), dtype=torch.int32), right=torch.zeros((8, 8), dtype=torch.int32)),  # not (P, H, W)
    dict(factors=()),
    dict(factors=((2, 0),)),
    dict(factors=((0, 2), (2, 2))),
])
def test_pyramid_argument_checks(bad):
    args = dict(left=torch.zeros((2, 8, 8), dtype=torch.int32), right=torch.zeros((2, 8, 8), dtype=torch.int32),
                factors=((2, 2),))
    args.update(bad)
    with pytest.raises(ValueError):
        banded_cuda.downsample_pyramid(args["left"], args["right"], args["factors"])


def test_hier_prior_makes_one_pyramid_call(monkeypatch):
    """``hier._prior`` takes the coarse pair and every mid level's from one
    pyramid call (HIER4_FAST: (4, 4) and (2, 2)) and hands the coarse pair
    on as it is."""
    calls, pyramid, coarse = [], th.downsample_pyramid, []
    monkeypatch.setattr(th, "downsample_pyramid", lambda l, r, f: calls.append(f) or pyramid(l, r, f))

    def coarse_pass(lc, rc, *a):
        coarse.append((lc, rc))
        raise StopIteration  # the rest of the prior is held to JAX in test_torch_hier.py

    monkeypatch.setattr(th, "_coarse_pass", coarse_pass)
    img = torch.from_numpy(_frames(48, 96))
    with pytest.raises(StopIteration):
        th._prior(img[:P], img[P:], th.StereoSGBMParams(num_disparities=64), th.HIER4_FAST, exact_coarse=False)
    assert calls == [((4, 4), (2, 2))]
    (lc, rc), = coarse
    np.testing.assert_array_equal(lc.numpy(), _jax_level(48, 96, 4, 4)[:P])
    np.testing.assert_array_equal(rc.numpy(), _jax_level(48, 96, 4, 4)[P:])
