"""The port's speckle filter wrapper (``stereo/speckle_cuda.py``) against the JAX package.

On CPU tensors the wrapper runs its plain form, which is what the CUDA
kernel is held to on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here it is held, exactly, to JAX's Pallas
``speckle_filter_pallas`` in interpret mode on the inputs of
``tests/test_speckle.py``'s Pallas case, and to JAX's ``speckle_filter``
with the diameter cap on batched frames.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo.postprocess import speckle_filter as jax_speckle
from stereo_vision_tpu.stereo.speckle_pallas import speckle_filter_pallas
from stereo_vision_tpu_torch.stereo import speckle_cuda
from stereo_vision_tpu_torch.stereo.postprocess import speckle_rounds


@pytest.mark.parametrize("seed,S,frac", [(0, 8, False), (1, 5, True), (2, 1, False)])
def test_speckle_matches_jax_pallas(seed, S, frac):
    rng = np.random.default_rng(seed)
    H, W = 40, 60
    disp = np.where(rng.random((H, W)) < 0.65, np.floor(rng.uniform(0, 32 * 16, (H, W))), -16.0).astype(np.float32)
    inv, md = -16.0, 32.0
    if frac:
        disp, inv, md = disp / 16.0, -1.0, 2.0
    ref = np.asarray(speckle_filter_pallas(jnp.asarray(disp), md, S, inv, interpret=True))
    n = speckle_cuda.speckle_filter.launches
    mine = speckle_cuda.speckle_filter(torch.from_numpy(disp), md, S, inv)
    assert speckle_cuda.speckle_filter.launches == n  # CPU tensors take the plain form
    assert mine.dtype == torch.float32 and mine.shape == (H, W)
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert (mine.numpy() != disp).any()


def _snake_frames():
    """test_speckle.py's one-sided case (a 20-px snake of diameter 19 and a
    compact 2-px blob) beside random quantised maps."""
    rng = np.random.default_rng(9)
    disp = rng.integers(0, 5, (3, 9, 24)).astype(np.float32) * 2
    disp[rng.random(disp.shape) < 0.5] = -1.0
    snake = np.full((9, 24), -1.0, np.float32)
    snake[1, 1:11] = 10
    snake[1:4, 10] = 10
    snake[3, 3:11] = 10
    snake[6, 2:4] = 5
    disp[0] = snake
    return disp


@pytest.mark.parametrize("cap", [4, 6, None])
def test_speckle_cap_matches_jax_batched(cap):
    disp = _snake_frames()
    ref = np.asarray(jax_speckle(jnp.asarray(disp), 1.0, 20, -1.0, max_diameter=cap))
    mine = speckle_cuda.speckle_filter(torch.from_numpy(disp), 1.0, 20, -1.0, max_diameter=cap).numpy()
    np.testing.assert_array_equal(mine, ref)
    # The capped filter keeps the snake, the exact one removes it; both remove the compact blob.
    assert (mine[0, 1, 1] == 10) == (cap is not None and cap < 19)
    assert mine[0, 6, 2] == -1.0


def test_speckle_rounds_and_arguments():
    assert [speckle_rounds(S, cap) for S, cap in ((100, None), (100, 4), (1, None), (5, 8), (3, 0))] == \
        [99, 4, 1, 4, 1]
    disp = torch.full((4, 5), 3.0)
    assert speckle_cuda.speckle_filter(disp, 1.0, 0) is disp  # S = 0 is a no-op
    with pytest.raises(ValueError):
        speckle_cuda.speckle_filter(disp[0], 1.0, 5)
