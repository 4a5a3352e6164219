"""The port's block matching against the JAX package, on the CPU.

``stereo_bm`` (whose CPU path runs the plain form of the BM kernel,
``bm.valid_disparity_plain``), the prefilter, the ``bm`` pipeline branch and
``left_right_check`` are held to their JAX counterparts on the same numpy
inputs: disparities exactly equal (integers plus one float32 division done
the same way), points within rtol 1e-6 (see ``test_torch_pipeline.py``).
The plain form is also held to ``bm_stats_pallas`` in interpret mode.
"""

import functools as ft

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.parallel import streaming as jstream
from stereo_vision_tpu.stereo import bm as jbm
from stereo_vision_tpu.stereo import bm_pallas as jbp
from stereo_vision_tpu.stereo import postprocess as jpost
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.parallel import streaming as tstream
from stereo_vision_tpu_torch.stereo import bm, bm_cuda, postprocess


def _pair(seed, B, H, W, shift):
    """A random pair whose right view is the left shifted by ``shift``,
    with a little noise, so that matches and ties both occur."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, H, W + 40)).astype(np.int32)
    left = base[..., 20 : 20 + W]
    right = np.clip(base[..., 20 - shift : 20 - shift + W] + rng.integers(-3, 4, (B, H, W)), 0, 255)
    return left, right.astype(np.int32)


def _jax_bm(left, right, p):
    fn = jax.jit(jax.vmap(lambda l, r: jbm.stereo_bm(l, r, p)))
    return np.asarray(fn(jnp.asarray(left), jnp.asarray(right)))


@pytest.mark.parametrize("shape", [(1, 5), (3, 2), (2, 1), (1, 1), (9, 14)])
@pytest.mark.parametrize("cap", [31, 15])
def test_prefilter_matches_jax(shape, cap):
    img = np.random.default_rng(shape[0] * 31 + shape[1]).integers(0, 256, shape).astype(np.int32)
    mine = bm.prefilter_xsobel(torch.from_numpy(img), cap)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(jbm.prefilter_xsobel(jnp.asarray(img), cap)))
    # A batch of frames filters each frame alone.
    batch = bm.prefilter_xsobel(torch.from_numpy(np.stack([img, img[::-1].copy()])), cap)
    assert torch.equal(batch[0], mine)


@pytest.mark.parametrize(
    "H,W,D,bs,mindisp,uniq,tex",
    [(48, 96, 16, 9, 0, 15, 10), (40, 120, 32, 15, 8, 0, 0), (40, 120, 16, 9, -4, 15, 10),
     (48, 96, 32, 15, 0, 0, 10), (40, 120, 16, 9, 8, 15, 0)],
)
def test_stereo_bm_matches_jax(H, W, D, bs, mindisp, uniq, tex):
    left, right = _pair(H + D + bs, 2, H, W, 7 + max(mindisp, 0))
    jp = jbm.StereoBMParams(num_disparities=D, block_size=bs, min_disparity=mindisp, uniqueness_ratio=uniq,
                            texture_threshold=tex, backend="xla")
    ref = _jax_bm(left, right, jp)
    n = bm_cuda.bm_disparity.launches
    mine = bm.stereo_bm(torch.from_numpy(left), torch.from_numpy(right), convert.bm_params_from_reference(jp))
    assert bm_cuda.bm_disparity.launches == n  # CPU tensors take the plain form
    assert mine.dtype == torch.float32 and mine.shape == (2, H, W)
    valid = ref > mindisp - 1
    assert 0.05 < valid.mean() < 1.0
    np.testing.assert_array_equal(mine.numpy(), ref)
    # A single (H, W) frame gives the batch's first frame.
    one = bm.stereo_bm(torch.from_numpy(left[0]), torch.from_numpy(right[0]), convert.bm_params_from_reference(jp))
    assert torch.equal(one, mine[0])


def test_bm_plain_form_matches_pallas_interpret():
    """The plain form of the BM kernel against ``bm_stats_pallas`` in
    interpret mode (min_disparity 0, the Pallas route), through JAX's own
    ``stereo_bm`` with the kernel swapped for its interpret-mode call."""
    left, right = _pair(5, 2, 40, 84, 6)
    p = jbm.StereoBMParams(num_disparities=16, block_size=9, backend="pallas")
    orig = jbp.bm_stats_pallas
    jbp.bm_stats_pallas = ft.partial(orig.__wrapped__, interpret=True)
    try:
        ref = np.stack([np.asarray(jbm.stereo_bm(jnp.asarray(left[b]), jnp.asarray(right[b]), p)) for b in range(2)])
    finally:
        jbp.bm_stats_pallas = orig
    mine = bm.stereo_bm(torch.from_numpy(left), torch.from_numpy(right), convert.bm_params_from_reference(p))
    assert (ref > -1).mean() > 0.05
    np.testing.assert_array_equal(mine.numpy(), ref)


def _pipeline_inputs(B=2, H=30, W=96):
    left, right = _pair(11, B, H, W, 9)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (
        (xx + 0.35 * np.sin(yy / 4.0)).astype(np.float32),
        (yy + 0.3 * np.cos(xx / 6.0) - 0.2).astype(np.float32),
        (xx + 0.25 * np.sin(yy / 5.0) + 0.1).astype(np.float32),
        (yy + 0.3 * np.cos(xx / 6.0) - 0.2).astype(np.float32),
    )
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 400.0], [0, 0, 12.5, 0]], np.float32)
    return left, right, maps, Q


_JP = jbm.StereoBMParams(num_disparities=16, block_size=9, uniqueness_ratio=5, texture_threshold=5, backend="xla")


def test_bm_pipeline_matches_jax():
    left, right, maps, Q = _pipeline_inputs()
    jd, jp = jstream.batched_stereo_pipeline(
        jnp.asarray(left), jnp.asarray(right), tuple(jnp.asarray(m) for m in maps), jnp.asarray(Q),
        matcher="bm", params=_JP,
    )
    td, tp = tstream.batched_stereo_pipeline(left, right, maps, Q, matcher="bm",
                                             params=convert.bm_params_from_reference(_JP), device="cpu")
    assert (np.asarray(jd) > -1).mean() > 0.1
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def test_bm_pipeline_stats_only_matches_jax():
    left, right, maps, Q = _pipeline_inputs()
    ref = jstream.batched_stereo_pipeline(
        jnp.asarray(left), jnp.asarray(right), tuple(jnp.asarray(m) for m in maps), jnp.asarray(Q),
        matcher="bm", params=_JP, stats_only=True,
    )
    mine = tstream.batched_stereo_pipeline(left, right, maps, Q, matcher="bm",
                                           params=convert.bm_params_from_reference(_JP), stats_only=True,
                                           device="cpu")
    assert mine.shape == (2, 2)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("max_disparity", [None, 12, 5])
@pytest.mark.parametrize("max_diff", [1.0, 0.5])
def test_left_right_check_matches_jax(max_disparity, max_diff):
    rng = np.random.default_rng(3 if max_disparity is None else max_disparity)
    H, W = 9, 40
    dl = (rng.integers(0, 24, (H, W)) / 2.0).astype(np.float32)  # .5 ties round half to even
    dl[rng.random((H, W)) < 0.1] = -1.0
    dr = (dl + rng.integers(-2, 3, (H, W)) * 0.5).astype(np.float32)
    ref = np.asarray(jpost.left_right_check(jnp.asarray(dl), jnp.asarray(dr), max_diff, -1.0, max_disparity))
    mine = postprocess.left_right_check(torch.from_numpy(dl), torch.from_numpy(dr), max_diff, -1.0, max_disparity)
    assert mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert (ref == -1.0).any() and (ref > -1.0).any()


def test_bm_params_from_reference():
    p = convert.bm_params_from_reference(_JP)
    assert isinstance(p, bm.StereoBMParams) and p == bm.StereoBMParams(16, 9, 0, 31, 5, 5)
    assert convert.bm_params_from_reference({"block_size": 5, "backend": "pallas"}).block_size == 5
    assert tuple(bm.StereoBMParams()) == tuple(jbm.StereoBMParams())[:-1]


def test_bm_wrapper_checks_its_arguments():
    lp = torch.zeros((1, 12, 20), dtype=torch.int32)
    kw = dict(ndisp=8, mindisp=0, block_size=5, cap=31, uniq=15, tex_thr=10)
    assert bm_cuda.bm_disparity(lp, lp, **kw).shape == (1, 8, 16)
    with pytest.raises(ValueError, match="one device"):
        bm_cuda.bm_disparity(lp, lp[:, :, :10], **kw)
    with pytest.raises(ValueError, match="block"):
        bm_cuda.bm_disparity(lp, lp, **dict(kw, block_size=13))
    with pytest.raises(ValueError, match="ndisp"):
        bm_cuda.bm_disparity(lp, lp, **dict(kw, ndisp=0))
    with pytest.raises(ValueError, match="negative"):  # as the JAX path refuses to pad by it
        bm_cuda.bm_disparity(lp, lp, **dict(kw, mindisp=-8))
    with pytest.raises(ValueError, match="does not fit"):
        bm.stereo_bm(lp[0, :4], lp[0, :4], bm.StereoBMParams(block_size=5))
