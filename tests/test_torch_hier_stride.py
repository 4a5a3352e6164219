"""The strided coarse search (``HierParams.coarse_stride``) against JAX.

HIER_FAST at coarse_stride 2 (the coarse level searches every second
disparity with 16 lanes, its parabola scaled back), without and with a
coarse LR check, on the same numpy-seeded frames: the port's per-frame
``stereo_sgbm_hier`` and its 8-frame batch against JAX's per-frame
``stereo_sgbm_hier`` (its scan backend, vmapped over two frames under one
jit; the JAX package's own tests hold its packed batch equal to it).
Exact equality. The strided banded cost's plain form is held to JAX's
``banded_cost_volume(stride=2)`` on its own.
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
from stereo_vision_tpu_torch.stereo import banded as tb
from stereo_vision_tpu_torch.stereo import banded_cuda
from stereo_vision_tpu_torch.stereo import hier as th
from stereo_vision_tpu_torch.synth.scenes import scene

H, W, D, P = 48, 192, 128, 8
PICK = [0, 5]
CASES = {"stride2": dict(coarse_stride=2), "stride2_coarse_lr": dict(coarse_stride=2, coarse_lr=1)}
JP = jsgbm.StereoSGBMParams(num_disparities=D, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                            speckle_window_size=30, speckle_range=2, num_paths=3, backend="scan")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def reference():
    frames = [scene(seed=10 + s, H=H, W=W) for s in range(P)]
    left = np.stack([f[0] for f in frames]).astype(np.int32)
    right = np.stack([f[1] for f in frames]).astype(np.int32)
    out = {}
    for name, kw in CASES.items():
        hp = jh.HIER_FAST._replace(**kw)
        disp = jax.jit(jax.vmap(lambda a, b: jh.stereo_sgbm_hier(a, b, JP, hp)))(left[PICK], right[PICK])
        out[name] = (hp, np.asarray(disp))
    return left, right, out


@pytest.mark.parametrize("name", list(CASES))
def test_strided_coarse_per_frame_and_batch_match_jax(reference, name):
    left, right, out = reference
    jhp, ref = out[name]
    hp = convert.hier_params_from_reference(jhp)
    params = convert.sgbm_params_from_reference(JP)
    assert (ref > -1).mean() > 0.2
    batch = th.stereo_sgbm_hier_batch(_t(left), _t(right), params, hp)
    np.testing.assert_array_equal(batch[PICK].numpy(), ref)
    for i, b in enumerate(PICK):
        np.testing.assert_array_equal(th.stereo_sgbm_hier(_t(left[b]), _t(right[b]), params, hp).numpy(), ref[i])
    # The stride reaches the coarse level only: unstrided, the prior differs.
    assert not torch.equal(batch, th.stereo_sgbm_hier_batch(_t(left), _t(right), params, th.HIER_FAST))


def test_strided_banded_cost_matches_jax():
    rng = np.random.default_rng(3)
    left = rng.integers(0, 256, (2, 20, 80)).astype(np.int32)
    right = np.clip(np.roll(left, -7, axis=2) + rng.integers(-3, 4, left.shape), 0, 255).astype(np.int32)
    jp = JP._replace(num_disparities=32)
    s = np.zeros((2, 20, 80), np.int32)
    ref = jax.vmap(lambda a, b, sv: jb.banded_cost_volume(a, b, sv, jp, 16, 8, stride=2))(left, right, s)
    mine = tb.banded_cost_volume(_t(left), _t(right), _t(s), band=16, G=8, ndisp=32, ftzero=jp.ftzero,
                                 block_size=5, stride=2)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    packed = banded_cuda.banded_cost(_t(left), _t(right), _t(s), band=16, G=8, ndisp=32, ftzero=jp.ftzero,
                                     block_size=5, min_x=32, stride=2)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref)[:, :, 32:])


def test_strided_coarse_checks():
    """The reference's coarse pack rules and its coarse-only stride."""
    frames = torch.zeros((4, 48, 192), dtype=torch.int32)
    params = th.StereoSGBMParams(num_disparities=D)
    with pytest.raises(ValueError, match="does not pack 4 frames"):
        th.stereo_sgbm_hier_batch(frames, frames, params, th.HierParams(coarse_stride=2))
    with pytest.raises(ValueError, match="does not pack"):
        th.stereo_sgbm_hier_batch(frames[:2].repeat(4, 1, 1), frames[:2].repeat(4, 1, 1), params,
                                  th.HIER_FAST._replace(coarse_stride=3))
    stats = [torch.zeros((1, 4, 8), dtype=torch.int32)] * 3 + [torch.ones((1, 4, 8), dtype=torch.bool)]
    with pytest.raises(ValueError, match="coarse-only"):
        th._assemble_disparity(stats, stats[0], 16, 8, 8, 8, params, stride=2)
