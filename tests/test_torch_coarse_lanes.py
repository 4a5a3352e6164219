"""The strided coarse search at 1-3 lanes (``coarse_stride`` with Dc /
coarse_stride < 4) against JAX, on the CPU.

At K <= 2 the WTA's clamp d0 = clamp(best, 1, K - 2) leaves d0 at -1 or 0,
and the reference's ``take_along_axis`` counts a negative sample index from
the end and reads INT_MIN outside [-K, K): the port's plain WTA forms
(``sgm_cuda.wta_scan``, ``banded_cuda.banded_wta_plain`` in both forms)
must give the same six outputs. The banded core at s = 0 with a stride
(``banded_stats_pack``) is held to JAX's ``banded_stats_scan`` at Kc = 1, 2
and 3, and the per-frame ``stereo_sgbm_hier`` to JAX's at Kc = 2 and 1.
Where the reference's window alignment cannot broadcast (Kc < G < 2 Kc,
e.g. Kc = 5 at G = 8) JAX raises, and so does the port, before any launch.
Exact equality; numpy-seeded inputs.
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
from stereo_vision_tpu_torch.stereo import banded_cuda, sgm_cuda
from stereo_vision_tpu_torch.stereo import hier as th


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("uniq", [0, 10])
def test_wta_plain_forms_at_one_and_two_lanes_match_jax(K, uniq):
    rng = np.random.default_rng(K + uniq)
    vols = [rng.integers(0, 3000, (2, 5, 9, K)).astype(np.int16) for _ in range(3)]
    vols[0][0, 0, :3] = vols[1][0, 0, :3] = vols[2][0, 0, :3] = 7  # lanes that tie
    S = sum(v.astype(np.int32) for v in vols)
    ref = jsgbm.wta_scan(jnp.asarray(S), K, uniq)
    assert (np.asarray(ref[2]) == np.iinfo(np.int32).min).any() == (K == 1)  # the fill the reference reads
    scan = sgm_cuda.wta_scan(_t(S), K, uniq)
    six = banded_cuda.banded_wta_plain([_t(v) for v in vols], uniq)
    four = banded_cuda.banded_wta_plain([_t(v) for v in vols], uniq, sub=True)
    for a, b, want in zip(scan, six, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))
        assert torch.equal(a, b)
    np.testing.assert_array_equal(four[2].numpy(), np.asarray(jsgbm.subpixel_disp16(*ref[1:5], K)))
    assert all(torch.equal(four[i], six[j]) for i, j in ((0, 0), (1, 1), (3, 5)))


P, H, W, DC = 2, 12, 64, 16
# Kc, stride, sub, num_paths: the coarse search at s = 0, min_x = Dc.
STATS_CASES = [(1, 16, True, 4), (2, 8, False, 8), (3, 5, True, 3)]


@pytest.mark.parametrize("K,stride,sub,paths", STATS_CASES)
def test_banded_stats_at_one_to_three_lanes_match_jax(K, stride, sub, paths):
    rng = np.random.default_rng(K)
    left = rng.integers(0, 256, (P, H, W)).astype(np.int32)
    right = np.clip(np.roll(left, -5, axis=2) + rng.integers(-3, 4, (P, H, W)), 0, 255).astype(np.int32)
    s = np.zeros((P, H, W), np.int32)
    jp = jsgbm.StereoSGBMParams(num_disparities=DC, block_size=3, uniqueness_ratio=10, num_paths=paths,
                                backend="scan")
    run = jax.jit(jax.vmap(lambda a, b, c: jb.banded_stats_scan(a, b, c, jp, K, 8, min_x=DC, stride=stride,
                                                                 sub=sub)))
    ref = run(left, right, s)
    mine = banded_cuda.banded_stats_pack(_t(left), _t(right), _t(s), convert.sgbm_params_from_reference(jp), K, 8,
                                         min_x=DC, stride=stride, sub=sub)
    assert len(mine) == len(ref) == (4 if sub else 6)
    for a, want in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))


def _pair(D):
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, (16, 128)).astype(np.uint8)
    return left, np.roll(left, -8, axis=1)


@pytest.mark.parametrize("stride", [8, 16])  # Kc = 2 and 1 at D = 64 (Dc = 16)
def test_per_frame_hier_at_few_coarse_lanes_matches_jax(stride):
    left, right = _pair(64)
    jp = jsgbm.StereoSGBMParams(num_disparities=64, block_size=3, backend="scan")
    jhp = jh.HierParams(band=16, granularity=8, coarse_stride=stride)
    ref = np.asarray(jh.stereo_sgbm_hier(left, right, jp, jhp))
    mine = th.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                               convert.hier_params_from_reference(jhp))
    assert (ref > -1).mean() > 0.3
    np.testing.assert_array_equal(mine.numpy(), ref)


def test_per_frame_hier_refuses_where_jax_raises(monkeypatch):
    """Kc = 5 at G = 8 (D = 64, stride 3): JAX's window alignment fails to
    broadcast; the port raises a ValueError that names the lane count, and
    launches nothing (no downsample either: the check comes first)."""
    left, right = _pair(64)
    jp = jsgbm.StereoSGBMParams(num_disparities=64, block_size=3, backend="scan")
    jhp = jh.HierParams(band=16, granularity=8, coarse_stride=3)
    with pytest.raises(ValueError):
        jh.stereo_sgbm_hier(left, right, jp, jhp)
    monkeypatch.setattr(th, "downsample_pyramid", lambda *a, **k: pytest.fail("a kernel ran before the refusal"))
    with pytest.raises(ValueError, match="5 lanes at granularity 8"):
        th.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                            convert.hier_params_from_reference(jhp))
    # The full level's band follows the same rule (band 4 at G = 6).
    with pytest.raises(ValueError, match="4 lanes at granularity 6"):
        th.stereo_sgbm_hier(_t(left), _t(right), convert.sgbm_params_from_reference(jp),
                            convert.hier_params_from_reference(jh.HierParams(band=4, granularity=6)))
