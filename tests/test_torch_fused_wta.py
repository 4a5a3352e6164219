"""The fused banded WTA's plain form against the JAX package's Pallas kernel.

``banded_cuda.banded_wta_fused`` (CPU tensors: its plain form) on the
direction volumes of the port's plain scans, against JAX's
``banded_reduce_pack(..., fused_out=True, interpret=True)``, whose last
``pallas_call`` is ``_wta_fused_kernel``, on the same random banded cost
volume and shift map. The JAX kernels pack 8 frames of 16 lanes as lane
``8 * k + b`` of a (H, W, 128) volume and realign their carries only at
tile boundaries, so the shift map is constant on 8-px tiles (4-px tiles
with ``tile_px=4``, HIER_FAST's). Exact equality: the maps are integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo.banded_pallas import banded_reduce_pack
from stereo_vision_tpu_torch.stereo import banded_cuda
from stereo_vision_tpu_torch.stereo.banded import horizontal_plain, vertical_plain

P, K, G, D = 8, 16, 8, 64
H, W = 16, 64
P1, P2, UNIQ, BOUND = 200, 800, 10, 2325


def _inputs(seed, tile):
    rng = np.random.default_rng(seed)
    C = rng.integers(0, BOUND + 1, (P, H, W, K)).astype(np.int16)
    vals = rng.integers(0, (D - K) // G + 1, (P, -(-H // tile), -(-W // tile))) * G
    s = np.repeat(np.repeat(vals, tile, axis=1), tile, axis=2)[:, :H, :W].astype(np.int32)
    return C, s


@pytest.mark.parametrize("num_paths,tile", [(3, 4), (4, 8)])
def test_fused_wta_plain_matches_jax_kernel(num_paths, tile):
    C, s = _inputs(num_paths, tile)
    packed = np.transpose(C, (1, 2, 3, 0)).reshape(H, W, K * P)  # lane = P * k + b
    ref_pack, ref_du = banded_reduce_pack(jnp.asarray(packed), jnp.asarray(s), K, G, P1, P2, UNIQ,
                                          num_paths=num_paths, tile_px=tile, cost_bound=BOUND, fused_out=True,
                                          interpret=True)
    Ct, st = torch.from_numpy(C), torch.from_numpy(s)
    vols = list(vertical_plain(Ct, st, G, P1, P2))
    vols.append(horizontal_plain(Ct, st, G, P1, P2))
    if num_paths == 4:
        vols.append(horizontal_plain(Ct, st, G, P1, P2, reverse=True))
    n = banded_cuda.banded_wta_fused.launches
    pack, du = banded_cuda.banded_wta_fused(vols, st, UNIQ, ndisp=D)
    assert banded_cuda.banded_wta_fused.launches == n  # CPU tensors take the plain form
    assert pack.dtype == du.dtype == torch.int32 and pack.shape == (P, H, W)
    np.testing.assert_array_equal(pack.numpy(), np.asarray(ref_pack))
    np.testing.assert_array_equal(du.numpy(), np.asarray(ref_du))
    assert (du >= 32768).any() and (du < 32768).any()  # both uniqueness verdicts occur

    # The same maps as the 4-stat WTA plus the shift.
    minS, best, sub16, uok = banded_cuda.banded_wta(vols, UNIQ, sub=True)
    assert torch.equal(pack, minS * 2048 + best + st)
    assert torch.equal(du & 32767, sub16 + 16 * st) and torch.equal(du >= 32768, uok)


def test_fused_wta_packs_the_widest_range_and_refuses_wider():
    C, s = _inputs(0, 8)
    vols = [torch.from_numpy(C).to(torch.int32)] * 2
    st = torch.from_numpy(s)
    with pytest.raises(ValueError, match="band 16"):
        banded_cuda.banded_wta_fused([v[..., :8] for v in vols], st, UNIQ, ndisp=D)
    for ndisp in (2048, 15):
        with pytest.raises(ValueError, match="collide"):
            banded_cuda.banded_wta_fused(vols, st, UNIQ, ndisp=ndisp)
    # The largest range that packs: shifts up to 2047 - 16, fields intact.
    st = st + (2047 - K) - st.max()
    pack, du = banded_cuda.banded_wta_fused(vols, st, UNIQ, ndisp=2047)
    minS, best, sub16, uok = banded_cuda.banded_wta(vols, UNIQ, sub=True)
    assert int(st.max()) == 2031 and int((du & 32767).max()) > 16 * 2040
    assert torch.equal(pack >> 11, minS) and torch.equal(pack & 2047, best + st)
    assert torch.equal(du & 32767, sub16 + 16 * st) and torch.equal(du >= 32768, uok)
    with pytest.raises(ValueError, match="int32"):
        banded_cuda.banded_wta_fused([vols[0] * 0 + (1 << 19)] * 2, st, UNIQ, ndisp=2047)
