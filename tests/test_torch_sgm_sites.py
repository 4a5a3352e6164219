"""The exact SGM family's remaining entry points against the JAX package.

``aggregate_8`` (the port of ``aggregate_8_pallas`` and of the scan
``_aggregate_8``), ``wta_stats`` (``wta_stats_pallas``) and ``sgm_reduce``
with the fused R->L scan + WTA (``sgm_reduce_pallas`` with
``_FUSED_RL_WTA``) run their plain forms on CPU tensors; here they are held,
exactly, to the Pallas kernels in interpret mode (all values are integers;
the Pallas maps are float32 holding integers and are cast back).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu.stereo import sgm_pallas as jsp
from stereo_vision_tpu_torch.stereo import sgm_cuda

_NAMES = ("minS", "best", "sm", "s0", "sp", "uok")


def _costs(seed, B, H, W, D, hi=2326):
    return np.random.default_rng(seed).integers(0, hi, (B, H, W, D)).astype(np.int16)


def _assert_maps(mine, ref_frames, as_float):
    for b, ref in enumerate(ref_frames):
        for name, a, r in zip(_NAMES, mine, ref):
            r = np.asarray(r)
            if as_float:
                r = r > 0.5 if name == "uok" else r.astype(np.int32)
            np.testing.assert_array_equal(a[b].numpy(), r, err_msg=name)


@pytest.mark.parametrize("num_paths", [4, 8])
def test_aggregate_8_matches_pallas(num_paths):
    C = _costs(num_paths, 2, 17, 29, 16)
    n = sgm_cuda.aggregate_8.launches
    mine = sgm_cuda.aggregate_8(torch.from_numpy(C), 200, 800, num_paths, cost_bound=2325)
    assert sgm_cuda.aggregate_8.launches == n and mine.dtype == torch.int32 and mine.shape == C.shape
    for b in range(2):
        ref = jsp.aggregate_8_pallas(jnp.asarray(C[b]), 200, 800, num_paths=num_paths, interpret=True)
        np.testing.assert_array_equal(mine[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("num_paths", [2, 3])
def test_aggregate_8_few_paths_matches_scan(num_paths):
    C = _costs(num_paths, 1, 14, 23, 16)
    mine = sgm_cuda.aggregate_8(torch.from_numpy(C), 7, 86, num_paths, cost_bound=2325)
    ref = jsgbm._aggregate_8(jnp.asarray(C[0]), 7, 86, backend="scan", num_paths=num_paths)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="num_paths"):
        sgm_cuda.aggregate_8(torch.from_numpy(C), 7, 86, 5, cost_bound=2325)


@pytest.mark.parametrize("H,W", [(6, 1), (5, 2), (1, 9)])
def test_vertical_plain_at_narrow_shapes_matches_jax(H, W):
    """The vertical scans' plain form, which the card tests hold the cluster
    kernel to, at a single column, two columns and a single row: the
    2-path sum (vertical pair) against the scan reference, the 8-path sum
    (with the diagonals) against the scan reference and aggregate_8_pallas
    in interpret mode."""
    C = _costs(H * 10 + W, 1, H, W, 16)
    s_dn, s_up = sgm_cuda.vertical_plain(torch.from_numpy(C), 200, 800, with_diagonals=False)
    ref = jsgbm._aggregate_8(jnp.asarray(C[0]), 200, 800, backend="scan", num_paths=2)
    np.testing.assert_array_equal((s_dn + s_up)[0].numpy(), np.asarray(ref))
    mine = sgm_cuda.aggregate_8(torch.from_numpy(C), 200, 800, 8, cost_bound=2325)
    ref = jsgbm._aggregate_8(jnp.asarray(C[0]), 200, 800, backend="scan", num_paths=8)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref))
    ref = jsp.aggregate_8_pallas(jnp.asarray(C[0]), 200, 800, num_paths=8, interpret=True)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("uniq", [0, 10])
def test_wta_stats_matches_pallas(uniq):
    C = _costs(uniq, 2, 13, 21, 16)
    S = sgm_cuda.aggregate_8(torch.from_numpy(C), 200, 800, 8, cost_bound=2325)
    S[0, 0, :4, 5] = S[0, 0, :4].amin(dim=-1)  # ties: the smallest d wins
    n = sgm_cuda.wta_stats.launches
    mine = sgm_cuda.wta_stats(S, uniq)
    assert sgm_cuda.wta_stats.launches == n and mine[-1].dtype == torch.bool
    refs = [jsp.wta_stats_pallas(jnp.asarray(S[b].numpy()), uniq, interpret=True) for b in range(2)]
    _assert_maps(mine, refs, as_float=True)
    with pytest.raises(ValueError):
        sgm_cuda.wta_stats(S[..., :2], uniq)


@pytest.mark.parametrize("num_paths,uniq", [(8, 10), (4, 0)])
def test_fused_rl_wta_reduce_matches_jax(num_paths, uniq, monkeypatch):
    """sgm_reduce with the R->L scan fused into the WTA, against JAX's
    sgm_reduce_pallas with its own fused kernel (both flags set)."""
    C = np.random.default_rng(num_paths).integers(0, 3000, (2, 37, 53, 16)).astype(np.int16)
    calls = []
    plain = sgm_cuda.horizontal_rl_wta_plain
    monkeypatch.setattr(sgm_cuda, "horizontal_rl_wta_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(sgm_cuda, "_FUSED_RL_WTA", True)
    monkeypatch.setattr(jsp, "_FUSED_RL_WTA", True)
    mine = sgm_cuda.sgm_reduce(torch.from_numpy(C), 7, 86, uniq, cost_bound=3000, num_paths=num_paths)
    assert calls == [1]  # the fused wrapper ran (its plain form, on CPU tensors)
    refs = [jsp.sgm_reduce_pallas.__wrapped__(jnp.asarray(C[b]), 7, 86, uniq, num_paths=num_paths, interpret=True)
            for b in range(2)]
    _assert_maps(mine, refs, as_float=True)
    # The fused form returns the unfused form's maps.
    monkeypatch.setattr(sgm_cuda, "_FUSED_RL_WTA", False)
    unfused = sgm_cuda.sgm_reduce(torch.from_numpy(C), 7, 86, uniq, cost_bound=3000, num_paths=num_paths)
    assert all(torch.equal(a, b) for a, b in zip(mine, unfused))


def test_horizontal_rl_wta_checks_its_arguments():
    C = torch.from_numpy(_costs(0, 1, 5, 7, 8))
    vols = [sgm_cuda.horizontal_plain(C, 7, 86) for _ in range(3)]
    n = sgm_cuda.horizontal_rl_wta.launches
    out = sgm_cuda.horizontal_rl_wta(C, *vols, 7, 86, 10)
    assert sgm_cuda.horizontal_rl_wta.launches == n and out[0].shape == (1, 5, 7)
    with pytest.raises(ValueError, match="three volumes"):
        sgm_cuda.horizontal_rl_wta(C, vols[0], vols[1], vols[2][:, :4], 7, 86, 10)
    with pytest.raises(ValueError, match="P1"):
        sgm_cuda.horizontal_rl_wta(C, *vols, -1, 86, 10)


@pytest.mark.parametrize("D,W,uniq", [(3, 1, 10), (4, 2, 0), (33, 5, 10)])
def test_fused_rl_wta_edges_match_jax(D, W, uniq, monkeypatch):
    """The fused R->L WTA's plain form, which the card's grid holds the
    kernel to, at the register forms' edges (D = 3 and 4: one value a lane,
    the smallest ranges the WTA takes; D = 33: two values a lane, a ragged
    last lane) and at one and two columns, against JAX's sgm_reduce_pallas
    with its own fused kernel in interpret mode."""
    C = np.random.default_rng(D * 10 + W).integers(0, 3000, (1, 5, W, D)).astype(np.int16)
    monkeypatch.setattr(sgm_cuda, "_FUSED_RL_WTA", True)
    monkeypatch.setattr(jsp, "_FUSED_RL_WTA", True)
    n = sgm_cuda.horizontal_rl_wta.launches
    mine = sgm_cuda.sgm_reduce(torch.from_numpy(C), 7, 86, uniq, cost_bound=3000, num_paths=8)
    assert sgm_cuda.horizontal_rl_wta.launches == n
    ref = jsp.sgm_reduce_pallas.__wrapped__(jnp.asarray(C[0]), 7, 86, uniq, num_paths=8, interpret=True)
    _assert_maps(mine, [ref], as_float=True)
