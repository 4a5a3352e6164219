"""Plain forms of the port's kernel modules against the JAX Pallas kernels.

``cost_volume_plain`` and ``sgm_reduce_plain`` are what the CUDA kernels
are held to on the card (tests/test_torch_cuda.py, chip_smoke.py); here
they are held to ``cost_volume_pallas`` / ``sgm_reduce_pallas`` run in
interpret mode on the CPU, with exact equality (all values are integers).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu.stereo.cost_pallas import cost_volume_pallas
from stereo_vision_tpu.stereo.sgm_pallas import sgm_reduce_pallas
from stereo_vision_tpu_torch.stereo import cost_cuda, sgm_cuda

_NAMES = ("minS", "best", "sm", "s0", "sp", "uok")


def _frames(seed, B, H, W, D, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, H, W + 2 * D)).astype(np.int32)
    return base[..., D : D + W].copy(), base[..., D - shift : D - shift + W].copy()


@pytest.mark.parametrize("x_offset", [0, 16])
def test_cost_volume_plain_matches_pallas(x_offset):
    H, W, D, bs = 19, 48, 16, 5
    left, right = _frames(1, 2, H, W, D, 5)
    mine = cost_cuda.cost_volume_plain(torch.from_numpy(left), torch.from_numpy(right), ndisp=D,
                                       block_size=bs, x_offset=x_offset)
    for b in range(2):
        l, r = jnp.asarray(left[b]), jnp.asarray(right[b])
        ref = cost_volume_pallas.__wrapped__(
            jsgbm._xsobel_clipped(l, 15), jsgbm._xsobel_clipped(r, 15), l, r,
            ndisp=D, block_size=bs, x_offset=x_offset, interpret=True,
        )
        np.testing.assert_array_equal(mine[b].numpy(), np.asarray(ref))


def test_cost_volume_wrapper_on_cpu_runs_plain():
    left, right = (torch.from_numpy(a) for a in _frames(2, 1, 9, 40, 8, 3))
    n = cost_cuda.cost_volume.launches
    out = cost_cuda.cost_volume(left, right, ndisp=8, mindisp=2, block_size=3, x_offset=10)
    assert cost_cuda.cost_volume.launches == n  # no kernel launched for CPU tensors
    assert out.shape == (1, 9, 30, 8) and out.dtype == torch.int16
    assert torch.equal(out, cost_cuda.cost_volume_plain(left, right, ndisp=8, mindisp=2, block_size=3, x_offset=10))
    with pytest.raises(TypeError):
        cost_cuda.cost_volume(left.to(torch.int64), right, ndisp=8)
    with pytest.raises(ValueError):
        cost_cuda.cost_volume(left[0], right[0], ndisp=8)
    with pytest.raises(ValueError):
        cost_cuda.cost_volume(left, right, ndisp=8, x_offset=40)


@pytest.mark.parametrize("num_paths,uniq", [(8, 10), (8, 0), (4, 10)])
def test_sgm_reduce_plain_matches_pallas(num_paths, uniq):
    rng = np.random.default_rng(num_paths + uniq)
    C = rng.integers(0, 2326, (2, 15, 27, 16)).astype(np.int16)
    mine = sgm_cuda.sgm_reduce(torch.from_numpy(C), 200, 800, uniq, cost_bound=2325, num_paths=num_paths)
    for b in range(2):
        ref = sgm_reduce_pallas.__wrapped__(jnp.asarray(C[b]), 200, 800, uniq, num_paths=num_paths, interpret=True)
        for name, a, r in zip(_NAMES, mine, ref):
            r = np.asarray(r) > 0.5 if name == "uok" else np.asarray(r).astype(np.int32)
            np.testing.assert_array_equal(a[b].numpy(), r, err_msg=name)


@pytest.mark.parametrize("num_paths", [2, 3])
def test_sgm_reduce_few_paths_matches_scan(num_paths):
    """2/3 paths (which sgm_reduce_pallas does not take) against the JAX scan."""
    rng = np.random.default_rng(num_paths)
    C = rng.integers(0, 2326, (1, 14, 23, 16)).astype(np.int16)
    mine = sgm_cuda.sgm_reduce(torch.from_numpy(C), 200, 800, 10, cost_bound=2325, num_paths=num_paths)
    S = jsgbm._aggregate_8(jnp.asarray(C[0]), 200, 800, backend="scan", num_paths=num_paths)
    ref = jsgbm.wta_scan(S, 16, 10)
    for name, a, r in zip(_NAMES, mine, ref):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(r), err_msg=name)
    with pytest.raises(ValueError):
        sgm_cuda.sgm_reduce(torch.from_numpy(C), 200, 800, 10, cost_bound=2325, num_paths=5)
