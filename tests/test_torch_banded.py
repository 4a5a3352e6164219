"""The port's banded reference forms and banded-kernel plain forms against
the JAX package's ``stereo/banded.py`` (exact equality: every value is an
integer).

Inputs are numpy-seeded; shift maps are random, tile-constant and on the
G grid, so neighbouring tiles differ by 0, +-G and more than G (carry
resets and centre substitution both occur). The JAX side runs its scan
reference on the CPU, vmapped over frames under one jit per configuration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.stereo import banded as jb
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch.convert import sgbm_params_from_reference
from stereo_vision_tpu_torch.stereo import banded as tb
from stereo_vision_tpu_torch.stereo import banded_cuda

P, H, W = 2, 12, 80
# name -> (K, G, D, min_x)
CASES = {
    "k4_minx5": (4, 2, 32, 5),  # min_x < 8 at K = 4 (the Pallas s-select gate's corner)
    "k8": (8, 4, 64, 64),
    "k32": (32, 16, 64, 64),
    "k12": (12, 4, 64, 64),  # a band off the powers of two
}


def _scene(seed):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (P, H, W)).astype(np.int32)
    right = np.clip(np.roll(left, -9, axis=2) + rng.integers(-3, 4, (P, H, W)), 0, 255).astype(np.int32)
    return left, right


def _shift_map(seed, D, K, G, tile=4):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, (D - K) // G + 1, (P, -(-H // tile), -(-W // tile))) * G
    return np.repeat(np.repeat(v, tile, 1), tile, 2)[:, :H, :W].astype(np.int32)


def _jparams(D, **kw):
    return jsgbm.StereoSGBMParams(num_disparities=D, block_size=5, uniqueness_ratio=10, backend="scan", **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(name):
    K, G, D, min_x = CASES[name]
    left, right = _scene(K + min_x)
    return left, right, _shift_map(K, D, K, G), K, G, D, min_x


@pytest.mark.parametrize("K", [4, 8, 32])
def test_align_helpers_match_jax(K):
    rng = np.random.default_rng(K)
    a = rng.integers(0, 5000, (3, 7, K)).astype(np.int32)
    center = rng.integers(0, 5000, (3, 7, K)).astype(np.int32)
    for d in range(-K - 1, K + 2):
        for fill in (None, 1 << 29):
            np.testing.assert_array_equal(tb.lane_shift(_t(a), d, fill).numpy(),
                                          np.asarray(jb.lane_shift(jnp.asarray(a), d, fill)))
    for G in sorted({1, 2, K // 2, K}):
        delta = rng.integers(-3 * G, 3 * G + 1, (3, 7)).astype(np.int32)  # includes non-multiples of G
        delta[0, :3] = (G, -G, 0)
        for diag in (False, True):
            for fill in (None, 1 << 29):
                np.testing.assert_array_equal(
                    tb.align_band(_t(a), _t(delta), G, diag=diag, fill=fill).numpy(),
                    np.asarray(jb.align_band(jnp.asarray(a), jnp.asarray(delta), G, diag=diag, fill=fill)))
        if G == K or 2 * G <= K:  # the JAX form takes G <= K / 2 or G == K
            np.testing.assert_array_equal(
                tb.align_window(_t(a), _t(delta), _t(center), G).numpy(),
                np.asarray(jb.align_window(jnp.asarray(a), jnp.asarray(delta), jnp.asarray(center), G)))


@pytest.mark.parametrize("name", list(CASES))
def test_banded_cost_matches_jax(name):
    left, right, s, K, G, D, min_x = _inputs(name)
    jp = _jparams(D)
    pix = tb.banded_pixel_cost(_t(left), _t(right), _t(s), band=K, ndisp=D, ftzero=jp.ftzero).numpy()
    box = tb.banded_cost_volume(_t(left), _t(right), _t(s), band=K, G=G, ndisp=D).numpy()
    for b in range(P):
        full = jsgbm.compute_pixel_cost(jnp.asarray(left[b]), jnp.asarray(right[b]), jp)
        ref = jnp.take_along_axis(full.astype(jnp.int32), jnp.asarray(s[b])[..., None] + jnp.arange(K), -1)
        np.testing.assert_array_equal(pix[b], np.asarray(ref))
        ref = jb.banded_cost_volume(jnp.asarray(left[b]), jnp.asarray(right[b]), jnp.asarray(s[b]), jp, K, G)
        np.testing.assert_array_equal(box[b], np.asarray(ref))
    # The kernel wrapper on CPU tensors runs the plain form: no launch.
    n = banded_cuda.banded_cost.launches
    out = banded_cuda.banded_cost(_t(left), _t(right), _t(s), band=K, G=G, ndisp=D, min_x=min_x)
    assert banded_cuda.banded_cost.launches == n
    assert out.dtype == torch.int16 and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), box[:, :, min_x:])


@pytest.mark.parametrize(
    "name,num_paths", [("k8", 2), ("k8", 3), ("k8", 4), ("k8", 8), ("k4_minx5", 3), ("k32", 4)]
)
def test_aggregate_matches_jax(name, num_paths):
    K, G, D, _ = CASES[name]
    rng = np.random.default_rng(num_paths)
    C = rng.integers(0, 2326, (P, H, W, K)).astype(np.int32)
    s = _shift_map(num_paths + K, D, K, G)
    P1, P2 = 200, 800
    ref = jax.jit(jax.vmap(lambda c, sv: jb.aggregate_banded_scan(c, sv, G, P1, P2, num_paths)))(C, s)
    np.testing.assert_array_equal(tb.aggregate_banded_scan(_t(C), _t(s), G, P1, P2, num_paths).numpy(),
                                  np.asarray(ref))
    # The wrappers' plain forms compose to the same sum.
    Ct, st = _t(C).to(torch.int16), _t(s)
    dn, up = banded_cuda.banded_vertical(Ct, st, G, P1, P2, cost_bound=2325, with_diagonals=num_paths == 8)
    S = dn + up
    if num_paths >= 3:
        S = S + banded_cuda.banded_horizontal(Ct, st, G, P1, P2, cost_bound=2325)
    if num_paths in (4, 8):
        S = S + banded_cuda.banded_horizontal(Ct, st, G, P1, P2, cost_bound=2325, reverse=True)
    np.testing.assert_array_equal(S.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name,num_paths,sub", [("k4_minx5", 3, True), ("k32", 8, False), ("k8", 4, True)])
def test_banded_stats_match_jax(name, num_paths, sub):
    left, right, s, K, G, D, min_x = _inputs(name)
    jp = _jparams(D, num_paths=num_paths)
    ref = jax.jit(jax.vmap(lambda l, r, sv: jb.banded_stats_scan(l, r, sv, jp, K, G, min_x, sub=sub)))(
        left, right, s)
    tp = sgbm_params_from_reference(jp)
    mine = tb.banded_stats_scan(_t(left), _t(right), _t(s), tp, K, G, min_x, sub=sub)
    packed = banded_cuda.banded_stats_pack(_t(left), _t(right), _t(s), tp, K, G, min_x, sub=sub)
    assert len(mine) == len(packed) == (4 if sub else 6)
    for a, b, want in zip(mine, packed, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [4, 16])
def test_banded_wta_matches_jax(K):
    rng = np.random.default_rng(K)
    vols = [rng.integers(0, 3000, (P, 5, 9, K)).astype(np.int16) for _ in range(3)]
    S = jnp.asarray(sum(v.astype(np.int32) for v in vols))
    ref = jsgbm.wta_scan(S, K, 10)
    six = banded_cuda.banded_wta([_t(v) for v in vols], 10)
    four = banded_cuda.banded_wta([_t(v) for v in vols], 10, sub=True)
    for a, want in zip(six, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    np.testing.assert_array_equal(four[2].numpy(), np.asarray(jsgbm.subpixel_disp16(*ref[1:5], K)))
    assert all(torch.equal(four[i], six[j]) for i, j in ((0, 0), (1, 1), (3, 5)))


def test_cuda_only_limits_raise(monkeypatch):
    """What the CUDA kernels refuse, and the storage type they pick, checked
    before any launch (a CPU tensor stands in for a CUDA one): a bound past
    int16 takes the int32 form, a band off K % 4 == 0 or above 64 and
    volumes of two types are refused."""
    monkeypatch.setattr(banded_cuda, "_on_cuda", lambda t: True)
    C = torch.zeros((1, 4, 8, 8), dtype=torch.int16)
    s = torch.zeros((1, 4, 8), dtype=torch.int32)
    assert banded_cuda._check_volume(C, 32000, 2325).dtype == torch.int32
    assert banded_cuda._check_volume(C, 32, 100).dtype == torch.int16
    assert banded_cuda._check_volume(torch.zeros((1, 4, 8, 12), dtype=torch.int16), 32, 100).shape[-1] == 12
    for K in (10, 68):
        with pytest.raises(ValueError, match="K % 4 == 0 and 4 <= K <= 64"):
            banded_cuda.banded_horizontal(torch.zeros((1, 4, 8, K), dtype=torch.int16), s, 4, 8, 32, cost_bound=100)
    with pytest.raises(TypeError):
        banded_cuda.banded_wta([C, C.to(torch.int32)], 10)


def test_eight_path_int16_bound(monkeypatch):
    """An 8-path vertical set stores the sum of three carries: the CUDA
    wrapper stores a configuration whose 3 x (cost_bound + P2) leaves int16,
    though one carry fits, as int32 at 8 paths only (a CPU tensor stands in
    for a CUDA one)."""
    C = torch.zeros((1, 4, 8, 8), dtype=torch.int16)
    s = torch.zeros((1, 4, 8), dtype=torch.int32)
    bound, P2 = 2325, 9000  # 11325 fits int16, 33975 does not
    dn, up = banded_cuda.banded_vertical(C, s, 4, 8, P2, cost_bound=bound, with_diagonals=True)  # plain: int32
    assert dn.dtype == torch.int32 and not dn.any()
    monkeypatch.setattr(banded_cuda, "_on_cuda", lambda t: True)
    assert banded_cuda._check_volume(C, P2, bound).dtype == torch.int16
    assert banded_cuda._check_volume(C, P2, bound, 3).dtype == torch.int32
