"""The port's hierarchical SGBM against the JAX package's ``stereo/hier.py``.

Same numpy-seeded inputs on both sides, on the CPU. The float32 glue
(downsampling, shift maps, fill, splice, assembly) is the same float32
arithmetic, so every comparison is exact; only the reprojected points get
rtol=1e-6 (one float32 ulp, as in ``test_torch_pipeline.py``).

The whole path is held to JAX's per-frame ``stereo_sgbm_hier`` (its scan
backend, vmapped over two frames of each batch under one jit), which the
JAX package's own tests hold equal to its packed batch form. The JAX
references are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.ops import remap as jremap
from stereo_vision_tpu.stereo import depth as jdepth
from stereo_vision_tpu.stereo import hier as jh
from stereo_vision_tpu.stereo import sgbm as jsgbm
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.parallel import streaming as tstream
from stereo_vision_tpu_torch.stereo import banded as tb
from stereo_vision_tpu_torch.stereo import hier as th
from stereo_vision_tpu_torch.synth.scenes import scene

H, W, D = 48, 192, 128
# case -> (preset, frames per call, num_paths); HIER4_FAST_8paths runs the
# full level's 8-path aggregation (diagonal carries).
PRESETS = {"HIER_FAST": ("HIER_FAST", 8, 4), "HIER4_FAST": ("HIER4_FAST", 32, 3),
           "HIER4_FAST_8paths": ("HIER4_FAST", 32, 8)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jparams(num_paths):
    return jsgbm.StereoSGBMParams(num_disparities=D, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                                  speckle_window_size=30, speckle_range=2, num_paths=num_paths, backend="scan")


def _rig():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (xx + 0.35 * np.sin(yy / 4.0), yy + 0.3 * np.cos(xx / 6.0) - 0.2,
            xx + 0.25 * np.sin(yy / 5.0) + 0.1, yy + 0.3 * np.cos(xx / 6.0) - 0.2)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 400.0], [0, 0, 12.5, 0]], np.float32)
    return tuple(m.astype(np.float32) for m in maps), Q


@pytest.fixture(scope="module")
def reference():
    """Per preset: raw frames, the JAX-remapped integer frames, and JAX's
    per-frame hier disparity and points on the first and last frame."""
    maps, Q = _rig()
    out = {}
    for name, (preset, P, npaths) in PRESETS.items():
        frames = [scene(seed=s, H=H, W=W) for s in range(P)]
        raw_l, raw_r = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
        rl = jremap.make_remap(jnp.asarray(maps[0]), jnp.asarray(maps[1]), (H, W))
        rr = jremap.make_remap(jnp.asarray(maps[2]), jnp.asarray(maps[3]), (H, W))
        prep = lambda m, x: jnp.round(m(x.astype(jnp.float32))).astype(jnp.int32)
        lr = np.asarray(jax.vmap(lambda x: prep(rl, x))(jnp.asarray(raw_l)))
        rr_ = np.asarray(jax.vmap(lambda x: prep(rr, x))(jnp.asarray(raw_r)))
        jp, hp = _jparams(npaths), getattr(jh, preset)
        pick = [0, P - 1]
        disp = jax.jit(jax.vmap(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, hp)))(lr[pick], rr_[pick])
        pts = jax.vmap(lambda d: jdepth.reproject_disparity_to_3d(d, jnp.asarray(Q)))(disp)
        out[name] = dict(raw=(raw_l, raw_r), ints=(lr, rr_), pick=pick, disp=np.asarray(disp), pts=np.asarray(pts),
                         jp=jp, hp=hp, maps=maps, Q=Q)
    return out


@pytest.mark.parametrize("name", list(PRESETS))
def test_hier_batch_matches_jax_per_frame(reference, name):
    ref = reference[name]
    lr, rr = ref["ints"]
    mine = th.stereo_sgbm_hier_batch(_t(lr), _t(rr), convert.sgbm_params_from_reference(ref["jp"]),
                                     convert.hier_params_from_reference(ref["hp"]))
    assert mine.shape == lr.shape and mine.dtype == torch.float32
    assert (ref["disp"] > -1).mean() > 0.2
    np.testing.assert_array_equal(mine[ref["pick"]].numpy(), ref["disp"])


@pytest.mark.parametrize("name", list(PRESETS))
def test_hier_per_frame_matches_jax(reference, name):
    """The per-frame entry (exact coarse pass, one frame through the banded
    core) on the frames JAX's per-frame ``stereo_sgbm_hier`` ran."""
    ref = reference[name]
    lr, rr = ref["ints"]
    params = convert.sgbm_params_from_reference(ref["jp"])
    hp = convert.hier_params_from_reference(ref["hp"])
    for i, b in enumerate(ref["pick"]):
        mine = th.stereo_sgbm_hier(_t(lr[b]), _t(rr[b]), params, hp)
        assert mine.shape == lr.shape[1:] and mine.dtype == torch.float32
        np.testing.assert_array_equal(mine.numpy(), ref["disp"][i])


def test_hier_batch_fused_matches_jax_per_frame(reference, monkeypatch):
    """HIER_FAST's 8-frame batch with ``_FUSED_STATS`` set (the full level
    through the fused WTA) equals the unfused batch and JAX per frame."""
    ref = reference["HIER_FAST"]
    lr, rr = ref["ints"]
    params = convert.sgbm_params_from_reference(ref["jp"])
    unfused = th.stereo_sgbm_hier_batch(_t(lr), _t(rr), params, th.HIER_FAST)
    monkeypatch.setattr(th, "_FUSED_STATS", True)
    calls, assemble = [], th._assemble_fused
    monkeypatch.setattr(th, "_assemble_fused", lambda *a: calls.append(1) or assemble(*a))
    fused = th.stereo_sgbm_hier_batch(_t(lr), _t(rr), params, th.HIER_FAST)
    assert calls == [1]  # the full level took the fused WTA
    assert torch.equal(fused, unfused)
    np.testing.assert_array_equal(fused[ref["pick"]].numpy(), ref["disp"])


@pytest.mark.parametrize("name", list(PRESETS))
def test_streaming_hier_matches_jax(reference, name):
    """matcher="sgbm_hier" picks the preset by batch size (8: HIER_FAST,
    32: HIER4_FAST), like the JAX branch."""
    ref = reference[name]
    raw_l, raw_r = ref["raw"]
    params = convert.sgbm_params_from_reference(ref["jp"])
    disp, pts = tstream.batched_stereo_pipeline(raw_l, raw_r, ref["maps"], ref["Q"], matcher="sgbm_hier",
                                                params=params, device="cpu")
    np.testing.assert_array_equal(disp[ref["pick"]].numpy(), ref["disp"])
    np.testing.assert_allclose(pts[ref["pick"]].numpy(), ref["pts"], rtol=1e-6)
    stats = tstream.batched_stereo_pipeline(raw_l, raw_r, ref["maps"], ref["Q"], matcher="sgbm_hier",
                                            params=params, stats_only=True, device="cpu")
    assert stats.shape == (len(raw_l), 2)
    np.testing.assert_allclose(stats[ref["pick"], 0].numpy(), (ref["disp"] > 0).mean(axis=(1, 2)), rtol=1e-6)


def test_downsample_and_upsample_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 17, 26)).astype(np.int32)
    # 2x2 blocks summing to 2 and 6 (means 0.5 and 1.5): half-to-even ties.
    img[0, :2, :4] = [[0, 1, 1, 2], [1, 0, 1, 2]]
    for f, fx in ((2, None), (4, None), (4, 8), (3, 2)):
        ref = jax.vmap(lambda a: jh._downsample_box(a, f, fx))(jnp.asarray(img))
        mine = th.downsample_box(_t(img), f, fx)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert th.downsample_box(_t(img), 2)[0, 0, :2].tolist() == [0, 2]
    s = rng.integers(0, 120, (2, 5, 7)).astype(np.int32)
    d = (rng.integers(-16, 1600, (2, 5, 7)) / 16.0).astype(np.float32)  # 1/16 fractions
    np.testing.assert_array_equal(th._upsample_repeat(_t(s), 4, 2).numpy(), np.asarray(jh._upsample_repeat(s, 4, 2)))
    np.testing.assert_array_equal(th._upsample_repeat(_t(d), 2).numpy(),
                                  np.asarray(jh._upsample_repeat(jnp.asarray(d), 2, exact_float=True)))


@pytest.mark.parametrize("f", [2, 4])
def test_downsample_matches_jax_pallas_pack(f):
    """The plain form the CUDA downsample is held to, against the JAX
    package's Pallas ``downsample_box_pack`` (interpret mode), which its TPU
    path runs for the coarse and mid levels."""
    from stereo_vision_tpu.stereo.banded_pallas import downsample_box_pack

    rng = np.random.default_rng(40 + f)
    img = rng.integers(0, 256, (4, 48, 96 + f)).astype(np.int32)
    img[0, :f, :2 * f] = 1  # block sums of f*f (mean 1) and ties at .5 below
    img[1, :2, :4] = [[0, 1, 1, 2], [1, 0, 1, 2]]
    ref = np.asarray(downsample_box_pack(jnp.asarray(img), f, interpret=True))
    n = th.downsample_box.launches
    mine = th.downsample_box(_t(img), f)
    assert th.downsample_box.launches == n  # CPU tensors take the plain form
    np.testing.assert_array_equal(mine.numpy(), ref)


def test_fill_pool_match_jax():
    rng = np.random.default_rng(1)
    d = (rng.integers(0, 640, (2, 13, 21)) / 16.0).astype(np.float32)
    d[rng.random(d.shape) < 0.4] = -1.0
    d[1, :, :9] = -1.0  # a hole wider than 12 rounds reach
    for below in (0.0, 2.5):
        ref = jax.vmap(lambda a: jh._fill_invalid(a, below))(jnp.asarray(d))
        np.testing.assert_array_equal(th._fill_invalid(_t(d), below).numpy(), np.asarray(ref))
    for r in (0, 1, 2):
        for jop, top in ((jnp.minimum, torch.minimum), (jnp.maximum, torch.maximum)):
            ref = jax.vmap(lambda a: jh._pool(a, r, jop))(jnp.asarray(d))
            np.testing.assert_array_equal(th._pool(_t(d), r, top).numpy(), np.asarray(ref))


@pytest.mark.parametrize("variant", ["default", "hier_fast", "hier4_mid", "hier4_full", "wide", "no_anchor", "fx8"])
def test_shift_map_matches_jax(variant):
    lv = jh._prior_levels(jh.HIER4_FAST)[0]
    hp, Dv, Hc, Wc = {
        "default": (jh.HierParams(), D, 12, 48),
        "hier_fast": (jh.HIER_FAST, D, 12, 48),
        "hier4_mid": (jh._level_shift_params(jh.HIER4_FAST, lv, 4), D // 2, 12, 48),
        "hier4_full": (jh.HIER4_FAST._replace(coarse_factor=2), D, 24, 96),
        "wide": (jh.HIER_FAST._replace(wide_margin=3.0), D, 12, 48),
        "no_anchor": (jh.HIER_FAST._replace(anchor_hi=False), D, 12, 48),
        "fx8": (jh.HierParams(coarse_fx=8), D, 12, 24),
    }[variant]
    rng = np.random.default_rng(len(variant))
    # Prior values on the 1/16 grid, jumps and holes: .5 ties in the band
    # centre and the G-quantisation occur.
    prior = (rng.integers(0, 16 * 30, (2, Hc, Wc)) / 16.0).astype(np.float32)
    prior[:, Hc // 3 : 2 * Hc // 3, Wc // 3 : 2 * Wc // 3] += 12.5
    prior[rng.random(prior.shape) < 0.1] = -1.0
    ref = jax.vmap(lambda a: jh.shift_map(a, Dv, hp))(jnp.asarray(prior))
    mine = th.shift_map(_t(prior), Dv, convert.hier_params_from_reference(hp))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_splice_and_assemble_match_jax():
    rng = np.random.default_rng(2)
    P, Hm, Wm, Dm, Bm, fc = 2, 24, 96, 64, 8, 2
    disp_m = (rng.integers(-16, 16 * 70, (P, Hm, Wm)) / 16.0).astype(np.float32)
    disp_m[disp_m < 0] = -1.0
    best_k = rng.integers(0, Bm, (P, Hm, Wm - Dm)).astype(np.int32)
    disp_c = (rng.integers(-16, 16 * 30, (P, Hm // fc, Wm // fc)) / 16.0).astype(np.float32)
    disp_c[disp_c < 0] = -1.0
    s_m = (rng.integers(0, (Dm - Bm) // 4 + 1, (P, Hm, Wm)) * 4).astype(np.int32)
    ref = jax.vmap(lambda a, b, c, s: jh._splice_coarse(a, b, c, s, Bm, Dm, fc))(
        jnp.asarray(disp_m), jnp.asarray(best_k), jnp.asarray(disp_c), jnp.asarray(s_m))
    mine = th._splice_coarse(_t(disp_m), _t(best_k), _t(disp_c), _t(s_m), Bm, Dm, fc)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))

    # Assembly of real banded stats (4- and 6-stat), LR check over the full range.
    left, right = (np.stack(a) for a in zip(*[scene(seed=s, H=Hm, W=Wm) for s in range(P)]))
    tp = convert.sgbm_params_from_reference(_jparams(3))._replace(num_disparities=Dm)
    jp = _jparams(3)._replace(num_disparities=Dm)
    for sub in (False, True):
        stats = tb.banded_stats_scan(_t(left), _t(right), _t(s_m), tp, Bm, 4, Dm, sub=sub)
        mine = th._assemble_disparity(stats, _t(s_m[..., Dm:]), Wm, Dm, Dm, Bm, tp)
        for b in range(P):
            ref = jh._assemble_disparity([jnp.asarray(st[b].numpy()) for st in stats], jnp.asarray(s_m[b, :, Dm:]),
                                         Wm, Dm, Dm, Bm, jp, "scan")
            np.testing.assert_array_equal(mine[b].numpy(), np.asarray(ref))


def test_params_conversion_and_checks():
    hp = convert.hier_params_from_reference(jh.HIER4_FAST._replace(mid_levels=(jh.MidLevel(2, 8, 4),)))
    assert isinstance(hp.mid_levels[0], th.MidLevel) and hp.mid_levels[0].band == 8
    for name in ("HIER_FAST", "HIER8_FAST", "HIER4_FAST"):
        assert convert.hier_params_from_reference(getattr(jh, name)) == getattr(th, name)
    assert convert.hier_params_from_reference(jh.HierParams()) == th.HierParams()
    left = torch.zeros((4, 48, 192), dtype=torch.int32)
    params = th.StereoSGBMParams(num_disparities=D)
    with pytest.raises(ValueError, match="128 lanes"):
        th.stereo_sgbm_hier_batch(left, left, params, th.HIER_FAST)
    with pytest.raises(ValueError, match="tile"):
        th.stereo_sgbm_hier_batch(left, left, params, th.HierParams(tile=3))
    with pytest.raises(ValueError, match="multiple of 64"):
        th.stereo_sgbm_hier(left[0], left[0], params._replace(num_disparities=96), th.HIER_FAST)
    with pytest.raises(ValueError, match="one \\(H, W\\) pair"):
        th.stereo_sgbm_hier(left, left, params, th.HIER_FAST)
