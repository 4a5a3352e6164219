"""The hier presets and chains that ``tests/test_torch_hier.py`` does not
run, against the JAX package's per-frame ``stereo_sgbm_hier``.

- ``HIER8_FAST`` (16 frames, band 8 behind a 1/2-res mid level of band 8,
  speckle cap 4): what ``matcher="sgbm_hier"`` picks for 16 frames, the
  CLI's ``stream --window 16``.
- ``HierParams()`` (4 frames, band 32 with the 6-stat WTA, the coarse LR
  check on, the speckle filter uncapped): the default of both hier
  entries and the pipeline's pick for any other batch size.
- The two-level ``mid_levels`` chain of ``tests/test_banded_pallas.py``
  (coarse factor 8, mid levels at 1/4 and 1/2 res): its pyramid is one
  call with the three nesting factors.
- The per-frame entry with every default (8 paths, ``HierParams()``).

Same numpy-seeded inputs on both sides, on the CPU; disparities exact,
reprojected points within rtol 1e-6 (one float32 ulp). JAX's per-frame
entry runs vmapped over the first and last frame under one jit, once per
module; never its ``interpret=True`` batch form.
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
from stereo_vision_tpu_torch.stereo import banded_cuda
from stereo_vision_tpu_torch.stereo import hier as th
from stereo_vision_tpu_torch.synth.scenes import scene

H, W, D = 48, 192, 128
TWO_LEVEL = jh.HIER8_FAST._replace(coarse_factor=8, mid_levels=(
    jh.MidLevel(4, 16, 8, tile=2, margin=4.0, local_window=1, paths=2),
    jh.MidLevel(2, 8, 4, tile=2, margin=2.5, local_window=1, paths=2)))
# case -> (JAX preset, frames per call, num_paths, whether the pipeline
# picks the preset itself for that many frames)
CASES = {"HIER8_FAST": (jh.HIER8_FAST, 16, 3, True), "HierParams": (jh.HierParams(), 4, 4, True),
         "two_level": (TWO_LEVEL, 16, 3, False)}
# case -> (the pyramid's factors, LR checks (the full level's, and the
# coarse and mid levels' where coarse_lr >= 0), the speckle filter's cap)
PATHS = {"HIER8_FAST": (((4, 4), (2, 2)), 1, 4), "HierParams": (((4, 4),), 2, None),
         "two_level": (((8, 8), (4, 4), (2, 2)), 1, 4)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the plain forms are many small ops, and
    several test workers sharing the cores otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """Per case: raw frames, the JAX-remapped integer frames, and JAX's
    per-frame hier disparity and points on the first and last frame."""
    maps, Q = _rig()
    rl = jremap.make_remap(jnp.asarray(maps[0]), jnp.asarray(maps[1]), (H, W))
    rr = jremap.make_remap(jnp.asarray(maps[2]), jnp.asarray(maps[3]), (H, W))
    prep = lambda m, x: jnp.round(m(x.astype(jnp.float32))).astype(jnp.int32)  # noqa: E731
    out = {}
    for name, (hp, P, npaths, _) in CASES.items():
        frames = [scene(seed=s, H=H, W=W) for s in range(P)]
        raw_l, raw_r = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
        lr = np.asarray(jax.vmap(lambda x: prep(rl, x))(jnp.asarray(raw_l)))
        rr_ = np.asarray(jax.vmap(lambda x: prep(rr, x))(jnp.asarray(raw_r)))
        jp = _jparams(npaths)
        pick = [0, P - 1]
        disp = jax.jit(jax.vmap(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, hp)))(lr[pick], rr_[pick])
        pts = jax.vmap(lambda d: jdepth.reproject_disparity_to_3d(d, jnp.asarray(Q)))(disp)
        out[name] = dict(raw=(raw_l, raw_r), ints=(lr, rr_), pick=pick, disp=np.asarray(disp), pts=np.asarray(pts),
                         jp=jp, hp=hp, maps=maps, Q=Q)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_preset_batch_matches_jax_per_frame(reference, name, monkeypatch):
    """The batch entry: one pyramid call for every level (factors that
    nest: one launch on the card), the LR check at every level that runs it
    (HierParams() checks its coarse level too), the speckle filter at the
    preset's cap (HierParams(): none)."""
    ref = reference[name]
    lr, rr = ref["ints"]
    hp = convert.hier_params_from_reference(ref["hp"])
    calls = {"pyramid": [], "lr": 0, "speckle": []}
    pyramid, lr_fail, speckle = th.downsample_pyramid, th.lr_fail_packed, th.speckle_filter
    monkeypatch.setattr(th, "downsample_pyramid", lambda l, r, f: calls["pyramid"].append(f) or pyramid(l, r, f))

    def lr_counted(*a, **k):
        calls["lr"] += 1
        return lr_fail(*a, **k)

    monkeypatch.setattr(th, "lr_fail_packed", lr_counted)
    monkeypatch.setattr(th, "speckle_filter", lambda *a, **k: calls["speckle"].append(k["max_diameter"])
                        or speckle(*a, **k))
    mine = th.stereo_sgbm_hier_batch(_t(lr), _t(rr), convert.sgbm_params_from_reference(ref["jp"]), hp)
    factors, lr_checks, cap = PATHS[name]
    assert calls["pyramid"] == [factors] and banded_cuda.pyramid_nests(factors)
    assert calls["lr"] == lr_checks and calls["speckle"] == [cap]
    assert mine.shape == lr.shape and mine.dtype == torch.float32
    assert (ref["disp"] > -1).mean() > 0.2
    np.testing.assert_array_equal(mine[ref["pick"]].numpy(), ref["disp"])


@pytest.mark.parametrize("name", list(CASES))
def test_preset_per_frame_matches_jax(reference, name):
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


@pytest.mark.parametrize("name", list(CASES))
def test_preset_pipeline_matches_jax(reference, name):
    """``batched_stereo_pipeline(matcher="sgbm_hier")``: at 16 frames it
    picks HIER8_FAST, at 4 ``HierParams()`` (as the JAX branch); the
    two-level chain goes in as ``hier_params``."""
    ref = reference[name]
    raw_l, raw_r = ref["raw"]
    params = convert.sgbm_params_from_reference(ref["jp"])
    hp = None if CASES[name][3] else convert.hier_params_from_reference(ref["hp"])
    disp, pts = tstream.batched_stereo_pipeline(raw_l, raw_r, ref["maps"], ref["Q"], matcher="sgbm_hier",
                                                params=params, hier_params=hp, device="cpu")
    assert disp.shape == raw_l.shape and pts.shape == (*raw_l.shape, 3)
    np.testing.assert_array_equal(disp[ref["pick"]].numpy(), ref["disp"])
    np.testing.assert_allclose(pts[ref["pick"]].numpy(), ref["pts"], rtol=1e-6)


def test_per_frame_defaults_match_jax():
    """The library's default call, ``stereo_sgbm_hier(left, right)``: 8
    paths, no LR check or speckle at the full level, ``HierParams()``."""
    left, right = scene(seed=5, H=H, W=W)
    ref = jax.jit(jh.stereo_sgbm_hier)(jnp.asarray(left, jnp.int32), jnp.asarray(right, jnp.int32))
    assert convert.sgbm_params_from_reference(jsgbm.StereoSGBMParams()) == th.StereoSGBMParams()
    mine = th.stereo_sgbm_hier(_t(left), _t(right))
    assert (np.asarray(ref) > -1).mean() > 0.2
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
