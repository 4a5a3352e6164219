"""The port's batched_stereo_pipeline(matcher="sgbm") against the JAX one.

Same numpy inputs (int32 frames, float32 maps and Q) on both sides, on the
CPU. Disparity must be exactly equal. Points get rtol=1e-6: both sides
evaluate the same float32 expression in the same order, but XLA may fuse
a multiply-add that torch rounds twice (one float32 ulp).
"""

import importlib.util
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.parallel import streaming as jstream
from stereo_vision_tpu.stereo.sgbm import StereoSGBMParams as JParams
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.parallel import streaming as tstream
from stereo_vision_tpu_torch.stereo import banded_cuda, hier
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams
from stereo_vision_tpu_torch.synth import scenes

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W, B = 30, 80, 2


def _inputs():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (B, H, W + 40)).astype(np.int32)
    left, right = base[..., 20 : 20 + W], base[..., 13 : 13 + W]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (
        (xx + 0.35 * np.sin(yy / 4.0)).astype(np.float32),
        (yy + 0.3 * np.cos(xx / 6.0) - 0.2).astype(np.float32),
        (xx + 0.25 * np.sin(yy / 5.0) + 0.1).astype(np.float32),
        (yy + 0.3 * np.cos(xx / 6.0) - 0.2).astype(np.float32),
    )
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 400.0], [0, 0, 12.5, 0]], np.float32)
    return left, right, maps, Q


_JP = JParams(num_disparities=16, block_size=3, uniqueness_ratio=10, disp12_max_diff=1,
              speckle_window_size=15, speckle_range=2, backend="scan")


def test_pipeline_matches_jax():
    left, right, maps, Q = _inputs()
    jd, jp = jstream.batched_stereo_pipeline(
        jnp.asarray(left), jnp.asarray(right), tuple(jnp.asarray(m) for m in maps), jnp.asarray(Q),
        matcher="sgbm", params=_JP,
    )
    td, tp = tstream.batched_stereo_pipeline(
        left, right, maps, Q, matcher="sgbm", params=convert.sgbm_params_from_reference(_JP), device="cpu"
    )
    assert (np.asarray(jd) > -1).mean() > 0.2
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def test_pipeline_stats_only_matches_jax():
    left, right, maps, Q = _inputs()
    ref = jstream.batched_stereo_pipeline(
        jnp.asarray(left), jnp.asarray(right), tuple(jnp.asarray(m) for m in maps), jnp.asarray(Q),
        matcher="sgbm", params=_JP, stats_only=True,
    )
    # Through the conversion helper, as a caller carrying state over would.
    tmaps, tQ = convert.pipeline_inputs_from_numpy(maps, Q, device="cpu")
    mine = tstream.batched_stereo_pipeline(
        torch.from_numpy(left), torch.from_numpy(right), tmaps, tQ,
        params=convert.sgbm_params_from_reference(_JP), stats_only=True, device="cpu",
    )
    assert mine.shape == (B, 2)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-6)


def test_frame_stats_median_averages_middle_values():
    disp = torch.tensor([[[1.0, 2.0, -1.0, 3.0]], [[-1.0, -1.0, -1.0, -1.0]]])
    z = torch.tensor([[[4.0, 10.0, 99.0, 7.0]], [[1.0, 1.0, 1.0, 1.0]]])
    pts = torch.stack([z, z, z], dim=-1)
    d2 = torch.tensor([[[1.0, 2.0, 5.0, 3.0]]])
    z2 = torch.tensor([[[4.0, 10.0, 8.0, 7.0]]])
    out = tstream._frame_stats(torch.cat([disp, d2]), torch.cat([pts, torch.stack([z2] * 3, -1)]))
    ref = jstream._frame_stats(jnp.asarray(torch.cat([disp, d2]).numpy()),
                               jnp.asarray(torch.cat([pts, torch.stack([z2] * 3, -1)]).numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, equal_nan=True)
    assert out[2, 1] == 7.5  # (7 + 8) / 2, where torch.nanmedian gives 7


def test_other_matchers_name_their_roadmap_item():
    """Every matcher of the JAX pipeline is ported: ``bm`` runs (against JAX
    in tests/test_torch_bm.py), takes only its own params, and an unknown
    matcher is refused."""
    from stereo_vision_tpu_torch.stereo.bm import StereoBMParams

    left, right, maps, Q = _inputs()
    disp, pts = tstream.batched_stereo_pipeline(left, right, maps, Q, matcher="bm",
                                                params=StereoBMParams(num_disparities=16, block_size=9), device="cpu")
    assert disp.shape == (B, H, W) and pts.shape == (B, H, W, 3) and (disp > -1).any()
    with pytest.raises(TypeError, match="StereoBMParams"):
        tstream.batched_stereo_pipeline(left, right, maps, Q, matcher="bm", params=_JP, device="cpu")
    with pytest.raises(TypeError, match="StereoSGBMParams"):
        tstream.batched_stereo_pipeline(left, right, maps, Q, params=StereoBMParams(), device="cpu")
    with pytest.raises(ValueError, match="unknown matcher"):
        tstream.batched_stereo_pipeline(left, right, maps, Q, matcher="census", device="cpu")


@pytest.mark.parametrize("option", ["banded_8_paths_on_cuda", "coarse_stride"])
def test_unported_hier_options_name_their_roadmap_item(option, monkeypatch):
    if option == "coarse_stride":
        # Ported now: HierParams(coarse_stride=2) (band 32, coarse LR on) per
        # frame, against JAX's per-frame stereo_sgbm_hier.
        from stereo_vision_tpu.stereo import hier as jh

        left, right = (a.astype(np.int32) for a in scenes.scene(seed=5, H=32, W=160))
        jp = _JP._replace(num_disparities=64, block_size=5)
        ref = jax.jit(lambda a, b: jh.stereo_sgbm_hier(a, b, jp, jh.HierParams(coarse_stride=2)))(left, right)
        mine = hier.stereo_sgbm_hier(torch.from_numpy(left), torch.from_numpy(right),
                                     convert.sgbm_params_from_reference(jp), hier.HierParams(coarse_stride=2))
        assert (np.asarray(ref) > -1).mean() > 0.2
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    else:
        # The 8-path option is ported now: the CUDA wrapper takes the diagonal
        # carries and stores them as int32 where their tripled range leaves
        # int16, before any launch (a CPU tensor stands in for a CUDA one).
        monkeypatch.setattr(banded_cuda, "_on_cuda", lambda t: True)
        C = torch.zeros((1, 4, 8, 8), dtype=torch.int16)
        assert banded_cuda._check_volume(C, 9000, 2325, 3).dtype == torch.int32
        assert banded_cuda._check_volume(C, 9000, 2325, 1).dtype == torch.int16


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right, maps, Q = _inputs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tstream.batched_stereo_pipeline(left, right, maps, Q)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.pipeline_inputs_from_numpy(maps, Q)


def test_params_from_reference():
    p = convert.sgbm_params_from_reference(_JP)
    assert isinstance(p, StereoSGBMParams)
    assert (p.P1, p.P2, p.ftzero, p.num_disparities) == (_JP.P1, _JP.P2, _JP.ftzero, 16)
    assert convert.sgbm_params_from_reference({"num_disparities": 32, "backend": "pallas"}).num_disparities == 32


def test_port_imports_no_jax():
    """Importing every port module (``pipeline.*`` and ``__main__`` among
    them) and chip_smoke.py leaves jax, flax, orbax, cv2, matplotlib (only
    the functions that plot import it) and stereo_vision_tpu out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import stereo_vision_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert {p.__name__ + '.__main__', p.__name__ + '.pipeline.cli', p.__name__ + '.io.png'} <= set(names)\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orbax', 'cv2', 'matplotlib', 'stereo_vision_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('stereo_vision_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_scenes_match_bench():
    spec = importlib.util.spec_from_file_location("bench_for_scenes", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for mine, ref in ((scenes.scene(), bench._scene()), (scenes.scene(3, 110.0), bench._scene(3, 110.0)),
                      (scenes.scene_occ(), bench._scene_occ())):
        np.testing.assert_array_equal(mine[0], ref[0])
        np.testing.assert_array_equal(mine[1], ref[1])
    a = np.where(np.arange(20) % 3 == 0, -1.0, np.arange(20) * 0.5)
    assert scenes.agreement(a, a + 0.9) == bench._agreement(a, a + 0.9)
