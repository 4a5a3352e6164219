"""The port's OpenCV-free ball-drop and stick-figure renders
(``synth.scenes``) against the JAX package's OpenCV renders of the same
seed, on the CPU.

The truth arrays (ball trajectories in 3D and in both views' pixels, the
33-landmark bodies) equal the reference's bit for bit: the port makes the
same numpy random calls in the same order. The pixels are held by their
mean absolute difference (levels of 255, over all frames and channels):
the backgrounds within 1 level on < 1e-3 of the values (OpenCV's float32
blur kernel against the port's rounded float64 one), the ball renders
under 0.1 (0.025-0.033 measured), the stick figures under 0.25 at
320x240 (0.10-0.11) and under 0.1 at 1920x1080 (0.020): anti-aliased
edges drawn another way, the shapes grown by OpenCV's measured rim.

The training batches (``ball_training_batch``, ``pose_training_batch``,
``_letterbox_aug``) draw the same numbers in the same order, so their
boxes and landmarks equal the reference's bit for bit and the generator
ends in the same state; the letterbox resize equals ``cv2.resize`` bit for
bit; the pixels (after the blur and noise, in levels of 255) are within
0.75 for the balls at 128x128 (0.22-0.46 measured: small anti-aliased
balls, shrunk by the letterbox) and 0.4 for the stick figures (0.14-0.23).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from stereo_vision_tpu.synth import scenes as jscenes
from stereo_vision_tpu.track.fusion import StereoRig
from stereo_vision_tpu_torch.synth import scenes
from stereo_vision_tpu_torch.track import fusion

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (f, W, H): tests/test_e2e_detectors.py's rig and its field of view at 1920 px.
RIGS = [(350.0, 320, 240), (2100.0, 1920, 1080)]


def _rigs(f, W, H):
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    kw = dict(K1=K, d1=np.zeros(8), K2=K, d2=np.zeros(8), R=np.eye(3), T=np.array([-500.0, 0, 0]))
    return fusion.StereoRig(**kw), StereoRig(**kw)


def _mad(a, b) -> float:
    return float(np.abs(a.astype(np.int32) - b).mean())


@pytest.mark.parametrize("seed", [0, 5])
def test_textured_background_matches_jax(seed):
    a = scenes.textured_background(np.random.default_rng(seed), 240, 320)
    b = jscenes.textured_background(np.random.default_rng(seed), 240, 320)
    d = np.abs(a.astype(np.int32) - b)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("f,W,H", RIGS)
def test_ball_drop_render_matches_jax(f, W, H):
    rig, jrig = _rigs(f, W, H)
    T = 40 if W < 1000 else 4
    kw = dict(T=T, fps=240.0, H=H, W=W, hold_frames=25, ball_radius_mm=80.0, seed=3)
    lf, rf, *truth = scenes.render_ball_drop_stereo(rig, **kw)
    jlf, jrf, *jtruth = jscenes.render_ball_drop_stereo(jrig, **kw)
    for a, b in zip(truth, jtruth):
        np.testing.assert_array_equal(a, b)
    assert lf.shape == jlf.shape and lf.dtype == np.uint8
    assert _mad(lf, jlf) < 0.1 and _mad(rf, jrf) < 0.1


@pytest.mark.parametrize("f,W,H", RIGS)
def test_pose_render_matches_jax(f, W, H):
    rig, jrig = _rigs(f, W, H)
    T = 30 if W < 1000 else 3
    lf, rf, gt = scenes.render_pose_stereo(rig, T=T, H=H, W=W, seed=2)
    jlf, jrf, jgt = jscenes.render_pose_stereo(jrig, T=T, H=H, W=W, seed=2)
    np.testing.assert_array_equal(gt, jgt)
    bound = 0.25 if W < 1000 else 0.1
    assert _mad(lf, jlf) < bound and _mad(rf, jrf) < bound
    body = jscenes.random_pose13(np.random.default_rng(9))
    np.testing.assert_array_equal(scenes.random_pose13(np.random.default_rng(9)), body)
    np.testing.assert_array_equal(scenes.body33_from_key13(body), jscenes.body33_from_key13(body))


def test_letterbox_aug_matches_jax():
    """Both outcomes of the coin (kept as is, or shrunk into the corner)
    over ten seeds: the image bit for bit, the points, the next draw."""
    img = scenes.textured_background(np.random.default_rng(1), 96, 128)
    pts = np.array([[10.5, 20.25], [100.0, 90.0]])
    shrunk = 0
    for seed in range(10):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        (x, p), (y, q) = scenes._letterbox_aug(a, img, pts), jscenes._letterbox_aug(b, img, pts)
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(p, q)
        assert a.random() == b.random()
        shrunk += not np.array_equal(x, img)
    assert 0 < shrunk < 10


@pytest.mark.parametrize("seed", [0, 1])
def test_ball_training_batch_matches_jax(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    imgs, *truth = scenes.ball_training_batch(a, 6)
    jimgs, *jtruth = jscenes.ball_training_batch(b, 6)
    for x, y in zip(truth, jtruth):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.random() == b.random()
    assert imgs.dtype == np.float32 and imgs.shape == jimgs.shape == (6, 128, 128, 3)
    assert np.abs(imgs - jimgs).mean() * 255 < 0.75


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_training_batch_matches_jax(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    imgs, gt = scenes.pose_training_batch(a, 4)
    jimgs, jgt = jscenes.pose_training_batch(b, 4)
    assert gt.dtype == np.float32
    np.testing.assert_array_equal(gt, jgt)
    assert a.random() == b.random()
    assert imgs.dtype == np.float32 and imgs.shape == jimgs.shape == (4, 128, 128, 3)
    assert np.abs(imgs - jimgs).mean() * 255 < 0.4


def test_synth_exports_match_jax():
    """The port's ``synth`` exports the JAX package's names; JAX's list is
    read in a subprocess."""
    from stereo_vision_tpu_torch import synth

    code = "import json, stereo_vision_tpu.synth as s; print(json.dumps(s.__all__))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert sorted(synth.__all__) == sorted(json.loads(out.stdout.strip().splitlines()[-1]))
    for name in synth.__all__:
        assert hasattr(synth, name), name
