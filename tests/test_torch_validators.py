"""The port's ``track.kinematics`` and ``track.validators`` against the JAX
package's, and the CLI's ``validate-distance`` chain (corners -> undistort
with the rectified R/P -> triangulate -> distance), on the CPU.

Float64 on both sides (``jax_enable_x64``): every number within rtol 1e-9.
The chain runs on a stereo pair of the port's board renders handed to both
packages as the same arrays: the detected corners within 1e-2 px of
JAX's, the distances within rtol 1e-5 of each other (float32 corners
carried through the geometry) and of the truth within 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.detect.checkerboard import find_chessboard_corners as jfind
from stereo_vision_tpu.ops.distortion import undistort_points as jundistort
from stereo_vision_tpu.ops.rectify import stereo_rectify as jrectify
from stereo_vision_tpu.ops.triangulate import triangulate_points as jtriangulate
from stereo_vision_tpu.track import kinematics as jkin
from stereo_vision_tpu.track import validators as jval
from stereo_vision_tpu_torch import ops, track
from stereo_vision_tpu_torch.detect import find_chessboard_corners
from stereo_vision_tpu_torch.synth.boards import render_board_view
from stereo_vision_tpu_torch.track import kinematics, validators

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_track_exports_match_jax_modules():
    names = {n for m in (jkin, jval) for n in dir(m) if not n.startswith("_")} & set(
        __import__("stereo_vision_tpu.track", fromlist=["__all__"]).__all__)
    assert sorted(track.__all__) == sorted(names)
    for name in track.__all__:
        assert hasattr(track, name), name


def _drop(seed, n=60, fps=240.0, g=9800.0, noise=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fps + rng.uniform(0, 2e-4, n)
    y = 100.0 + 300.0 * t + 0.5 * g * t**2 + rng.normal(0, noise, n)
    pos = np.stack([rng.normal(0, 1, n), y, 2000.0 + rng.normal(0, 1, n)], axis=1)
    return pos, t


@pytest.mark.parametrize("method", ["fit", "fd"])
@pytest.mark.parametrize("up_is_negative", [True, False])
def test_estimate_gravity_matches_jax(method, up_is_negative):
    pos, t = _drop(0)
    kw = dict(method=method, up_is_negative=up_is_negative)
    g, err = kinematics.estimate_gravity(pos, t, device="cpu", **kw)
    jg, jerr = jkin.estimate_gravity(pos, t, **kw)
    np.testing.assert_allclose([g, err], [jg, jerr], rtol=RTOL)


def test_finite_differences_match_jax():
    rng = np.random.default_rng(1)
    seq = rng.normal(0, 100, (12, 13, 3))
    ts = np.cumsum(rng.uniform(0.01, 0.05, 12))
    v = kinematics.joint_velocities(seq, 1 / 60, device="cpu")
    np.testing.assert_allclose(v.numpy(), np.asarray(jkin.joint_velocities(jnp.asarray(seq), 1 / 60)), rtol=RTOL)
    a = kinematics.joint_accelerations(v, 1 / 60)
    np.testing.assert_allclose(a.numpy(), np.asarray(jkin.joint_accelerations(jkin.joint_velocities(
        jnp.asarray(seq), 1 / 60), 1 / 60)), rtol=RTOL, atol=1e-6)
    out = kinematics.finite_difference(torch.from_numpy(seq), torch.from_numpy(ts))
    np.testing.assert_allclose(out.numpy(), np.asarray(jkin.finite_difference(jnp.asarray(seq), jnp.asarray(ts))),
                               rtol=RTOL)


def test_start_of_motion_and_drop_velocity_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(6):
        y = np.cumsum(np.where(np.arange(40) > rng.integers(5, 30), rng.uniform(3, 12, 40), rng.normal(0, 1, 40)))
        pos = np.stack([np.zeros(40), y], axis=1)
        for kw in ({}, dict(num_frames=3, threshold=4.0), dict(num_frames=50)):
            assert kinematics.detect_start_of_motion(pos, **kw) == jkin.detect_start_of_motion(pos, **kw)
    assert kinematics.theoretical_drop_velocity(1500.0) == jkin.theoretical_drop_velocity(1500.0)


def test_validators_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal([0, 0, 2400.0], 50.0, (28, 3))
    pairs = [(validators.validate_baseline(np.array([-101.0, 2.0, 1.0]), 100.0),
              jval.validate_baseline(np.array([-101.0, 2.0, 1.0]), 100.0)),
             (validators.validate_distance(torch.from_numpy(pts), 2500.0), jval.validate_distance(pts, 2500.0)),
             (validators.validate_distance(pts, 2400.0, 0.1), jval.validate_distance(pts, 2400.0, 0.1)),
             (validators.validate_length(pts[0], pts[5]), jval.validate_length(pts[0], pts[5])),
             (validators.validate_length(pts[0], pts[1], 100.0, 50.0, "square"),
              jval.validate_length(pts[0], pts[1], 100.0, 50.0, "square")),
             (validators.validate_sphere_diameter(pts[:10], 700.0), jval.validate_sphere_diameter(pts[:10], 700.0)),
             (validators.validate_gravity(*_drop(4), device="cpu"), jval.validate_gravity(*_drop(4))),
             (validators.ValidationResult.make("zero", 1.0, 0.0, 5.0), jval.ValidationResult.make("zero", 1.0, 0.0, 5.0))]
    for out, ref in pairs:
        assert out.name == ref.name and out.passed == ref.passed
        np.testing.assert_allclose(out[1:4], ref[1:4], rtol=RTOL)


def test_estimate_gravity_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kinematics.estimate_gravity(*_drop(5))


def test_validate_distance_chain_matches_jax():
    """A 7x4, 60 mm board 1.2 m from a 100 mm rig of 640x360 cameras: each
    view rendered by the port, detected by both packages, undistorted with
    the rectified R/P, triangulated and measured."""
    W, H, f = 640, 360, 500.0
    K1 = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]])
    K2 = np.array([[f + 4, 0, (W - 1) / 2 + 3], [0, f + 4, (H - 1) / 2 - 2], [0, 0, 1]])
    d1, d2 = np.zeros(5), np.zeros(5)
    R, T = np.eye(3), np.array([-100.0, 0.0, 0.0])
    cols, rows, sq = 7, 4, 60.0
    centre = np.array([(cols - 1) * sq / 2, (rows - 1) * sq / 2, 0.0])
    tvec = np.array([-20.0, 10.0, 1200.0]) - centre
    rvec = np.array([0.05, -0.1, 0.02])
    distance = float(np.linalg.norm(ops.rodrigues(torch.from_numpy(rvec)).numpy() @ centre + tvec))
    views = [render_board_view(K, rvec, tv, (W, H), cols, rows, sq, device="cpu")[0]
             for K, tv in ((K1, tvec), (K2, tvec + T))]  # camera 2 at X2 = X1 + T
    corners, jcorners = [], []
    for img in views:
        ok, c = find_chessboard_corners(img, (cols, rows), device="cpu")
        jok, jc = jfind(img, (cols, rows), backend="jax")
        assert ok and jok
        np.testing.assert_allclose(c, np.asarray(jc), rtol=0, atol=1e-2)
        corners.append(c)
        jcorners.append(np.asarray(jc))
    rect = ops.stereo_rectify(K1, d1, K2, d2, (W, H), R, T, device="cpu")
    jR1, jR2, jP1, jP2, _ = jrectify(jnp.asarray(K1), jnp.asarray(d1), jnp.asarray(K2), jnp.asarray(d2), (W, H),
                                     jnp.asarray(R), jnp.asarray(T))[:5]
    ul = ops.undistort_points(corners[0].astype(np.float64), K1, d1, R=rect.R1, P=rect.P1, device="cpu")
    ur = ops.undistort_points(corners[1].astype(np.float64), K2, d2, R=rect.R2, P=rect.P2, device="cpu")
    pts = ops.triangulate_points(rect.P1[:3, :4], rect.P2[:3, :4], ul, ur)
    res = validators.validate_distance(pts, distance)
    jul = jundistort(jnp.asarray(jcorners[0], jnp.float64), jnp.asarray(K1), jnp.asarray(d1), R=jR1, P=jP1)
    jur = jundistort(jnp.asarray(jcorners[1], jnp.float64), jnp.asarray(K2), jnp.asarray(d2), R=jR2, P=jP2)
    jres = jval.validate_distance(np.asarray(jtriangulate(jP1[:3, :4], jP2[:3, :4], jul, jur)), distance)
    assert res.passed and jres.passed and res.error_percent < 1.0
    np.testing.assert_allclose(res.measured, jres.measured, rtol=1e-5)
