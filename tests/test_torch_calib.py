"""The port's calibration (``stereo_vision_tpu_torch.calib``) against the JAX
package's ``calib`` modules.

Synthetic 9x6 boards rendered with the JAX package's ``project_points`` on
the K and distortion of ``tests/test_calibration.py``, float64 on both sides
(``jax_enable_x64``, ``tests/conftest.py``), on the CPU. Both solve the same
least-squares problem with the same Levenberg-Marquardt rule; the products
are summed in another order (elementwise sums against XLA's dots, PyTorch's
solve against LAPACK's), so the calibrations agree to float64 rounding
carried through the iterations: K, dist, tvecs and T within rtol 1e-5,
rvecs and R within atol 1e-6, rms and per-frame errors within 1e-6 px,
E and F within rtol 1e-5, the kept frames equal. Near the stopping rule
(a relative cost change below 1e-12, at float64 rounding) the two may stop
an iteration apart on a calibration, which moves nothing above these
tolerances; on the small LM problems the iterations are equal and the
parameters within rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.calib import extrinsics as jext
from stereo_vision_tpu.calib import gates as jgates
from stereo_vision_tpu.calib import intrinsics as jint
from stereo_vision_tpu.calib import lm as jlm
from stereo_vision_tpu.calib import pairs as jpairs
from stereo_vision_tpu.calib import selection as jsel
from stereo_vision_tpu.calib import targets as jtargets
from stereo_vision_tpu.ops import rotation as jrot
from stereo_vision_tpu.ops.distortion import project_points
from stereo_vision_tpu_torch import calib
from stereo_vision_tpu_torch.calib import gates, pairs
from stereo_vision_tpu_torch.ops import rotation as trot

SIZE = (1920, 1080)
# tests/test_calibration.py's camera.
K_TRUE = np.array([[1450.0, 0, 955.0], [0, 1455.0, 545.0], [0, 0, 1.0]])
DIST_TRUE = np.array([-0.15, 0.04, 8e-4, -6e-4, -0.006])
# A converged stereo rig: camera 2 0.5 m to the right, turned 0.05 rad.
RVEC_RIG, T_RIG = np.array([0.01, -0.05, 0.004]), np.array([-500.0, 6.0, 20.0])


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the plain forms are many small ops, and
    several test workers sharing the cores otherwise oversubscribe them
    (a test here ran ~80x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _project(obj, rvec, tvec):
    return np.asarray(project_points(jnp.asarray(obj), jnp.asarray(rvec), jnp.asarray(tvec), jnp.asarray(K_TRUE),
                                     jnp.asarray(DIST_TRUE)))


def _inside(pts):
    return (pts > 20).all() and (pts[:, 0] < SIZE[0] - 20).all() and (pts[:, 1] < SIZE[1] - 20).all()


def render_views(n_frames, seed, stereo=False, noise=0.1):
    """(obj (54, 3), corners (F, 54, 2)[, corners of camera 2]) of a 9x6,
    100 mm board in random poses that every camera sees whole."""
    rng = np.random.default_rng(seed)
    obj = np.asarray(jtargets.checkerboard_object_points(9, 6, 100.0), np.float64)
    Rr = np.asarray(jrot.rodrigues(jnp.asarray(RVEC_RIG)))
    c1, c2 = [], []
    while len(c1) < n_frames:
        rvec = rng.uniform(-0.5, 0.5, 3)
        tvec = np.array([rng.uniform(-700, 300), rng.uniform(-500, 150), rng.uniform(1800, 3200)])
        p1 = _project(obj, rvec, tvec)
        if not _inside(p1):
            continue
        if stereo:
            R1 = np.asarray(jrot.rodrigues(jnp.asarray(rvec)))
            p2 = _project(obj, np.asarray(jrot.rodrigues_inv(jnp.asarray(Rr @ R1))), Rr @ tvec + T_RIG)
            if not _inside(p2):
                continue
            c2.append(p2 + rng.normal(0, noise, p2.shape))
        c1.append(p1 + rng.normal(0, noise, p1.shape))
    return (obj, np.stack(c1)) + ((np.stack(c2),) if stereo else ())


def _curve_problem():
    t = np.linspace(0.0, 3.0, 40)
    y = 2.5 * np.exp(-1.3 * t) + 0.3 * np.sin(2.0 * t) + np.random.default_rng(0).normal(0, 0.01, 40)
    tt, ty = torch.from_numpy(t), torch.from_numpy(y)
    jf = lambda p: p[0] * jnp.exp(-p[1] * t) + p[2] * jnp.sin(p[3] * t) - y
    tf = lambda p: p[0] * torch.exp(-p[1] * tt) + p[2] * torch.sin(p[3] * tt) - ty
    return jf, tf, np.array([1.0, 1.0, 0.1, 1.8])


def _rigid_problem():
    """A rotation vector and translation fitted to 3D point pairs, from
    rvec = 0: the Jacobian at the start is the Rodrigues Taylor branch's."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-1.0, 1.0, (30, 3))
    Y = X @ np.asarray(jrot.rodrigues(jnp.asarray([0.2, -0.1, 0.05]))).T + np.array([0.3, -0.2, 0.1])
    Y = Y + rng.normal(0, 1e-3, Y.shape)
    tX, tY = torch.from_numpy(X), torch.from_numpy(Y)
    jf = lambda p: (jnp.asarray(X) @ jrot.rodrigues(p[:3]).T + p[3:] - Y).reshape(-1)
    tf = lambda p: (trot.mv(trot.rodrigues(p[:3]), tX) + p[3:] - tY).reshape(-1)
    return jf, tf, np.zeros(6)


@pytest.mark.parametrize("problem", [_curve_problem, _rigid_problem])
@pytest.mark.parametrize("masked", [False, True])
def test_levenberg_marquardt_matches_jax(problem, masked):
    jf, tf, x0 = problem()
    mask = None
    if masked:
        mask = np.ones_like(x0)
        mask[2] = 0
    ref = jlm.levenberg_marquardt(jf, jnp.asarray(x0), mask=None if mask is None else jnp.asarray(mask))
    res = calib.levenberg_marquardt(tf, torch.from_numpy(x0), mask=None if mask is None else torch.from_numpy(mask))
    assert res.iterations == int(ref.iterations)
    np.testing.assert_allclose(res.params.numpy(), np.asarray(ref.params), rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=1e-9)
    np.testing.assert_allclose(float(res.lam), float(ref.lam), rtol=1e-12)
    if masked:
        assert res.params[2] == x0[2]


@pytest.mark.parametrize("rvec", [[0.0, 0.0, 0.0], [1e-5, -2e-5, 3e-6], [0.3, -0.2, 0.1]])
def test_rodrigues_jacobian_matches_jax(rvec):
    """torch.func.jacfwd through the port's rodrigues, at the Taylor branch
    (theta^2 < 1e-8, where a parallel rig's stereo rotation sits) and off it."""
    ref = np.asarray(jax.jacfwd(jrot.rodrigues)(jnp.asarray(rvec)))
    mine = torch.func.jacfwd(trot.rodrigues)(torch.tensor(rvec, dtype=torch.float64))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-9, atol=1e-15)


def _check_camera(mine, ref):
    np.testing.assert_array_equal(mine.kept_frames, ref.kept_frames)
    for name in ("K", "dist", "tvecs"):
        np.testing.assert_allclose(getattr(mine, name), getattr(ref, name), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(mine.rvecs, ref.rvecs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mine.per_frame_errors, ref.per_frame_errors, rtol=0, atol=1e-6)
    assert abs(mine.rms - ref.rms) <= 1e-6
    assert mine.image_size == ref.image_size
    for name in ("K", "dist", "rvecs", "tvecs", "per_frame_errors", "kept_frames"):
        assert isinstance(getattr(mine, name), np.ndarray)
    assert isinstance(mine.rms, float)


CAMERA_CASES = {
    # The outlier rounds on, one frame's corners corrupted by 3 px.
    "outlier_rounds": (dict(), True, True),
    "no_rounds": (dict(), False, False),
    "fix_aspect_and_principal_point": (dict(fix_aspect_ratio=True, fix_principal_point=True), False, False),
    # k4..k6 unfixed, but frozen all the same without the rational model.
    "no_rational_model": (dict(rational_model=False, fix_k4=False, fix_k5=False, fix_k6=False), True, False),
}


@pytest.mark.parametrize("case", list(CAMERA_CASES))
def test_calibrate_camera_matches_jax(case):
    flag_kw, rounds, corrupt = CAMERA_CASES[case]
    obj, corners = render_views(12, seed=7)
    if corrupt:
        corners = corners.copy()
        corners[4] += np.random.default_rng(9).normal(0, 3.0, corners[4].shape)
    ref = jint.calibrate_camera(obj, corners, SIZE, jint.CalibrationFlags(**flag_kw), reject_outlier_frames=rounds)
    mine = calib.calibrate_camera(obj, corners, SIZE, calib.CalibrationFlags(**flag_kw),
                                  reject_outlier_frames=rounds, device="cpu")
    _check_camera(mine, ref)
    if corrupt:
        assert 4 not in mine.kept_frames and len(mine.kept_frames) == 11
    if flag_kw.get("fix_aspect_ratio"):
        assert mine.K[0, 0] == mine.K[1, 1]
    if flag_kw.get("fix_principal_point"):
        assert (mine.K[0, 2], mine.K[1, 2]) == (ref.K[0, 2], ref.K[1, 2])  # held at the Zhang estimate
    else:
        np.testing.assert_allclose(mine.K, K_TRUE, rtol=0.01)


def _check_stereo(mine, ref):
    np.testing.assert_allclose(mine.T, ref.T, rtol=1e-5)
    np.testing.assert_allclose(mine.R, ref.R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mine.E, ref.E, rtol=1e-5)
    np.testing.assert_allclose(mine.F, ref.F, rtol=1e-5)
    np.testing.assert_allclose(mine.per_frame_errors, ref.per_frame_errors, rtol=0, atol=1e-6)
    assert abs(mine.rms - ref.rms) <= 1e-6
    assert abs(mine.baseline - ref.baseline) <= 1e-5 * ref.baseline
    assert isinstance(mine.rms, float) and isinstance(mine.baseline, float)


def test_calibrate_stereo_matches_jax():
    obj, c1, c2 = render_views(10, seed=11, stereo=True)
    args = (obj, c1, c2, K_TRUE, DIST_TRUE, K_TRUE, DIST_TRUE, SIZE)
    ref = jext.calibrate_stereo(*args)
    mine = calib.calibrate_stereo(*args, device="cpu")
    _check_stereo(mine, ref)
    assert abs(mine.baseline - np.linalg.norm(T_RIG)) < 0.01 * np.linalg.norm(T_RIG)


def test_filter_pairs_by_rms_matches_jax():
    """Two pairs of eight corrupted on camera 2: both drop the same pairs."""
    obj, c1, c2 = render_views(8, seed=12, stereo=True)
    c2 = c2.copy()
    c2[[2, 5]] += np.random.default_rng(3).normal(0, 6.0, c2[[2, 5]].shape)
    args = (obj, c1, c2, K_TRUE, DIST_TRUE, K_TRUE, DIST_TRUE, SIZE)
    ref = jpairs.filter_pairs_by_rms(*args, max_rms=1.0)
    mine = pairs.filter_pairs_by_rms(*args, max_rms=1.0, device="cpu")
    np.testing.assert_array_equal(mine[0], ref[0])
    assert 2 not in mine[0] and 5 not in mine[0]
    np.testing.assert_array_equal(mine[1], ref[1])
    np.testing.assert_array_equal(mine[2], ref[2])


def test_select_diverse_frames_matches_jax():
    _, corners = render_views(30, seed=5)
    ref_feats = np.asarray(jsel.frame_diversity_features(jnp.asarray(corners), SIZE))
    feats = calib.frame_diversity_features(torch.from_numpy(corners), SIZE)
    assert feats.dtype == torch.float64
    np.testing.assert_allclose(feats.numpy(), ref_feats, rtol=0, atol=1e-9)
    for max_frames, min_distance in ((25, 0.15), (8, 0.05), (30, 0.4)):
        np.testing.assert_array_equal(
            calib.select_diverse_frames(corners, SIZE, max_frames, min_distance, device="cpu"),
            jsel.select_diverse_frames(corners, SIZE, max_frames, min_distance))


@pytest.mark.parametrize("flip_v", [False, True])
@pytest.mark.parametrize("flip_h", [False, True])
def test_canonical_corner_order_matches_jax(flip_v, flip_h):
    obj = calib.checkerboard_object_points(9, 6, 100.0, device="cpu")
    np.testing.assert_array_equal(obj.numpy(), np.asarray(jtargets.checkerboard_object_points(9, 6, 100.0)))
    assert obj.dtype == torch.float32
    _, corners = render_views(1, seed=2)
    g = corners[0].reshape(6, 9, 2)
    if flip_v:
        g = g[::-1]
    if flip_h:
        g = g[:, ::-1]
    detected = np.ascontiguousarray(g.reshape(-1, 2))
    ref = np.asarray(jtargets.canonical_corner_order(jnp.asarray(detected), 9, 6))
    mine = calib.canonical_corner_order(torch.from_numpy(detected), 9, 6)
    np.testing.assert_array_equal(mine.numpy(), ref)
    np.testing.assert_array_equal(mine.numpy(), corners[0])


@pytest.mark.parametrize("rms,n", [(0.3, 12), (0.7, 12), (1.2, 12), (0.3, 9), (0.5, 10), (1.0, 10)])
def test_gates_match_jax(rms, n):
    assert gates.check_intrinsic_quality(rms, n).name == jgates.check_intrinsic_quality(rms, n).name
    for pct in (None, 2.0, 7.5):
        assert (gates.check_stereo_quality(rms, n - 5, pct).name
                == jgates.check_stereo_quality(rms, n - 5, pct).name)
    strict = dict(fail_px=0.6, warn_px=0.25, min_frames=11, min_pairs=6)
    assert (gates.check_intrinsic_quality(rms, n, gates.QualityGates(**strict)).name
            == jgates.check_intrinsic_quality(rms, n, jgates.QualityGates(**strict)).name)


def test_calibration_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj, corners = render_views(3, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        calib.calibrate_camera(obj, corners, SIZE)
    with pytest.raises(RuntimeError, match="CUDA"):
        calib.calibrate_stereo(obj, corners, corners, K_TRUE, DIST_TRUE, K_TRUE, DIST_TRUE, SIZE)
    with pytest.raises(RuntimeError, match="CUDA"):
        calib.checkerboard_object_points(9, 6, 100.0)
