"""The port's geometry ops against the JAX package's ``ops/`` modules.

float64 inputs made with numpy on both sides (the JAX side runs under
``jax_enable_x64``, set in ``tests/conftest.py``), on the CPU. The two
evaluate the same closed-form expressions, in another order in places
(summed products instead of matmuls, LAPACK vs PyTorch's solve), so the
tolerance is rtol 1e-9 with an atol of a few float64 ulps of the values'
scale; the rectification maps are float32, held within 1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.ops import distortion as jd
from stereo_vision_tpu.ops import rectify as jrect
from stereo_vision_tpu.ops import rotation as jrot
from stereo_vision_tpu.ops import triangulate as jtri
from stereo_vision_tpu_torch import ops
from stereo_vision_tpu_torch.ops import distortion as td
from stereo_vision_tpu_torch.ops import rotation as trot

# The distorted 1920x1080 rig of tests/test_rectify_remap.py.
K1 = np.array([[1400.0, 0, 960], [0, 1410.0, 540], [0, 0, 1]])
K2 = np.array([[1390.0, 0, 955], [0, 1402.0, 545], [0, 0, 1]])
D1 = np.array([-0.28, 0.09, 1.2e-3, -8e-4, -0.012])
D2 = np.array([-0.25, 0.07, -9e-4, 6e-4, -0.010])
SIZE = (1920, 1080)
RVEC_RIG, T_RIG = np.array([0.02, -0.35, 0.015]), np.array([-3500.0, 25.0, 120.0])
# The 4-, 5- and 8-coefficient vectors (tests/test_geometry.py's DIST5 and DIST8 kinds).
DISTS = {"4": D1[:4], "5": D1, "8": np.array([-0.12, 0.03, 1e-3, -2e-3, 0.002, 0.05, -0.01, 0.004])}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(mine, ref, atol=1e-12):
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    assert mine.dtype == np.float64
    np.testing.assert_allclose(mine, np.asarray(ref), rtol=1e-9, atol=atol)


@pytest.mark.parametrize("rvec", [[0.1, -0.2, 0.3], [2e-5, -1e-5, 3e-5], [0.0, 0.0, 0.0], [0.0, 3.1, 0.2],
                                  [np.pi - 1e-7, 0.0, 0.0], [1.2, 2.0, -1.5]])
def test_rodrigues_both_ways_match_jax(rvec):
    """Generic, small-angle (Taylor) and near-pi rotations; the inverse of
    each, and the Euler report."""
    R = np.asarray(jrot.rodrigues(jnp.asarray(rvec)))
    _close(trot.rodrigues(_t(rvec)), R, atol=1e-15)
    _close(trot.rodrigues_inv(_t(R)), jrot.rodrigues_inv(jnp.asarray(R)))
    _close(trot.euler_angles_from_matrix(_t(R)), jrot.euler_angles_from_matrix(jnp.asarray(R)))


@pytest.mark.parametrize("R", [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.eye(3),
                               np.array([[0.0, 1, 0], [1, 0, 0], [0, 0, -1]])])
def test_rodrigues_inv_pi_and_identity_match_jax(R):
    """Rotations by exactly pi (the diagonal branch and its sign choice) and
    the identity."""
    _close(trot.rodrigues_inv(_t(R)), jrot.rodrigues_inv(jnp.asarray(R)))
    _close(trot.euler_angles_from_matrix(_t(R)), jrot.euler_angles_from_matrix(jnp.asarray(R)))


@pytest.mark.parametrize("kind", list(DISTS))
def test_distortion_and_projection_match_jax(kind):
    dist = DISTS[kind]
    rng = np.random.default_rng(len(kind))
    xy = rng.uniform(-0.6, 0.6, (40, 2))
    _close(td.distort_normalized(_t(xy), _t(dist)), jd.distort_normalized(jnp.asarray(xy), jnp.asarray(dist)))
    _close(td.undistort_normalized(_t(xy), _t(dist)), jd.undistort_normalized(jnp.asarray(xy), jnp.asarray(dist)))
    obj = rng.uniform([-500, -400, 1500], [500, 400, 4000], (3, 20, 3))
    rvec, tvec = np.array([0.1, -0.05, 0.02]), np.array([10.0, 20.0, 30.0])
    _close(ops.project_points(_t(obj), _t(rvec), _t(tvec), _t(K1), _t(dist)),
           jd.project_points(jnp.asarray(obj), rvec, tvec, jnp.asarray(K1), jnp.asarray(dist)), atol=1e-9)
    pts = rng.uniform(0, SIZE, (60, 2))
    _close(ops.undistort_points(_t(pts), _t(K1), _t(dist)), jd.undistort_points(pts, K1, dist))
    Rr = np.asarray(jrot.rodrigues(jnp.asarray([0.01, -0.02, 0.005])))
    P = np.array([[1300.0, 0, 940, 0], [0, 1300.0, 530, 0], [0, 0, 1, 0]])
    _close(ops.undistort_points(_t(pts), _t(K1), _t(dist), R=_t(Rr), P=_t(P)),
           jd.undistort_points(pts, K1, dist, R=Rr, P=P), atol=1e-9)


@pytest.mark.parametrize("alpha,zero_disparity", [(-1.0, True), (0.0, True), (0.5, True), (1.0, True),
                                                  (0.0, False)])
def test_stereo_rectify_and_maps_match_jax(alpha, zero_disparity):
    R = np.asarray(jrot.rodrigues(jnp.asarray(RVEC_RIG)))
    ref = jrect.stereo_rectify(K1, D1, K2, D2, SIZE, R, T_RIG, alpha=alpha, zero_disparity=zero_disparity)
    mine = ops.stereo_rectify(_t(K1), _t(D1), _t(K2), _t(D2), SIZE, _t(R), _t(T_RIG), alpha=alpha,
                              zero_disparity=zero_disparity)
    assert isinstance(mine, ops.RectifyResult)
    for name, a, b in zip(ref._fields, mine, ref):
        assert a.shape == np.asarray(b).shape, name
        _close(a, b, atol=1e-9)
    if alpha in (-1.0, 1.0):
        return  # the maps of the crop case below cover the map function
    for K, D, Rk, Pk in ((K1, D1, mine.R1, mine.P1), (K2, D2, mine.R2, mine.P2)):
        mx, my = ops.init_undistort_rectify_map(_t(K), _t(D), Rk, Pk, SIZE)
        rx, ry = jrect.init_undistort_rectify_map(K, D, jnp.asarray(Rk.numpy()), jnp.asarray(Pk.numpy()), SIZE)
        assert mx.dtype == torch.float32 and mx.shape == (SIZE[1], SIZE[0])
        np.testing.assert_allclose(mx.numpy(), np.asarray(rx), rtol=0, atol=1e-3)
        np.testing.assert_allclose(my.numpy(), np.asarray(ry), rtol=0, atol=1e-3)


def test_parallel_rig_rectifies_to_the_identity():
    """An undistorted parallel rig (K1 = K2, R = I, T along x): the
    rectification is the identity up to rounding, so its float32 maps are
    the pixel grid and Q the rig's; the maps without R take the identity."""
    K = np.array([[1000.0, 0, 639.5], [0, 1000.0, 359.5], [0, 0, 1]])
    res = ops.stereo_rectify(_t(K), _t(np.zeros(5)), _t(K), _t(np.zeros(5)), (1280, 720), _t(np.eye(3)),
                             _t([-100.0, 0, 0]))
    ref = jrect.stereo_rectify(K, np.zeros(5), K, np.zeros(5), (1280, 720), np.eye(3), np.array([-100.0, 0, 0]))
    for a, b in zip(res, ref):
        _close(a, b, atol=1e-9)
    mx, my = ops.init_undistort_rectify_map(_t(K), _t(np.zeros(5)), res.R1, res.P1, (1280, 720))
    yy, xx = np.mgrid[0:720, 0:1280].astype(np.float32)
    np.testing.assert_array_equal(mx.numpy(), xx)
    np.testing.assert_array_equal(my.numpy(), yy)
    mx0, _ = ops.init_undistort_rectify_map(_t(K), _t(np.zeros(4)), None, _t(K), (1280, 720))
    np.testing.assert_array_equal(mx0.numpy(), xx)
    np.testing.assert_allclose(res.Q.numpy()[3, 2], 0.01, rtol=1e-12)


def test_triangulation_matches_jax():
    R = np.asarray(jrot.rodrigues(jnp.asarray(RVEC_RIG)))
    rect = jrect.stereo_rectify(K1, D1, K2, D2, SIZE, R, T_RIG, alpha=0.0)
    P1, P2 = np.asarray(rect.P1), np.asarray(rect.P2)
    rng = np.random.default_rng(7)
    X = rng.uniform([-800, -500, 1800], [800, 500, 4000], (4, 25, 3))
    p1 = np.asarray(jtri.project_homogeneous(P1, X)) + rng.normal(0, 0.3, (4, 25, 2))
    p2 = np.asarray(jtri.project_homogeneous(P2, X)) + rng.normal(0, 0.3, (4, 25, 2))
    _close(ops.project_homogeneous(_t(P1), _t(X)), jtri.project_homogeneous(P1, X), atol=1e-9)
    Xm = ops.triangulate_points(_t(P1), _t(P2), _t(p1), _t(p2))
    Xj = jtri.triangulate_points(P1, P2, p1, p2)
    assert Xm.shape == (4, 25, 3)
    _close(Xm, Xj, atol=1e-9)
    _close(ops.reprojection_error(_t(P1), _t(P2), Xm, _t(p1), _t(p2)),
           jtri.reprojection_error(P1, P2, Xj, p1, p2), atol=1e-9)
    xy1, xy2 = rng.uniform(-0.3, 0.3, (30, 2)), rng.uniform(-0.3, 0.3, (30, 2))
    _close(ops.triangulate_normalized(_t(R), _t(T_RIG), _t(xy1), _t(xy2)),
           jtri.triangulate_normalized(R, T_RIG, xy1, xy2), atol=1e-9)


def test_geometry_inputs_follow_their_device(monkeypatch):
    """Tensors stay where they are; other inputs go to the CUDA card by
    default (raising without one) or to the device asked for."""
    assert ops.rodrigues(np.zeros(3), device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.rodrigues(np.zeros(3))
    assert ops.rodrigues(torch.zeros(3, dtype=torch.float64)).dtype == torch.float64
