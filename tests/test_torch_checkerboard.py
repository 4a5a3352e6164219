"""The port's checkerboard detector (``detect/checkerboard.py``) against the
JAX package's, on the CPU.

The images are the port's degraded boards (``synth.boards.degraded_board``,
OpenCV-free; ``tests/test_torch_boards.py`` holds them to the JAX
package's OpenCV renders), handed to both detectors; JAX is called with
``backend="jax"``, since "auto" would take OpenCV's path here. Tolerances: the saddle response within 1e-5 of
its largest value, Harris within 1e-3 (float32 running sums); the local maxima (on JAX's own
response) in the same order with the same scores, bit for bit;
``_order_grid`` bit for bit; refined corners within 1e-2 px; the detector's
``ok`` flags equal and its corners within 1e-2 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.detect import checkerboard as jcb
from stereo_vision_tpu.synth import boards as jboards
from stereo_vision_tpu_torch.detect import checkerboard as cb
from stereo_vision_tpu_torch.synth import boards
from stereo_vision_tpu_torch.synth.boards import (DEGRADATIONS, add_noise, board_views, degraded_board, motion_blur,
                                                  render_board_view)

BOARD = (7, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,seed", [("clean", 0), ("blur_heavy", 1), ("glare", 2), ("foreshorten", 3)])
def test_responses_match_jax(kind, seed):
    """The saddle response within 1e-5 of its largest value (it comes out
    equal here); Harris within 1e-3 of its largest value: its box sums are
    differences of float32 running sums over the whole frame, which XLA
    and PyTorch add in other orders (measured up to 3.9e-4)."""
    img, _ = degraded_board(kind, seed)
    t = torch.from_numpy(img)
    ref = np.asarray(jcb.checkerboard_response(jnp.asarray(img)))
    np.testing.assert_allclose(cb.checkerboard_response(t).numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    for port, ref in ((cb.harris_response(t), jcb.harris_response(jnp.asarray(img))),
                      (cb.harris_response(t, block_size=3, k=0.06),
                       jcb.harris_response(jnp.asarray(img), block_size=3, k=0.06))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-3 * np.abs(ref).max())


@pytest.mark.parametrize("kind,seed", [("clean", 4), ("noise", 5), ("combined", 6)])
def test_local_maxima_order_matches_top_k(kind, seed):
    """On the same response: the candidates in lax.top_k's order (the lower
    flat index first among equal scores), with JAX's scores."""
    img, _ = degraded_board(kind, seed)
    resp = np.asarray(jcb.checkerboard_response(jnp.asarray(img)))
    for radius, k in ((4, 112), (2, 300)):
        cand, sc = cb._local_maxima(torch.from_numpy(resp.copy()), radius, k)
        jcand, jsc = jcb._local_maxima(jnp.asarray(resp), radius, k)
        n = int((np.asarray(jsc) > 0).sum())
        np.testing.assert_array_equal(cand.numpy()[:n], np.asarray(jcand)[:n])
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_local_maxima_ties():
    """Plateaus of equal scores: the order is by flat index, as lax.top_k."""
    resp = np.zeros((20, 24), np.float32)
    resp[2, 3] = resp[10, 15] = resp[10, 4] = resp[17, 20] = 5.0
    resp[5, 12] = 7.0
    cand, sc = cb._local_maxima(torch.from_numpy(resp), 2, 8)
    jcand, jsc = jcb._local_maxima(jnp.asarray(resp), 2, 8)
    np.testing.assert_array_equal(cand.numpy()[:5], np.asarray(jcand)[:5])
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("win", [5, 9, 11])
def test_refine_corners_subpix_matches_jax(win):
    img, gt = degraded_board("clean" if win == 5 else "blur", 7)
    start = np.round(gt + np.random.default_rng(win).uniform(-1.5, 1.5, gt.shape)).astype(np.float32)
    out = cb.refine_corners_subpix(torch.from_numpy(img), torch.from_numpy(start), win=win).numpy()
    ref = np.asarray(jcb.refine_corners_subpix(jnp.asarray(img), jnp.asarray(start), win=win))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)


def test_order_grid_bit_exact():
    """Shuffled, rotated and perspective grids with spurious extra points,
    and sets that cannot be ordered."""
    rng = np.random.default_rng(8)
    cols, rows = BOARD
    lattice = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2).astype(np.float64) * 40.0
    for trial in range(12):
        a = rng.uniform(-np.pi, np.pi)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        pts = lattice @ R.T + rng.uniform(100, 300, 2)
        if trial % 3 == 1:  # perspective
            H = np.array([[1.0, 0.1, 0], [0.05, 1.0, 0], [4e-4, -3e-4, 1.0]])
            ph = np.c_[pts, np.ones(len(pts))] @ H.T
            pts = ph[:, :2] / ph[:, 2:]
        pts = pts + rng.normal(0, 0.3, pts.shape)
        if trial % 3 == 2:  # spurious candidates inside the board
            pts = np.r_[pts, pts[rng.choice(len(pts), 4)] + rng.uniform(10, 18, (4, 2))]
        pts = pts[rng.permutation(len(pts))]
        if trial == 11:
            pts = pts[: cols * rows - 1]
        out, ref = cb._order_grid(pts, cols, rows), jcb._order_grid(pts, cols, rows)
        assert (out is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kind,seed", [("clean", 7), ("blur_heavy", 8), ("combined", 9)])
def test_edge_width_means_match_reference(kind, seed):
    """The blur measure's two means, summed on the image's device, within
    rtol 1e-6 of the JAX package's numpy means (a float64 sum of the same
    float32 terms against numpy's float32 pairwise sum, which is off by up
    to 2 ulp here), and the sub-pixel window it picks is the same."""
    img, _ = degraded_board(kind, seed)
    f32 = img.astype(np.float32) / 255.0
    lap = np.abs(4.0 * f32[1:-1, 1:-1] - f32[:-2, 1:-1] - f32[2:, 1:-1] - f32[1:-1, :-2] - f32[1:-1, 2:]).mean()
    dx = np.abs(np.diff(f32, axis=1)).mean()
    port = cb._edge_width_means(torch.from_numpy(img)).numpy()
    assert port.dtype == np.float32
    np.testing.assert_allclose(port, np.array([dx, lap], np.float32), rtol=1e-6, atol=0)

    def window(d, l):
        proxy = float(d / max(l, 1e-9))
        return max(5, min(11, round(2 + 4 * proxy))) if proxy > 0.8 else 5

    assert window(*port) == window(dx, lap)


@pytest.mark.parametrize("kind", DEGRADATIONS)
def test_find_chessboard_corners_matches_jax(kind):
    """Every degradation class at two seeds: the same ok flag, corners
    within 1e-2 px."""
    for seed in (0, 11):
        img, _ = degraded_board(kind, seed)
        ok, c = cb.find_chessboard_corners(img, BOARD, device="cpu")
        jok, jc = jcb.find_chessboard_corners(img, BOARD, backend="jax")
        assert ok == jok, (kind, seed)
        if ok:
            assert c.shape == (BOARD[0] * BOARD[1], 2) and c.dtype == np.float32
            np.testing.assert_allclose(c, np.asarray(jc), rtol=0, atol=1e-2)


def test_find_chessboard_corners_failures_match_jax():
    """A blank frame, a board too small to hold the grid asked for, and a
    tensor input (it runs where it lies)."""
    blank = np.full((120, 160), 128, np.uint8)
    assert cb.find_chessboard_corners(blank, BOARD, device="cpu") == (False, None)
    assert jcb.find_chessboard_corners(blank, BOARD, backend="jax") == (False, None)
    img, _ = degraded_board("clean", 3)
    ok, _ = cb.find_chessboard_corners(img, (9, 6), device="cpu")
    assert not ok and not jcb.find_chessboard_corners(img, (9, 6), backend="jax")[0]
    ok, c = cb.find_chessboard_corners(torch.from_numpy(img), BOARD)
    jok, jc = jcb.find_chessboard_corners(img, BOARD, backend="jax")
    assert ok and jok
    np.testing.assert_allclose(c, np.asarray(jc), rtol=0, atol=1e-2)


def test_backends():
    """"torch" is "auto"; the reference's "cv2" (host OpenCV) is refused."""
    img, _ = degraded_board("noise", 4)
    a, b = cb.find_chessboard_corners(img, BOARD, "auto", device="cpu"), cb.find_chessboard_corners(
        img, BOARD, "torch", device="cpu")
    assert a[0] and b[0]
    np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="OpenCV"):
        cb.find_chessboard_corners(img, BOARD, "cv2", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        cb.find_chessboard_corners(img, BOARD, "jax", device="cpu")


def test_rendered_views_detected_near_truth():
    """The port's own board render (it serves the card, which has no
    OpenCV) at 480x270, f = 375 px: the detector finds every clean view
    within 0.5 px of the truth, also with noise and motion blur."""
    W, H = 480, 270
    K = np.array([[375.0, 0, (W - 1) / 2], [0, 375.0, (H - 1) / 2], [0, 0, 1]])
    obj, corners, (rvecs, tvecs) = board_views(3, 1, K, np.zeros(5), (W, H), cols=7, rows=4, noise=0.0,
                                              margin=40.0, depth=(1800.0, 2600.0), return_poses=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        img, truth = render_board_view(K, rvecs[i], tvecs[i], (W, H), cols=7, rows=4, device="cpu")
        np.testing.assert_allclose(truth, corners[i], rtol=0, atol=1e-9)
        for view in (img, add_noise(img, 6.0, rng), motion_blur(img, 5, 30.0)):
            ok, c = cb.find_chessboard_corners(view, BOARD, device="cpu")
            assert ok and np.abs(c - truth).max() < 0.5


def test_board_degradations_equal_jax():
    """The port's numpy copies of the JAX package's board render and its
    OpenCV-free degradations: equal images from the same seed."""
    img, gt = boards.render_board(7, 4, square_px=30, margin=25)
    jimg, jgt = jboards.render_board(7, 4, square_px=30, margin=25)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(gt, jgt)
    for fn, jfn in ((lambda i, r: boards.add_noise(i, 14.0, r), lambda i, r: jboards.add_noise(i, 14.0, r)),
                    (boards.add_glare, jboards.add_glare), (lambda i, r: boards.low_contrast(i),
                                                            lambda i, r: jboards.low_contrast(i))):
        np.testing.assert_array_equal(fn(img, np.random.default_rng(3)), jfn(jimg, np.random.default_rng(3)))
