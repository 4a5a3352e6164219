"""The port's OpenCV-free board degradations (``synth/boards.py``:
``warp_perspective``, ``rotate``, ``occlude``, ``degraded_board``) against
the JAX package's OpenCV forms of the same seed, on the CPU.

The truth points equal the reference's bit for bit: the port solves
``cv2.getPerspectiveTransform``'s 8x8 system and builds
``cv2.getRotationMatrix2D``'s matrix as OpenCV does, to the bit, and maps
the points with the same numpy products. The pixels are held by their mean
absolute difference (levels of 255): the warps under 0.06 (0.022-0.041
measured: the port samples bilinearly in float64 on OpenCV's 1/32 px grid,
OpenCV in 15-bit fixed point), the occluding disk under 0.1 (0.057-0.062
in the boards, 0-0.079 alone: its anti-aliased rim drawn another way), the motion blurs under 0.6
(0.05-0.46: the port's motion blur, held in ``tests/test_torch_renders.py``).
"""

import cv2
import numpy as np
import pytest

from stereo_vision_tpu.synth import boards as jboards
from stereo_vision_tpu_torch.synth import boards

MAD = {"occlusion": 0.1, "blur": 0.6, "blur_heavy": 0.6, "combined": 0.6}


@pytest.mark.parametrize("kind", boards.DEGRADATIONS)
def test_degraded_board_matches_jax(kind):
    for seed in (0, 1):
        img, gt = boards.degraded_board(kind, seed)
        jimg, jgt = jboards.degraded_board(kind, seed)
        assert img.dtype == np.uint8 and img.shape == jimg.shape
        np.testing.assert_array_equal(gt, jgt)
        assert np.abs(img.astype(np.int16) - jimg).mean() < MAD.get(kind, 0.06), (kind, seed)
    with pytest.raises(ValueError, match="unknown degradation"):
        boards.degraded_board("fog", 0)


def test_transforms_equal_opencv_bit_for_bit():
    """The homography and the rotation matrix on random quads and angles."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        w, h = rng.integers(50, 2000, 2)
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]]) + rng.normal(0, 3, (4, 2)).astype(np.float32)
        dst = src * np.float32(rng.uniform(0.7, 1.2)) + rng.normal(0, 0.1 * w, (4, 2)).astype(np.float32)
        np.testing.assert_array_equal(boards.perspective_transform(src, dst), cv2.getPerspectiveTransform(src, dst))
        angle = rng.uniform(-180, 180)
        np.testing.assert_array_equal(boards.rotation_matrix_2d((w / 2, h / 2), angle),
                                      cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0))


def test_warps_and_disk_near_opencv():
    """``rotate`` and ``warp_perspective`` against the JAX package's cv2
    forms on one board, and ``fill_disk`` against ``cv2.circle(LINE_AA)``
    on a flat and a board background."""
    img, gt = boards.render_board(7, 4, square_px=30, margin=50)
    for angle in (-24.0, 3.5, 17.0):
        (out, pts), (jout, jpts) = boards.rotate(img, gt, angle), jboards.rotate(img, gt, angle)
        np.testing.assert_array_equal(pts, jpts)
        assert np.abs(out.astype(np.int16) - jout).mean() < 0.06
    for tilt in (0.1, 0.32):
        (out, pts), (jout, jpts) = (f(img, gt, tilt, np.random.default_rng(2)) for f in (boards.warp_perspective,
                                                                                         jboards.warp_perspective))
        np.testing.assert_array_equal(pts, jpts)
        assert np.abs(out.astype(np.int16) - jout).mean() < 0.06
    for base in (np.full((200, 240), 255, np.uint8), img[:200, :240].copy()):
        for (cx, cy), r in (((120, 100), 40), ((5, 190), 30), ((300, 50), 10)):
            ref = base.copy()
            cv2.circle(ref, (cx, cy), r, 128, -1, cv2.LINE_AA)
            out = boards.fill_disk(base.copy(), (cx, cy), r, 128)
            assert np.abs(out.astype(np.int16) - ref).mean() < 0.1


def test_boards_exports_every_jax_name():
    names = {n for n in dir(jboards) if not n.startswith("_") and n not in ("annotations", "np")}
    assert names <= set(dir(boards)), names - set(dir(boards))
