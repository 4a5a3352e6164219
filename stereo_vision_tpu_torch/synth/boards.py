"""Synthetic checkerboards: detections for the calibration checks, and
images for the corner detector.

- :func:`board_views`: a board of ``cols x rows`` inner corners seen from
  random poses by one camera or by both cameras of a rig, projected with
  the port's ``ops.project_points`` in float64 on the CPU, with Gaussian
  pixel noise;
- :func:`render_board_view`: the image of such a view (a pinhole camera
  without distortion), anti-aliased by supersampling, with its true
  corners;
- numpy copies of the JAX package's ``synth/boards.py`` ``render_board``,
  ``add_noise``, ``add_glare`` and ``low_contrast``, and the rest of it
  without OpenCV: ``motion_blur``, ``warp_perspective``, ``rotate``,
  ``occlude`` and ``degraded_board`` over ``DEGRADATIONS``. The transforms
  are OpenCV's to the bit (``getPerspectiveTransform``'s LU solve,
  ``getRotationMatrix2D``), so the truth points equal the reference's; the
  warps (an inverse-mapped bilinear sample on OpenCV's 1/32 px grid, border
  255), the blur and the anti-aliased disk make other pixels than OpenCV's,
  within the mean absolute differences ``tests/test_torch_boards.py`` holds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops import project_points, rodrigues, rodrigues_inv

# render_board_view's gray levels and its samples a pixel along each axis.
_BLACK, _WHITE, _BACKGROUND = 20.0, 235.0, 120.0
_SUPERSAMPLE = 4
_DISK_RIM = 0.7  # fill_disk's growth of the radius (OpenCV's anti-aliased rim)


def board_views(n_frames: int, seed: int, K1, dist1, size: tuple[int, int], K2=None, dist2=None, R=None, T=None,
                cols: int = 9, rows: int = 6, square: float = 100.0, depth: tuple[float, float] = (1500.0, 3500.0),
                noise: float = 0.1, margin: float = 20.0, return_poses: bool = False):
    """(obj (N, 3), corners1 (F, N, 2)[, corners2 (F, N, 2)]) numpy float64:
    the board's points (row-major, x fastest, z = 0, ``square`` apart) and
    their pixels in camera 1 (``K1``, ``dist1``) and, with ``K2``, in camera
    2 at ``X2 = R X1 + T``. Poses are drawn from ``seed`` (rotation vectors
    within +-0.5 rad, the board's origin ``depth`` away) until ``n_frames``
    of them show the whole board ``margin`` px inside every camera's
    ``size`` = (width, height). With ``return_poses``, each camera's
    (rvecs (F, 3), tvecs (F, 3)) follow, the board in that camera's frame."""
    rng = np.random.default_rng(seed)
    obj = np.zeros((rows * cols, 3))
    obj[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * square
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    cams = [(t64(K1), t64(dist1), torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))]
    if K2 is not None:
        cams.append((t64(K2), t64(dist2), t64(R), t64(T)))
    views: list[list[np.ndarray]] = [[] for _ in cams]
    poses: list[list[tuple[np.ndarray, np.ndarray]]] = [[] for _ in cams]
    while len(views[0]) < n_frames:
        rvec = t64(rng.uniform(-0.5, 0.5, 3))
        z = rng.uniform(*depth)
        tvec = t64([rng.uniform(-0.45, 0.15) * z, rng.uniform(-0.35, 0.1) * z, z])
        pts, pose = [], []
        for K, dist, Rc, Tc in cams:
            rv = rodrigues_inv(Rc @ rodrigues(rvec))
            tv = Rc @ tvec + Tc
            p = project_points(t64(obj), rv, tv, K, dist).numpy()
            pts.append(p)
            pose.append((rv.numpy(), tv.numpy()))
        if all((p > margin).all() and (p[:, 0] < size[0] - margin).all() and (p[:, 1] < size[1] - margin).all()
               for p in pts):
            for v, p in zip(views, pts):
                v.append(p + rng.normal(0, noise, p.shape))
            for c, ps in zip(poses, pose):
                c.append(ps)
    out = (obj, *(np.stack(v) for v in views))
    if return_poses:
        out += tuple((np.stack([r for r, _ in c]), np.stack([t for _, t in c])) for c in poses)
    return out


def render_board_view(K, rvec, tvec, size: tuple[int, int], cols: int = 9, rows: int = 6, square: float = 100.0,
                      device=None) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 (H, W) image, (N, 2) float64 true inner corners) of a board
    at pose (``rvec``, ``tvec``) in a camera ``K`` without distortion.

    The board is (cols + 1) x (rows + 1) squares ``square`` apart, black
    20 and white 235, with a white border half a square wide, its first
    inner corner at the origin of the board's plane (as :func:`board_views`'
    points); the rest of the frame is 120. Each pixel is the mean of 4 x 4
    samples of the board's plane seen through the inverse homography
    (float64 on ``device``; None: the CUDA card), pixel centres at integer
    coordinates as ``ops.project_points``'."""
    dev = resolve_device(device)
    W, H = size
    K = torch.as_tensor(np.asarray(K, np.float64), device=dev)
    R = rodrigues(torch.as_tensor(np.asarray(rvec, np.float64), device=dev))
    t = torch.as_tensor(np.asarray(tvec, np.float64), device=dev)
    Hm = K @ torch.stack([R[:, 0], R[:, 1], t], dim=1)  # board (X, Y, 1) -> pixel
    Hinv = torch.linalg.inv(Hm)
    s = _SUPERSAMPLE
    sub = (torch.arange(s, dtype=torch.float64, device=dev) + 0.5) / s - 0.5
    ys = (torch.arange(H, dtype=torch.float64, device=dev)[:, None] + sub[None, :]).reshape(-1)
    xs = (torch.arange(W, dtype=torch.float64, device=dev)[:, None] + sub[None, :]).reshape(-1)
    y, x = ys[:, None], xs[None, :]
    den = Hinv[2, 0] * x + Hinv[2, 1] * y + Hinv[2, 2]
    bx = (Hinv[0, 0] * x + Hinv[0, 1] * y + Hinv[0, 2]) / den
    by = (Hinv[1, 0] * x + Hinv[1, 1] * y + Hinv[1, 2]) / den
    ix, iy = torch.floor(bx / square), torch.floor(by / square)
    checker = (ix >= -1) & (ix <= cols - 1) & (iy >= -1) & (iy <= rows - 1)
    border = (bx >= -1.5 * square) & (bx <= (cols + 0.5) * square) & (by >= -1.5 * square) & \
        (by <= (rows + 0.5) * square) & (den > 0)
    dark = torch.remainder(ix + iy, 2) == 0
    val = torch.where(checker & (den > 0), torch.where(dark, _BLACK, _WHITE),
                      torch.where(border, _WHITE, _BACKGROUND))
    img = val.reshape(H, s, W, s).mean(dim=(1, 3))
    obj = np.zeros((rows * cols, 3))
    obj[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * square
    truth = project_points(torch.as_tensor(obj, device=dev), torch.as_tensor(np.asarray(rvec, np.float64), device=dev),
                           t, K, torch.zeros(5, dtype=torch.float64, device=dev))
    return torch.round(img).clamp(0, 255).to(torch.uint8).cpu().numpy(), truth.cpu().numpy()


def render_board(cols: int, rows: int, square_px: int = 40, margin: int = 60, white: int = 255, black: int = 0):
    """Axis-aligned checkerboard: (uint8 image, (N, 2) inner-corner truth
    in pixel-centre coordinates: corners sit on pixel boundaries, k - 0.5)."""
    w = (cols + 1) * square_px + 2 * margin
    h = (rows + 1) * square_px + 2 * margin
    img = np.full((h, w), white, np.uint8)
    for i in range(rows + 1):
        for j in range(cols + 1):
            if (i + j) % 2 == 0:
                y0 = margin + i * square_px
                x0 = margin + j * square_px
                img[y0 : y0 + square_px, x0 : x0 + square_px] = black
    gt = np.array(
        [[margin + (j + 1) * square_px - 0.5, margin + (i + 1) * square_px - 0.5]
         for i in range(rows) for j in range(cols)],
        np.float64,
    )
    return img, gt


def add_noise(img: np.ndarray, sigma: float, rng) -> np.ndarray:
    """Gaussian sensor noise, clipped to uint8."""
    x = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def add_glare(img: np.ndarray, rng, n_spots: int = 2, strength: float = 200.0) -> np.ndarray:
    """Additive specular highlights: broad Gaussian blobs that locally
    saturate the board."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = img.astype(np.float32)
    for _ in range(n_spots):
        cy = rng.uniform(0.2 * h, 0.8 * h)
        cx = rng.uniform(0.2 * w, 0.8 * w)
        s = rng.uniform(0.06, 0.14) * max(h, w)
        out += strength * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return np.clip(out, 0, 255).astype(np.uint8)


def low_contrast(img: np.ndarray, lo: int = 100, hi: int = 165) -> np.ndarray:
    """Intensities squeezed into [lo, hi]."""
    return (lo + (img.astype(np.float32) / 255.0) * (hi - lo)).astype(np.uint8)


def motion_blur(img: np.ndarray, length: int, angle_deg: float) -> np.ndarray:
    """Directional blur of ``length`` pixels at ``angle_deg`` (camera
    shake): the mean along a segment through each pixel, the segment
    sampled finely and its samples split bilinearly between pixels;
    borders reflected (cv2.filter2D's default), rounded to uint8."""
    a = np.deg2rad(angle_deg)
    taps: dict[tuple[int, int], float] = {}
    n = 8 * length
    for u in (np.arange(n) + 0.5) / n * length - length / 2:
        x, y = u * np.cos(a), -u * np.sin(a)
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx), (1, 0, fy * (1 - fx)),
                            (1, 1, fy * fx)):
            taps[(y0 + dy, x0 + dx)] = taps.get((y0 + dy, x0 + dx), 0.0) + wgt / n
    r = length
    src = np.pad(img.astype(np.float32), r, mode="reflect")
    h, w = img.shape
    out = np.zeros((h, w), np.float32)
    for (dy, dx), wgt in taps.items():
        out += np.float32(wgt) * src[r + dy : r + dy + h, r + dx : r + dx + w]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def perspective_transform(src, dst) -> np.ndarray:
    """(3, 3) float64 homography taking the four float32 points ``src`` to
    ``dst``, as ``cv2.getPerspectiveTransform`` computes it: the 8x8 system
    (its products in float32, as OpenCV's Point2f) solved by Gaussian
    elimination with partial pivoting (OpenCV's LU: rows scaled by -1 /
    pivot, back substitution divided by the pivot), bit for bit."""
    src, dst = np.asarray(src, np.float32), np.asarray(dst, np.float32)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i][0] = a[i + 4][3] = float(x)
        a[i][1] = a[i + 4][4] = float(y)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6], a[i][7] = -float(x * u), -float(y * u)
        a[i + 4][6], a[i + 4][7] = -float(x * v), -float(y * v)
        b[i], b[i + 4] = float(u), float(v)
    for i in range(8):
        k = max(range(i, 8), key=lambda j: (abs(a[j][i]), -j))
        a[i], a[k], b[i], b[k] = a[k], a[i], b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, 8):
            alpha = a[j][i] * d
            for c in range(i + 1, 8):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(7, -1, -1):
        s = b[i]
        for c in range(i + 1, 8):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b + [1.0]).reshape(3, 3)


def rotation_matrix_2d(center: tuple[float, float], angle_deg: float, scale: float = 1.0) -> np.ndarray:
    """(2, 3) float64 rotation about ``center`` (float32, as OpenCV's
    Point2f), as ``cv2.getRotationMatrix2D`` computes it, bit for bit."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = angle_deg * (math.pi / 180)
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_inverse(img: np.ndarray, inv: np.ndarray, border: int = 255) -> np.ndarray:
    """uint8 (H, W) image resampled at ``inv`` (3x3: output pixel (x, y, 1)
    -> source) bilinearly, the source position rounded to 1/32 px (OpenCV's
    INTER_LINEAR grid), taps outside the image ``border``; rounded to
    uint8. The same size as ``img``."""
    h, w = img.shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    den = inv[2, 0] * x + inv[2, 1] * y + inv[2, 2]
    den = np.where(den != 0, 1.0 / np.where(den != 0, den, 1.0), 0.0)
    sx = np.rint((inv[0, 0] * x + inv[0, 1] * y + inv[0, 2]) * den * 32) / 32
    sy = np.rint((inv[1, 0] * x + inv[1, 1] * y + inv[1, 2]) * den * 32) / 32
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    pad = np.pad(img.astype(np.float64), 1, constant_values=border)

    def tap(yy, xx):
        yi = np.clip(yy + 1, 0, h + 1).astype(np.int64)
        xi = np.clip(xx + 1, 0, w + 1).astype(np.int64)
        inside = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
        return np.where(inside, pad[yi, xi], float(border))

    out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
           + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def warp_perspective(img: np.ndarray, gt: np.ndarray, tilt: float, rng):
    """Projective foreshortening: ``tilt`` in [0, 1) pulls the top edge
    inward (tilt 0.35 ~ a board at 60 deg+ to the camera axis)."""
    h, w = img.shape
    jx = rng.uniform(-0.05, 0.05)
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = np.float32(
        [
            [w * (tilt + jx), h * 0.08],
            [w * (1 - tilt + jx), h * 0.08],
            [w * 0.98, h * 0.95],
            [w * 0.02, h * 0.95],
        ]
    )
    H = perspective_transform(src, dst)
    out = warp_inverse(img, np.linalg.inv(H))
    gt_h = np.c_[gt, np.ones(len(gt))] @ H.T
    return out, gt_h[:, :2] / gt_h[:, 2:3]


def rotate(img: np.ndarray, gt: np.ndarray, angle_deg: float):
    """The image and its truth points rotated by ``angle_deg`` about the
    image's centre (``cv2.warpAffine`` with border 255)."""
    h, w = img.shape
    M = rotation_matrix_2d((w / 2, h / 2), angle_deg, 1.0)
    out = warp_inverse(img, np.linalg.inv(np.vstack([M, [0.0, 0.0, 1.0]])))
    return out, np.c_[gt, np.ones(len(gt))] @ M.T


def fill_disk(img: np.ndarray, center: tuple[int, int], radius: int, value: int) -> np.ndarray:
    """An anti-aliased filled disk (in place; returns ``img``): each pixel
    blended towards ``value`` by the share of its 4 x 4 samples within
    ``radius`` + 0.7 of ``center`` (OpenCV's LINE_AA disk covers the pixels
    ``radius`` away and a fifth of the next: its measured rim), rounded."""
    h, w = img.shape[:2]
    cx, cy = center
    y0, y1 = max(cy - radius - 1, 0), min(cy + radius + 2, h)
    x0, x1 = max(cx - radius - 1, 0), min(cx + radius + 2, w)
    if y0 >= y1 or x0 >= x1:
        return img
    sub = (np.arange(4) + 0.5) / 4 - 0.5
    ys = (np.arange(y0, y1)[:, None] + sub).reshape(-1)
    xs = (np.arange(x0, x1)[:, None] + sub).reshape(-1)
    inside = (xs[None, :] - cx) ** 2 + (ys[:, None] - cy) ** 2 <= (radius + _DISK_RIM) ** 2
    cover = inside.reshape(y1 - y0, 4, x1 - x0, 4).mean(axis=(1, 3))
    patch = img[y0:y1, x0:x1].astype(np.float64)
    if patch.ndim == 3:
        cover = cover[..., None]
    img[y0:y1, x0:x1] = np.clip(np.rint(patch * (1 - cover) + np.asarray(value, np.float64) * cover), 0, 255)
    return img


def occlude(img: np.ndarray, gt: np.ndarray, rng, frac: float = 0.12) -> np.ndarray:
    """Cover a patch of the board margin / outer squares with a gray disk
    (a hand or cable). Inner corners stay visible, so full detection
    remains possible."""
    h, w = img.shape
    out = img.copy()
    x0, y0 = gt.min(axis=0)
    x1, y1 = gt.max(axis=0)
    # the disk's centre outside the inner-corner hull but touching the board
    side = rng.integers(0, 4)
    r = int(frac * max(h, w))
    safety = r + 12  # keep every inner corner's subpixel window clear
    if side == 0:
        cx, cy = rng.uniform(x0, x1), y0 - safety
    elif side == 1:
        cx, cy = rng.uniform(x0, x1), y1 + safety
    elif side == 2:
        cx, cy = x0 - safety, rng.uniform(y0, y1)
    else:
        cx, cy = x1 + safety, rng.uniform(y0, y1)
    return fill_disk(out, (int(cx), int(cy)), r, 128)


def degraded_board(kind: str, seed: int, cols: int = 7, rows: int = 4):
    """One (image, truth) sample of the named degradation class."""
    rng = np.random.default_rng(seed)
    img, gt = render_board(cols, rows, square_px=40, margin=70)
    angle = rng.uniform(-25, 25)
    img, gt = rotate(img, gt, angle)

    if kind == "clean":
        pass
    elif kind == "noise":
        img = add_noise(img, 18.0, rng)
    elif kind == "blur":
        img = motion_blur(img, 9, rng.uniform(0, 180))
    elif kind == "blur_heavy":
        img = motion_blur(img, 15, rng.uniform(0, 180))
    elif kind == "glare":
        img = add_glare(img, rng)
    elif kind == "occlusion":
        img = occlude(img, gt, rng)
    elif kind == "foreshorten":
        img, gt = warp_perspective(img, gt, 0.32, rng)
    elif kind == "low_contrast_noise":
        img = add_noise(low_contrast(img), 10.0, rng)
    elif kind == "combined":
        img, gt = warp_perspective(img, gt, 0.22, rng)
        img = motion_blur(img, 7, rng.uniform(0, 180))
        img = add_noise(img, 8.0, rng)
    else:
        raise ValueError(f"unknown degradation {kind!r}")
    return img, gt


DEGRADATIONS = (
    "clean", "noise", "blur", "blur_heavy", "glare", "occlusion",
    "foreshorten", "low_contrast_noise", "combined",
)
