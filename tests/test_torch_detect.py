"""The port's detectors (``stereo_vision_tpu_torch.detect``) and its
``connected_component_labels`` against the JAX package's, on the CPU.

Seeded numpy inputs go to both sides as the same arrays; the ball images
are the JAX package's own renders (``synth.scenes.draw_ball`` on
``textured_background``). Tolerances:

- bit for bit: ``rgb_to_gray`` (the port follows XLA's fused multiply-add
  chain), the HSV conversion, Otsu's threshold (the port sums its bins in
  XLA's order, so no tie rule is needed: 0 of the images here differ), the
  morphology, ``in_range``, the Sobel gradients, the component labels (also where the
  fixed rounds stop short of convergence), ``largest_component_mask``,
  circularity, the min enclosing circle, the Otsu foreground;
- the Sobel magnitude within 1 ulp (XLA's CPU square root), its edge
  masks bit for bit; the blur and the bilinear resize within rtol 1e-5; the Hough planes
  within rtol 1e-6 (the port divides exact integer counts by the ring's
  size, JAX convolves with the divided ring), the circles found equal in
  centre and radius, their scores within rtol 1e-6;
- ball scores and the hosted client's detections within rtol 1e-6 (colour
  shares: the port's float32 mean against JAX's float64 one under
  ``jax_enable_x64``).
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.detect import ball as jball
from stereo_vision_tpu.detect import circles as jcirc
from stereo_vision_tpu.detect import hosted as jhosted
from stereo_vision_tpu.detect import image_ops as jops
from stereo_vision_tpu.detect.cache import DetectionCache as JCache
from stereo_vision_tpu.detect.cache import image_hash as jhash
from stereo_vision_tpu.stereo.postprocess import connected_component_labels as jccl
from stereo_vision_tpu.synth.scenes import draw_ball, textured_background
from stereo_vision_tpu_torch import detect
from stereo_vision_tpu_torch.detect import ball, cache, circles, hosted, image_ops
from stereo_vision_tpu_torch.stereo.postprocess import connected_component_labels
from stereo_vision_tpu_torch.synth.scenes import ball_frame

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _bits_equal(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _ball_scene(seed, cx=100.0, cy=80.0, r=30.0, color=(30, 80, 230), H=160, W=200):
    img = textured_background(np.random.default_rng(seed), H, W)
    draw_ball(img, cx, cy, r, color)
    return img


def test_detect_exports_match_jax():
    from stereo_vision_tpu import detect as jdetect

    assert sorted(detect.__all__) == sorted(jdetect.__all__)
    for name in detect.__all__:
        assert hasattr(detect, name), name


# ---------------------------------------------------------------- image ops


def test_rgb_to_gray_bit_exact():
    """All 256 gray levels and 10^4 random triples: the FMA chain."""
    levels = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)[None]
    triples = np.random.default_rng(0).integers(0, 256, (1, 10_000, 3), dtype=np.uint8)
    for img in (levels, triples):
        _bits_equal(image_ops.rgb_to_gray(torch.from_numpy(img)).numpy(), jops.rgb_to_gray(jnp.asarray(img)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_hsv_matches_jax(dtype):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (40, 50, 3)).astype(dtype)
    img[0, :10] = img[0, :10, :1]  # gray pixels: diff == 0
    img[1, :5] = 0
    _bits_equal(image_ops.rgb_to_hsv(torch.from_numpy(img)).numpy(), jops.rgb_to_hsv(jnp.asarray(img)))


def _otsu_images(n, H=48, W=64, seed=2):
    rng = np.random.default_rng(seed)
    for i in range(n):
        m1, m2 = rng.uniform(20, 230, 2)
        img = np.where(rng.random((H, W)) < rng.uniform(0.2, 0.8),
                       rng.normal(m1, rng.uniform(3, 40), (H, W)), rng.normal(m2, rng.uniform(3, 40), (H, W)))
        img = np.clip(img, 0, 255).astype(np.float32)
        yield np.round(img) if i % 3 == 0 else img


def test_otsu_threshold_matches_jax():
    """200 random bimodal 48x64 images (a third of them integer-valued):
    the threshold equals JAX's on every one (the count of differing images
    is asserted 0), and so does the Otsu mask."""
    differ = 0
    for img in _otsu_images(200):
        a = float(image_ops.otsu_threshold(torch.from_numpy(img)))
        b = float(jops.otsu_threshold(jnp.asarray(img)))
        differ += a != b
    assert differ == 0
    img = next(_otsu_images(1, seed=3))
    np.testing.assert_array_equal(image_ops.otsu_binarize(torch.from_numpy(img)).numpy(),
                                  _np(jops.otsu_binarize(jnp.asarray(img))))


def test_otsu_threshold_edge_histograms():
    """A constant image, two levels, a single pixel and the full range."""
    imgs = [np.full((8, 8), 77.0, np.float32), np.where(np.eye(8) > 0, 10.0, 200.0).astype(np.float32),
            np.array([[5.0]], np.float32), np.arange(256, dtype=np.float32).reshape(16, 16),
            np.array([[300.0, -4.0, 128.0, 128.0]], np.float32)]
    for img in imgs:
        assert float(image_ops.otsu_threshold(torch.from_numpy(img))) == float(jops.otsu_threshold(jnp.asarray(img)))


@pytest.mark.parametrize("shape,ksize,sigma", [((37, 53), 5, 0.0), ((37, 53), 3, 1.0), ((20, 30, 3), 7, 1.5)])
def test_gaussian_blur_matches_jax(shape, ksize, sigma):
    img = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    np.testing.assert_allclose(image_ops.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy(),
                               _np(jops.gaussian_blur(jnp.asarray(img), ksize, sigma)), rtol=1e-5, atol=1e-4)


def test_morphology_and_in_range_bit_exact():
    rng = np.random.default_rng(5)
    mask = rng.random((31, 45)) < 0.6
    for fn, jfn in ((image_ops.binary_erode, jops.binary_erode), (image_ops.binary_dilate, jops.binary_dilate)):
        np.testing.assert_array_equal(fn(torch.from_numpy(mask)).numpy(), _np(jfn(jnp.asarray(mask))))
    hsv = _np(jops.rgb_to_hsv(jnp.asarray(rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)))).copy()
    for lo, hi in (ball.ORANGE_HSV_RANGE, ball.BLUE_HSV_RANGE, hosted.ROBOFLOW_BLUE_HSV_RANGE):
        np.testing.assert_array_equal(image_ops.in_range(torch.from_numpy(hsv), lo, hi).numpy(),
                                      _np(jops.in_range(jnp.asarray(hsv), jnp.asarray(lo), jnp.asarray(hi))))


@pytest.mark.parametrize("shape,out", [((30, 40), (45, 17)), ((30, 40, 3), (12, 80))])
def test_resize_bilinear_matches_jax(shape, out):
    img = np.random.default_rng(6).integers(0, 256, shape).astype(np.uint8)
    np.testing.assert_allclose(image_ops.resize_bilinear(torch.from_numpy(img), *out).numpy(),
                               _np(jops.resize_bilinear(jnp.asarray(img), *out)), rtol=1e-5, atol=1e-4)


def test_sobel_matches_jax():
    """The gradients bit for bit; the magnitude within 1 ulp (XLA's CPU
    square root is 1 ulp above the correctly rounded one on ~0.5% of
    values, the port's is correctly rounded; both are exact on perfect
    squares), so the Hough edge mask at an integer threshold is equal."""
    img = np.random.default_rng(7).integers(0, 256, (60, 80)).astype(np.uint8)
    mag, gx, gy = image_ops.sobel_magnitude(torch.from_numpy(img))
    jmag, jgx, jgy = jops.sobel_magnitude(jnp.asarray(img))
    _bits_equal(gx.numpy(), jgx)
    _bits_equal(gy.numpy(), jgy)
    ulps = np.abs(mag.numpy().view(np.int32) - _np(jmag).view(np.int32))
    assert ulps.max() <= 1
    for t in (50.0, 100.0, 300.0):
        np.testing.assert_array_equal(mag.numpy() > t, _np(jmag) > t)


# ------------------------------------------------------- component labels


def _adjacency(mask):
    H, W = mask.shape
    p = np.pad(mask, 1)
    return [mask & p[1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx] for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1))]


def _serpentine(n):
    """Every even row set, consecutive ones joined at alternating ends."""
    m = np.zeros((n, n), bool)
    m[::2] = True
    for i in range(1, n, 2):
        m[i, n - 1 if (i // 2) % 2 == 0 else 0] = True
    return m


def _labels(mask, adj=None, rounds=None):
    adj = _adjacency(mask) if adj is None else adj
    t = connected_component_labels([torch.from_numpy(a) for a in adj], torch.from_numpy(mask), rounds).numpy()
    j = _np(jccl([jnp.asarray(a) for a in adj], jnp.asarray(mask), rounds))
    return t, j


@pytest.mark.parametrize("seed,shape,p", [(0, (37, 53), 0.6), (1, (64, 64), 0.55), (2, (1, 90), 0.8),
                                          (3, (90, 1), 0.8), (4, (20, 31), 0.9)])
def test_connected_component_labels_bit_exact(seed, shape, p):
    mask = np.random.default_rng(seed).random(shape) < p
    t, j = _labels(mask)
    _bits_equal(t, j)


def test_connected_component_labels_random_adjacency():
    """Adjacency masks that are not a mask's own (as the speckle filter's
    disparity-difference edges), and a short round count."""
    rng = np.random.default_rng(8)
    valid = rng.random((25, 30)) < 0.8
    adj = [valid & (rng.random(valid.shape) < 0.7) for _ in range(4)]
    for rounds in (None, 3):
        t, j = _labels(valid, adj, rounds)
        _bits_equal(t, j)


def test_connected_component_labels_fixed_rounds_unconverged():
    """On the 16x16 serpentine JAX's fixed rounds leave 109 of the mask's
    pixels with a label other than the converged one; the port keeps the
    same unconverged labels (it does not iterate to convergence)."""
    mask = _serpentine(16)
    _, converged = _labels(mask, rounds=16 * 16)
    t, j = _labels(mask)
    assert int((j != converged)[mask].sum()) == 109
    _bits_equal(t, j)
    assert len(np.unique(converged[mask])) == 1


# ---------------------------------------------------------------- circles


@pytest.mark.parametrize("seed,p", [(0, 0.6), (1, 0.5), (2, 0.0), (3, 1.0)])
def test_largest_component_and_shape_scores_bit_exact(seed, p):
    mask = np.random.default_rng(seed).random((40, 56)) < p
    lt = circles.largest_component_mask(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(lt, _np(jcirc.largest_component_mask(jnp.asarray(mask))))
    _bits_equal(circles.mask_circularity(torch.from_numpy(lt)).numpy(), jcirc.mask_circularity(jnp.asarray(lt)))
    _bits_equal(circles.min_enclosing_circle(torch.from_numpy(lt)).numpy(), jcirc.min_enclosing_circle(jnp.asarray(lt)))


def test_largest_component_keeps_part_of_unconverged_serpentine():
    """The fixed rounds split the 16x16 serpentine, so the "largest
    component" is only part of it, in both packages."""
    mask = _serpentine(16)
    lt = circles.largest_component_mask(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(lt, _np(jcirc.largest_component_mask(jnp.asarray(mask))))
    assert 0 < lt.sum() < mask.sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_otsu_foreground_and_region_circularity_bit_exact(seed):
    gray = _np(jops.rgb_to_gray(jnp.asarray(_ball_scene(seed))))[40:120, 60:140]
    np.testing.assert_array_equal(circles.otsu_foreground(torch.from_numpy(gray)).numpy(),
                                  _np(jcirc.otsu_foreground(jnp.asarray(gray))))
    _bits_equal(circles.region_circularity(torch.from_numpy(gray)).numpy(), jcirc.region_circularity(jnp.asarray(gray)))


def test_hough_accumulator_matches_jax():
    edges = (np.random.default_rng(9).random((40, 60)) < 0.1).astype(np.float32)
    radii = (0, 1, 3, 5, 8, 13)
    out = circles.hough_accumulator(torch.from_numpy(edges), radii).numpy()
    ref = _np(jcirc.hough_accumulator(jnp.asarray(edges), radii))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    counts = out * np.array([(jcirc._ring_kernel(r) > 0).sum() for r in radii], np.float32)[:, None, None]
    np.testing.assert_allclose(counts, np.round(counts), rtol=0, atol=1e-4)  # integer counts over n
    assert not np.signbit(out).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_hough_accumulator_edge_strength_matches_jax(seed):
    """A float edge-strength map (a Sobel magnitude, and a map with a few
    0/1 values beside fractions) keeps its unrounded sums: within rtol 1e-5
    of JAX's normalised-ring convolution."""
    rng = np.random.default_rng(20 + seed)
    if seed == 0:
        gray = _np(jops.rgb_to_gray(jnp.asarray(_ball_scene(0))))[40:120, 60:140]
        strength = _np(jops.sobel_magnitude(jnp.asarray(gray))[0])
    else:
        strength = rng.choice(np.array([0.0, 1.0, 0.25, 2.5], np.float32), size=(40, 60))
    radii = (1, 3, 5, 8, 13)
    out = circles.hough_accumulator(torch.from_numpy(np.array(strength)), radii).numpy()
    ref = _np(jcirc.hough_accumulator(jnp.asarray(strength), radii))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))
    counts = out * np.array([(jcirc._ring_kernel(r) > 0).sum() for r in radii], np.float32)[:, None, None]
    assert not np.allclose(counts, np.round(counts), rtol=0, atol=1e-3)  # not rounded to counts


@pytest.mark.parametrize("seed,cx,cy,r", [(0, 100.0, 80.0, 30.0), (1, 70.0, 90.0, 22.0)])
def test_hough_circles_matches_jax(seed, cx, cy, r):
    gray = _np(jops.rgb_to_gray(jnp.asarray(_ball_scene(seed, cx, cy, r))))
    kw = dict(min_radius=14, max_radius=40, min_dist=30)
    out = circles.hough_circles(gray, device="cpu", **kw)
    ref = jcirc.hough_circles(jnp.asarray(gray), **kw)
    assert [c[:3] for c in out] == [c[:3] for c in ref]
    np.testing.assert_allclose([c.score for c in out], [c.score for c in ref], rtol=1e-6)
    assert abs(out[0].cx - cx) <= 1 and abs(out[0].cy - cy) <= 1


# ------------------------------------------------------------------ balls


def test_color_fraction_and_rescore_match_jax():
    img = _ball_scene(0, color=(255, 120, 30))
    draw_ball(img, 40.0, 130.0, 16.0, (30, 80, 230))
    for rng_ in (ball.ORANGE_HSV_RANGE, ball.BLUE_HSV_RANGE):
        np.testing.assert_allclose(ball.color_fraction(img[50:110, 70:130], rng_, device="cpu"),
                                   jball.color_fraction(img[50:110, 70:130], rng_), rtol=1e-6)
    boxes = [(70.0, 50.0, 130.0, 110.0, 0.8), (24.0, 114.0, 56.0, 146.0, 0.9), (0.0, 0.0, 20.0, 20.0, 0.1),
             (190.0, 150.0, 260.0, 200.0, 0.7)]
    for color_range in (None, ball.ORANGE_HSV_RANGE):
        out = ball.rescore_detections(img, boxes, color_range=color_range, device="cpu")
        ref = jball.rescore_detections(img, boxes, color_range=color_range)
        assert out[:3] == ref[:3]
        np.testing.assert_allclose(out.confidence, ref.confidence, rtol=1e-6)
    assert ball.rescore_detections(img, boxes[2:3], device="cpu") is None
    assert ball.depth_from_apparent_size(40.0, 70.0, 1400.0) == jball.depth_from_apparent_size(40.0, 70.0, 1400.0)
    assert ball.estimate_focal_length(40.0, 2450.0, 70.0) == jball.estimate_focal_length(40.0, 2450.0, 70.0)


def _pred(cx, cy, r, conf):
    return {"x": cx, "y": cy, "width": 2 * r, "height": 2 * r, "confidence": conf}


@pytest.mark.parametrize("hsv_range", [hosted.ROBOFLOW_BLUE_HSV_RANGE, None])
def test_hosted_client_matches_jax(hsv_range):
    """The colour gate, the opening sweep (max_k 2-5 here) and the size
    gate on JAX's renders, against JAX's client."""
    img = _ball_scene(3, color=(30, 80, 230))
    draw_ball(img, 40.0, 120.0, 18.0, (230, 60, 40))
    cases = [[_pred(40, 120, 18, 0.95), _pred(100, 80, 30, 0.6)], [_pred(103, 77, 34, 0.9)],
             [_pred(100, 80, 4, 0.9)], [_pred(150, 30, 40, 0.8)], []]
    for preds in cases:
        out = hosted.HostedDetectorClient(lambda im: preds, hsv_range=hsv_range, device="cpu").detect(img)
        ref = jhosted.HostedDetectorClient(lambda im: preds, hsv_range=hsv_range).detect(img)
        assert (out is None) == (ref is None)
        if ref is not None:
            np.testing.assert_allclose(np.array(out), np.array(ref), rtol=1e-6)


def test_refine_circle_matches_jax():
    img = _ball_scene(4, color=(30, 80, 230))
    for region in (img[40:120, 60:140], img[:60, :60], img[30:130, 50:150]):
        for hsv_range in (hosted.ROBOFLOW_BLUE_HSV_RANGE, None):
            out = hosted._refine_circle(region, hsv_range, device="cpu")
            ref = jhosted._refine_circle(region, hsv_range)
            assert (out is None) == (ref is None)
            if ref is not None:
                np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_hosted_client_cache(tmp_path):
    img = _ball_scene(5)
    calls = []

    def transport(im):
        calls.append(1)
        return [_pred(100, 80, 30, 0.9)]

    client = hosted.HostedDetectorClient(transport, cache_path=tmp_path / "c.pkl", device="cpu")
    first = client.detect(img)
    assert client.detect(img) == first and len(calls) == 1
    client.save_cache()
    again = hosted.HostedDetectorClient(transport, cache_path=tmp_path / "c.pkl", device="cpu")
    assert again.detect(img) == first and len(calls) == 1
    empty = hosted.HostedDetectorClient(lambda im: [], cache_path=tmp_path / "e.pkl", device="cpu")
    blank = textured_background(np.random.default_rng(6), 40, 40)
    assert empty.detect(blank) is None and empty.detect(blank) is None and empty.calls == 1


# ------------------------------------------------------------------ cache


def test_image_hash_matches_jax():
    img = np.random.default_rng(10).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    assert cache.image_hash(img) == jhash(img) == cache.image_hash(torch.from_numpy(img))
    assert cache.image_hash(img[:, ::2]) == jhash(img[:, ::2])


def test_jax_cache_loads_without_jax(tmp_path):
    """A cache the JAX package pickled (a BallDetection and a miss) loads in
    the port in a process that never imports stereo_vision_tpu."""
    img, blank = _ball_scene(7), np.zeros((4, 4, 3), np.uint8)
    jc = JCache(tmp_path / "jax.pkl")
    jc.put(img, jball.BallDetection(100.5, 80.25, 30.0, 0.75))
    jc.put(blank, "no_detection")
    jc.save()
    np.save(tmp_path / "img.npy", img)
    code = (
        "import sys, numpy as np\n"
        "from stereo_vision_tpu_torch.detect import DetectionCache, BallDetection\n"
        f"c = DetectionCache({str(tmp_path / 'jax.pkl')!r})\n"
        f"d = c.get(np.load({str(tmp_path / 'img.npy')!r}))\n"
        "assert type(d) is BallDetection and d == (100.5, 80.25, 30.0, 0.75), d\n"
        "assert c.get(np.zeros((4, 4, 3), np.uint8)) == 'no_detection' and len(c) == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'stereo_vision_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cache_refuses_other_reference_classes(tmp_path):
    """Any other class of the JAX package raises, in the cache and in the
    hosted client that opens it, and the file stays as it was (it is never
    taken for an empty cache and overwritten); a file that is no pickle
    still starts empty, as in the JAX package."""
    path = tmp_path / "c.pkl"
    with open(path, "wb") as f:
        pickle.dump({"k": jcirc.Circle(1.0, 2.0, 3.0, 0.5)}, f)
    before = path.read_bytes()
    with pytest.raises(ValueError, match="Circle"):
        cache.DetectionCache(path)
    with pytest.raises(ValueError, match="Circle"):
        hosted.HostedDetectorClient(lambda im: [], cache_path=path, device="cpu")
    assert path.read_bytes() == before
    corrupt = tmp_path / "corrupt.pkl"
    corrupt.write_bytes(b"not a pickle")
    assert len(cache.DetectionCache(corrupt)) == len(JCache(corrupt)) == 0


# ---------------------------------------------------------- entry points


def test_entry_points_need_a_card_without_device():
    """No entry point drifts to the CPU: without a card, device=None raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = ball_frame(0, H=64, W=96, cx=48.0, cy=32.0, r=12.0)
    gray = np.zeros((32, 48), np.uint8)
    for call in (lambda: detect.find_chessboard_corners(gray, (3, 3)), lambda: detect.hough_circles(gray),
                 lambda: detect.color_fraction(img), lambda: detect.rescore_detections(img, [(0, 0, 20, 20, 0.9)]),
                 lambda: detect.HostedDetectorClient(lambda im: [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_ball_frame_ball_is_found():
    """The port's own ball render (it serves the card, which has no cv2):
    Hough finds the centre within 1 px and the hosted client within 1 px."""
    img = ball_frame(1, H=120, W=160, cx=80.0, cy=60.0, r=24.0)
    gray = image_ops.rgb_to_gray(torch.from_numpy(img))
    found = circles.hough_circles(gray, min_radius=16, max_radius=36)
    assert abs(found[0].cx - 80) <= 1 and abs(found[0].cy - 60) <= 1
    det = hosted.HostedDetectorClient(lambda im: [_pred(82.0, 58.5, 26.0, 0.9)], device="cpu").detect(img)
    assert np.hypot(det.cx - 80, det.cy - 60) <= 1.0


def test_parallel_exports_match_jax_less_sharding_helpers():
    """ROADMAP C.8: the port's parallel package exports every one of JAX's
    names, the four sharding helpers of several devices (A.8) among them;
    JAX's list is read in a subprocess."""
    from stereo_vision_tpu_torch import parallel
    from stereo_vision_tpu_torch.parallel import batched_stereo_pipeline  # noqa: F401

    code = "import json, stereo_vision_tpu.parallel as p; print(json.dumps(p.__all__))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    jax_all = json.loads(out.stdout.strip().splitlines()[-1])
    helpers = {"host_cpu_mesh", "batch_sharding", "batch_rows_sharding", "replicated"}
    assert helpers <= set(jax_all)
    assert parallel.__all__ == jax_all
    for name in parallel.__all__:
        assert hasattr(parallel, name), name
