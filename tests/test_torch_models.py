"""The port's ``models`` (YOLOv8, PoseNet, the weights' conversion, the
frame-level detectors) and the hosted client's local transport against
the JAX package's, on the CPU, with the in-repo weights.

The JAX models are built from ``jax.eval_shape`` of their ``init`` and the
reference's own ``load_tree`` (a full eager init takes ~30 s here); the
JAX package's frame-level functions run with their loaders pointed at
those variables, once for the module. Both sides take the same arrays:
the JAX package's renders (its cv2 drawing) and seeded numpy. Tolerances:

- the npz leaf order equal to ``jax.tree_util``'s flatten paths (297 and
  156), the carried-across weights bit for bit;
- the raw maps within atol 2e-5 (float32 convolutions summed in another
  order; values up to ~10; 3.8e-6 measured), the landmarks and the
  heatmaps within 1e-5 (8e-7 measured);
- decode within atol 1e-4 px on boxes, 1e-6 on probabilities; NMS's kept
  set and its order exactly, tied scores included;
- the letterbox resize equal to ``cv2.resize`` bit for bit;
- the ball detections: the same frames found, centres and radii within
  1e-3 px of frame pixels, confidences within 1e-6; the pose landmarks
  within 1e-3 px, z and visibility within 1e-5.
"""

import json
import os
import pathlib
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.detect import hosted as jhosted
from stereo_vision_tpu.models import convert as jconvert
from stereo_vision_tpu.models import pretrained as jp
from stereo_vision_tpu.models import yolov8 as jyolo
from stereo_vision_tpu.synth.scenes import render_ball_drop_stereo as jrender_ball
from stereo_vision_tpu.synth.scenes import render_pose_stereo as jrender_pose
from stereo_vision_tpu.track.fusion import StereoRig
from stereo_vision_tpu_torch import models
from stereo_vision_tpu_torch.detect import hosted
from stereo_vision_tpu_torch.detect.image_ops import resize_bilinear_u8
from stereo_vision_tpu_torch.models import convert, pretrained, yolov8
from stereo_vision_tpu_torch.models.pose import PoseNet

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables(model, hw, path):
    like = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), train=False))
    return like, jp.load_tree(path, like)


@pytest.fixture(scope="module")
def ref():
    """The JAX models, their variables, and the JAX package's frame-level
    functions run once on its own renders (two frames a model)."""
    ball_m, pose_m = jp._ball_model(), jp._pose_model()
    ball_like, ball_v = _jax_variables(ball_m, jp.BALL_IMG_HW, jp.BALL_WEIGHTS)
    pose_like, pose_v = _jax_variables(pose_m, jp.POSE_IMG_HW, jp.POSE_WEIGHTS)
    K = np.array([[350.0, 0, 160], [0, 350.0, 120], [0, 0, 1.0]])
    rig = StereoRig(K1=K, d1=np.zeros(8), K2=K, d2=np.zeros(8), R=np.eye(3), T=np.array([-500.0, 0, 0]))
    lf, rf, *_ = jrender_ball(rig, T=120, fps=240.0, hold_frames=25, ball_radius_mm=80.0, seed=3)
    ball_frames = np.stack([lf[10], rf[90]])
    plf, _, _ = jrender_pose(rig, T=30, seed=2)
    pose_frames = plf[[3, 20]]
    saved = (jp.load_ball_detector, jp.load_pose_net, jp._POSE_FWD)
    jp.load_ball_detector = lambda: (ball_m, ball_v)
    jp.load_pose_net = lambda: (pose_m, pose_v)
    jp._POSE_FWD = None
    try:
        out = dict(ball=(ball_m, ball_v, ball_like), pose=(pose_m, pose_v, pose_like), ball_frames=ball_frames,
                   pose_frames=pose_frames, balls=jp.detect_balls_in_frames(ball_frames),
                   landmarks=jp.pose_landmarks_in_frames(pose_frames),
                   hosted=jhosted.HostedDetectorClient(jhosted.local_transport(), hsv_range=None,
                                                       radius_range=(2.0, 300.0)).detect(ball_frames[0]))
        small = np.full((2, 128, 128, 3), 114, np.float32)  # the reference's letterbox
        for t in range(2):
            small[t, :96] = cv2.resize(ball_frames[t], (128, 96))
        out["ball_input"] = small / 255.0
        out["ball_raw"] = [np.asarray(m) for m in ball_m.apply(ball_v, jnp.asarray(out["ball_input"]), train=False)]
        small = np.full((2, 256, 256, 3), 114, np.float32)
        for t in range(2):
            small[t, :192] = cv2.resize(pose_frames[t], (256, 192))
        out["pose_input"] = small / 255.0
        fwd = jax.jit(lambda v, x, w: pose_m.apply(v, x, train=False, return_heatmap=True, local_window=w),
                      static_argnums=2)
        out["pose_out"] = [tuple(np.asarray(a) for a in fwd(pose_v, jnp.asarray(out["pose_input"]), w))
                           for w in (0, 2)]
        return out
    finally:
        jp.load_ball_detector, jp.load_pose_net, jp._POSE_FWD = saved


@pytest.mark.parametrize("name,count", [("ball", 297), ("pose", 156)])
def test_load_tree_order_and_weights_match_jax(ref, name, count):
    _, variables, like = ref[name]
    paths = [tuple(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(like)[0]]
    port = pretrained.load_ball_detector(CPU) if name == "ball" else pretrained.load_pose_net(CPU)
    assert [p for p, _ in convert.reference_leaves(port)] == paths and len(paths) == count
    carried = convert.variables_from_reference(jax.tree_util.tree_map(np.asarray, variables))
    state = port.state_dict()
    assert sorted(carried) == sorted(state)
    for k, v in state.items():
        assert torch.equal(carried[k], v), k


def test_load_tree_refuses_other_architectures():
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.load_tree(pretrained.POSE_WEIGHTS, PoseNet(width=16))
    with pytest.raises(ValueError, match="leaves"):
        convert.load_tree(pretrained.BALL_WEIGHTS, models.YOLOv8(num_classes=1, variant="m"))


def test_yolov8_forward_decode_detect_match_jax(ref):
    model = pretrained.load_ball_detector(CPU)
    x = torch.from_numpy(ref["ball_input"])
    with torch.no_grad():
        raw = model(x)
    assert [tuple(r.shape) for r in raw] == [(2, 16, 16, 65), (2, 8, 8, 65), (2, 4, 4, 65)]
    for a, b in zip(raw, ref["ball_raw"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-5)
    # Decode and NMS on the same (the reference's) maps.
    raw_ref = [torch.tensor(r) for r in ref["ball_raw"]]
    boxes, probs = yolov8.decode_predictions(raw_ref, (128, 128), 1)
    jboxes, jprobs = jyolo.decode_predictions([jnp.asarray(r) for r in ref["ball_raw"]], (128, 128), 1)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-6)
    det = yolov8.detect(model, x, score_threshold=0.01, max_det=8)
    jm, jv, _ = ref["ball"]
    jdet = jyolo.detect(jm, jv, jnp.asarray(ref["ball_input"]), score_threshold=0.01, max_det=8)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(jdet.classes))
    assert det.valid.numpy().any(axis=1).all()
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_with_tied_scores_matches_jax(seed):
    """Clusters of overlapping boxes, two classes, scores from a few levels
    (most of them tied), more candidates than ``max_det``."""
    rng = np.random.default_rng(seed)
    n = 64
    c = rng.uniform(10, 90, (6, 2))[rng.integers(0, 6, n)] + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(8, 20, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32)
    scores = rng.choice(np.array([0.2, 0.5, 0.5, 0.7, 0.9], np.float32), n)
    classes = rng.integers(0, 2, n).astype(np.int32)
    for max_det in (8, 100):
        d = yolov8.nms(*(torch.from_numpy(a) for a in (boxes, scores, classes)), 0.45, 0.25, max_det)
        jd = jyolo.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.45, 0.25, max_det)
        for a, b in zip(d, jd):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert d.valid.any() and (max_det == 8 or not d.valid.all())


def test_posenet_forward_heatmap_and_local_window_match_jax(ref):
    model = pretrained.load_pose_net(CPU)
    x = torch.from_numpy(ref["pose_input"])
    for w, (lm_ref, heat_ref) in zip((0, 2), ref["pose_out"]):
        with torch.no_grad():
            lm, heat = model(x, return_heatmap=True, local_window=w)
        assert lm.shape == (2, 33, 4) and heat.shape == (2, 64, 64, 33)
        np.testing.assert_allclose(lm.numpy(), lm_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(heat.numpy(), heat_ref, rtol=0, atol=1e-5)
    px = models.landmarks_to_pixels(lm, 640, 480)
    np.testing.assert_array_equal(px[..., 1].numpy(), lm[..., 1].numpy() * np.float32(480))


@pytest.mark.parametrize("shape,out", [((1080, 1920), (72, 128)), ((1080, 1920), (144, 256)),
                                       ((240, 320), (96, 128)), ((240, 320), (192, 256)), ((77, 53), (31, 40))])
def test_letterbox_resize_equals_cv2(shape, out):
    img = np.random.default_rng(sum(shape) + out[0]).integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    mine = resize_bilinear_u8(torch.from_numpy(img), *out).numpy()
    for t in range(2):
        np.testing.assert_array_equal(mine[t], cv2.resize(img[t], out[::-1]))


def test_letterbox_matches_reference(ref):
    small, s = pretrained.letterbox(ref["ball_frames"], pretrained.BALL_IMG_HW, CPU)
    assert s == 0.4
    np.testing.assert_array_equal(small.numpy(), ref["ball_input"])
    small, s = pretrained.letterbox(ref["pose_frames"], pretrained.POSE_IMG_HW, CPU)
    np.testing.assert_array_equal(small.numpy(), ref["pose_input"])
    small, s = pretrained.letterbox(torch.from_numpy(ref["pose_frames"]), pretrained.POSE_IMG_HW)  # a tensor stays
    np.testing.assert_array_equal(small.numpy(), ref["pose_input"])


def test_detect_balls_in_frames_matches_jax(ref):
    out = pretrained.detect_balls_in_frames(ref["ball_frames"], device=CPU)
    assert [d is None for d in out] == [d is None for d in ref["balls"]] == [False, False]
    for d, jd in zip(out, ref["balls"]):
        np.testing.assert_allclose([d.cx, d.cy, d.radius], [jd.cx, jd.cy, jd.radius], rtol=0, atol=1e-3)
        np.testing.assert_allclose(d.confidence, jd.confidence, rtol=0, atol=1e-6)


def test_pose_landmarks_in_frames_matches_jax(ref):
    lm = pretrained.pose_landmarks_in_frames(ref["pose_frames"], device=CPU)
    assert lm.dtype == np.float32 and lm.shape == (2, 33, 4)
    np.testing.assert_allclose(lm[..., :2], ref["landmarks"][..., :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(lm[..., 2:], ref["landmarks"][..., 2:], rtol=0, atol=1e-5)


def test_local_transport_matches_jax(ref):
    client = hosted.HostedDetectorClient(hosted.local_transport(device=CPU), hsv_range=None,
                                         radius_range=(2.0, 300.0), device=CPU)
    d, jd = client.detect(ref["ball_frames"][0]), ref["hosted"]
    assert d is not None and jd is not None and client.calls == 1
    np.testing.assert_allclose([d.cx, d.cy, d.radius, d.confidence], [jd.cx, jd.cy, jd.radius, jd.confidence],
                               rtol=1e-5, atol=1e-3)


def test_ultralytics_conversion_matches_jax(ref, tmp_path):
    _, variables, _ = ref["ball"]
    fake = jconvert.flax_tree_to_fake_state_dict(jax.tree_util.tree_map(np.asarray, variables), "n")
    expect = convert.variables_from_reference(jax.tree_util.tree_map(np.asarray, variables))
    for sd in (fake, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fake.items()}):
        got = convert.convert_ultralytics_state_dict(sd, "n")
        assert sorted(got) == sorted(expect)
        for k in got:
            assert torch.equal(got[k], expect[k]), k
    path = tmp_path / "yolov8n.pt"
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fake.items()}}, path)
    got = convert.load_ultralytics_checkpoint(str(path), "n")
    model = models.YOLOv8(num_classes=1, variant="n")
    model.load_state_dict(got)
    ref_tree = jconvert.load_ultralytics_checkpoint(str(path), "n")
    assert jax.tree_util.tree_structure(ref_tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, variables))


def test_models_exports_match_jax_less_training():
    """The port's ``models`` exports every name of the JAX package's, the
    training names included (the six once left out: ``detection_loss``,
    ``pose_loss``, ``TrainState``, ``make_train_step``, ``shard_variables``,
    ``put_batch``); JAX's list is read in a subprocess."""
    code = "import json, stereo_vision_tpu.models as m; print(json.dumps(m.__all__))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    jax_all = json.loads(out.stdout.strip().splitlines()[-1])
    training = {"detection_loss", "pose_loss", "TrainState", "make_train_step", "shard_variables", "put_batch"}
    assert training <= set(models.__all__)
    assert sorted(models.__all__) == sorted(jax_all)
    for name in models.__all__:
        assert hasattr(models, name), name
