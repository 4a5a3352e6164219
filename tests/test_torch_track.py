"""The port's ``track`` modules (joints, angles, constraints, smoothing,
fusion, ball, dual- and single-camera analysis, the pose workflow) against
the JAX package's, on the CPU.

Seeded numpy inputs go to both sides as the same arrays, float64 under
``jax_enable_x64`` unless a case says otherwise. Tolerances:

- NaN patterns, counts, masks, selections and the start of motion exactly;
- float64 values within rtol 1e-9 / atol 1e-8 (the fused sequence: the
  JAX package's own bound between its scan and its frame loop, XLA
  contracting multiply-adds in another order), the smoothers within
  1e-10 of the data's scale;
- float32 landmarks (the fusion's EMA and history in float32, the pose in
  float64, as in the reference) within the same tolerance: the port rounds
  the EMA as XLA does (a plain multiply-add moves depths at 12 m by
  0.02 mm);
- the workflow's artifacts: the same file names, the pickles and CSVs
  within the float64 tolerance (their 2- and 3-decimal text equal), the
  stats JSON equal but for its processing time.
"""

import csv
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.detect.ball import BallDetection as JBallDetection
from stereo_vision_tpu.track import angles as jang
from stereo_vision_tpu.track import ball as jball
from stereo_vision_tpu.track import constraints as jcon
from stereo_vision_tpu.track import dual_camera as jdual
from stereo_vision_tpu.track import fusion as jfus
from stereo_vision_tpu.track import joints as jjoints
from stereo_vision_tpu.track import pose_pipeline as jpipe
from stereo_vision_tpu.track import single_camera as jsingle
from stereo_vision_tpu.track import smoothing as jsm
from stereo_vision_tpu_torch.detect.ball import BallDetection
from stereo_vision_tpu_torch.track import (angles, ball, constraints, dual_camera, fusion, joints, pose_pipeline,
                                           single_camera, smoothing)

RTOL, ATOL = 1e-9, 1e-8
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=ATOL):
    a, b = _np(a), _np(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _walk(seed, T=40, nan_share=0.0):
    """(T, 13, 3) mm poses: a base body wandering smoothly, NaN joints."""
    rng = np.random.default_rng(seed)
    base = np.array([[0, -650], [-175, -450], [175, -450], [-320, -200], [320, -200], [-380, 30], [380, 30],
                     [-125, 0], [125, 0], [-140, 400], [140, 400], [-150, 780], [150, 780]], np.float64)
    seq = np.zeros((T, 13, 3))
    seq[:, :, :2] = base + np.cumsum(rng.normal(0, 4.0, (T, 13, 2)), axis=0)
    seq[:, :, 2] = 3000.0 + np.cumsum(rng.normal(0, 3.0, (T, 13)), axis=0)
    seq += rng.normal(0, 6.0, seq.shape) * (rng.random((T, 13, 1)) < 0.1) * 10  # outlier frames
    seq[rng.random((T, 13)) < nan_share] = np.nan
    return seq


def _rig(f=1000.0, W=1280, H=720, R=None, T=(-500.0, 0.0, 0.0), dist=None):
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    d = np.zeros(8) if dist is None else dist
    kw = dict(K1=K, d1=d, K2=K, d2=d, R=np.eye(3) if R is None else R, T=np.asarray(T))
    return fusion.StereoRig(**kw), jfus.StereoRig(**kw)


def test_joint_tables_and_helpers_equal_jax():
    for name in ("KEY_JOINTS", "JOINT_NAMES", "JOINT_INDEX", "NUM_JOINTS", "LIMB_PAIRS", "POSE_LIMB_PAIRS",
                 "DEFAULT_LIMB_LENGTHS_MM", "ANGLE_TRIPLES", "ANGLE_NAMES"):
        assert getattr(joints, name) == getattr(jjoints, name), name
    for name in ("MEDIAPIPE_INDICES", "LIMB_PAIR_INDICES", "DEFAULT_LIMB_LENGTH_VEC", "ANGLE_TRIPLE_INDICES"):
        np.testing.assert_array_equal(getattr(joints, name), getattr(jjoints, name))
    seq = _walk(0, T=3, nan_share=0.2)
    dicts = joints.sequence_to_dicts(seq)
    assert [sorted(d) for d in dicts] == [sorted(d) for d in jjoints.sequence_to_dicts(seq)]
    np.testing.assert_array_equal(joints.sequence_to_array(dicts), jjoints.sequence_to_array(dicts))


def test_angles_match_jax():
    seq = _walk(1, T=20, nan_share=0.1)
    _close(angles.pose_angles(seq, CPU), jang.pose_angles(jnp.asarray(seq)))
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(0, 100, (50, 3)) for _ in range(3))
    c[:5] = b[:5] + 2.0 * (a[:5] - b[:5])  # collinear: the clamp at 1
    _close(angles.angle_3d(*(torch.from_numpy(x) for x in (a, b, c))), jang.angle_3d(a, b, c))
    d, jd = angles.pose_angles_dict(seq[3], CPU), jang.pose_angles_dict(seq[3])
    assert sorted(d) == sorted(jd)
    np.testing.assert_allclose([d[k] for k in sorted(d)], [jd[k] for k in sorted(jd)], rtol=RTOL)


def test_constraints_match_jax():
    seq = _walk(3, T=30, nan_share=0.08)
    _close(constraints.average_limb_lengths(seq, CPU), jcon.average_limb_lengths(seq))
    for ref in (None, jcon.average_limb_lengths(seq) * 0.9):
        out, n = constraints.apply_anatomical_constraints_sequence(seq, ref, 0.05, device=CPU)
        jout, jn = jcon.apply_anatomical_constraints_sequence(seq, ref, 0.05)
        assert n == jn and n > 0
        _close(out, jout)
    for thr in (20.0, 50.0):
        out, n = constraints.apply_velocity_constraints(seq, thr, device=CPU)
        jout, jn = jcon.apply_velocity_constraints(seq, thr)
        assert n == jn and n > 0
        _close(out, jout)
    out, n = constraints.apply_velocity_constraints(seq[:2], device=CPU)
    assert n == 0 and np.array_equal(out, seq[:2], equal_nan=True)
    total = 0
    for t in range(1, 12):
        out, n = constraints.apply_bone_length_constraints(seq[t], seq[t - 1], 0.05, device=CPU)
        jout, jn = jcon.apply_bone_length_constraints(seq[t], seq[t - 1], 0.05)
        assert n == jn
        total += n
        _close(out, jout)
    assert total > 0


@pytest.mark.parametrize("window,poly", [(9, 2), (13, 3), (31, 3), (8, 2)])
def test_filters_match_jax(window, poly):
    x = np.random.default_rng(window).normal(0, 50, (64, 13, 3))
    _close(smoothing.savgol_filter_time(torch.from_numpy(x), window, poly),
           jsm.savgol_filter_time(jnp.asarray(x), window, poly), rtol=0, atol=1e-10 * 50)
    w = window | 1
    _close(smoothing.moving_average_time(torch.from_numpy(x), w), jsm.moving_average_time(jnp.asarray(x), w),
           rtol=0, atol=1e-10 * 50)
    _close(smoothing.one_euro_filter_time(torch.from_numpy(x), 1.0, 0.1 * poly),
           jsm.one_euro_filter_time(jnp.asarray(x), 1.0, 0.1 * poly), rtol=0, atol=1e-10 * 50)
    np.testing.assert_array_equal(smoothing.savgol_coefficients(w, poly), jsm.savgol_coefficients(w, poly))
    series = x[:, 0, 0].copy()
    series[[2, 30, 31]] = np.nan  # compressed to its valid samples, filtered, scattered back
    for method in ("savgol", "moving_average", "one_euro"):
        for s_ in (series, np.where(np.arange(64) < 64 - w + 4, np.nan, series)):  # the second: too few samples
            _close(smoothing._filter_with_nan_gaps(s_, w, poly, method, CPU),
                   jsm._filter_with_nan_gaps(s_, w, poly, method), rtol=0, atol=1e-10 * 50)


@pytest.mark.parametrize("preset", ["smalliphone", "iphone", "edger"])
@pytest.mark.parametrize("method", ["savgol", "moving_average", "one_euro"])
def test_motion_smoother_matches_jax(preset, method):
    seq = _walk(4, T=48)
    if preset == "smalliphone" and method != "one_euro":  # the per-series path (others: one batch)
        seq[[3, 17, 30], 4:6] = np.nan  # gaps: the valid samples filter compressed
        seq[5:44, 2] = np.nan  # a joint with too few valid samples stays as it is
    sm = smoothing.MotionSmoother(preset, device=CPU, smoothing_method=method)
    jsmoother = jsm.MotionSmoother(preset, smoothing_method=method)
    _close(sm.smooth_pose_sequence(seq), jsmoother.smooth_pose_sequence(seq))
    for k in ("frames_processed", "anatomical_corrections", "velocity_corrections"):
        assert sm.stats[k] == jsmoother.stats[k], k
    _close(sm.reference_limb_lengths, jsmoother.reference_limb_lengths)
    assert sm.stats["anatomical_corrections"] > 0
    hist = list(seq[:3])
    _close(sm.smooth_single_pose(seq[3], hist), jsmoother.smooth_single_pose(seq[3], hist))
    short = seq[:4]
    np.testing.assert_array_equal(sm.smooth_pose_sequence(short), short)


def _landmarks(T, seed, dtype=np.float64):
    """The 500-frame case of tests/test_track.py: wandering 2D tracks with
    15% visibility dropouts a view (historical-depth and anatomy recovery)."""
    rng = np.random.default_rng(seed)
    lm_l = np.zeros((T, 33, 4))
    lm_r = np.zeros((T, 33, 4))
    base = np.cumsum(rng.normal(0, 2.0, (T, 33, 2)), axis=0) + [640, 360]
    lm_l[:, :, :2] = base
    lm_r[:, :, :2] = base - [40.0, 0.0]
    lm_l[:, :, 3] = np.where(rng.random((T, 33)) < 0.15, 0.1, 0.99)
    lm_r[:, :, 3] = np.where(rng.random((T, 33)) < 0.15, 0.1, 0.99)
    return lm_l.astype(dtype), lm_r.astype(dtype)


def test_fuse_pose_sequence_500_frames_matches_jax():
    rig, jrig = _rig()
    lm_l, lm_r = _landmarks(500, 3)
    out = fusion.fuse_pose_sequence(lm_l, lm_r, rig.as_arrays(CPU), device=CPU)
    ref = np.asarray(jfus.fuse_pose_sequence(jnp.asarray(lm_l), jnp.asarray(lm_r), jrig.as_arrays()))
    assert out.dtype == torch.float64 and out.shape == (500, 13, 3)
    nan_share = np.isnan(ref).mean()
    assert 0.0 < nan_share < 0.05  # recovery paths taken, a few joints unrecoverable
    _close(out, ref)


def test_fuse_pose_sequence_float32_and_distortion_match_jax():
    dist = np.array([-0.12, 0.05, 1e-3, -5e-4, 0.0, 0.0, 0.0, 0.0])
    rig, jrig = _rig(R=np.array([[0.9998, -0.02, 0], [0.02, 0.9998, 0], [0, 0, 1.0]]), dist=dist)
    lm_l, lm_r = _landmarks(60, 7, np.float32)
    kw = dict(conf_threshold=0.5, blend_alpha=0.6, smooth_window=3, temporal_filter_weight=0.8)
    out = fusion.fuse_pose_sequence(lm_l, lm_r, rig.as_arrays(CPU), device=CPU, **kw)
    ref = np.asarray(jfus.fuse_pose_sequence(jnp.asarray(lm_l), jnp.asarray(lm_r), jrig.as_arrays(), **kw))
    assert ref.dtype == np.float64 and out.dtype == torch.float64
    _close(out, ref)


def test_stereo_pose_tracker_matches_jax():
    rig, jrig = _rig()
    lm_l, lm_r = _landmarks(8, 11)
    # One frame of history: the reference compiles its fuse_pose once a history length.
    tr, jtr = fusion.StereoPoseTracker(rig, smooth_window=1, device=CPU), jfus.StereoPoseTracker(jrig, smooth_window=1)
    for t in range(8):
        _close(tr.process_frame(lm_l[t], lm_r[t]), jtr.process_frame(lm_l[t], lm_r[t]))
    assert len(tr.pose_history) == len(jtr.pose_history) == 1
    _close(fusion.ema_filter(torch.ones(3), torch.zeros(3), 0.3), jfus.ema_filter(jnp.ones(3), jnp.zeros(3), 0.3),
           rtol=1e-7)


def _detections(seed, T=90, miss=0.1):
    """A dropping ball's pixel centres seen by a 1280x720 rig (f 1000, 500 mm
    baseline), with detector noise and misses."""
    rng = np.random.default_rng(seed)
    t = np.maximum(np.arange(T) - 15, 0) / 240.0
    Y = -300.0 + 0.5 * 9800.0 * t**2
    Z = 2500.0
    u = 640 + 1000.0 * 20.0 / Z + rng.normal(0, 0.05, T)
    v = 360 + 1000.0 * Y / Z + rng.normal(0, 0.05, T)
    ur = u - 1000.0 * 500.0 / Z + rng.normal(0, 0.05, T)
    miss_l, miss_r = rng.random(T) < miss, rng.random(T) < miss
    port = ([None if m else BallDetection(a, b, 10.0, 0.9) for m, a, b in zip(miss_l, u, v)],
            [None if m else BallDetection(a, b, 10.0, 0.9) for m, a, b in zip(miss_r, ur, v)])
    ref = ([None if m else JBallDetection(a, b, 10.0, 0.9) for m, a, b in zip(miss_l, u, v)],
           [None if m else JBallDetection(a, b, 10.0, 0.9) for m, a, b in zip(miss_r, ur, v)])
    return port, ref


@pytest.mark.parametrize("seed,miss", [(0, 0.0), (1, 0.15), (2, 0.95)])
def test_ball_drop_matches_jax(seed, miss):
    rig, jrig = _rig()
    (dl, dr), (jdl, jdr) = _detections(seed, miss=miss)
    tr = ball.analyze_ball_drop(rig, dl, dr, fps=240.0, device=CPU)
    jtr = jball.analyze_ball_drop(jrig, jdl, jdr, fps=240.0)
    _close(tr.positions_3d, jtr.positions_3d)
    _close(tr.velocities, jtr.velocities, rtol=1e-7, atol=1e-5)
    np.testing.assert_array_equal(tr.valid, jtr.valid)
    np.testing.assert_array_equal(tr.timestamps, jtr.timestamps)
    assert tr.drop_start == jtr.drop_start
    assert (tr.gravity_mm_s2 is None) == (jtr.gravity_mm_s2 is None) == (miss > 0.5)
    rep, jrep = ball.drop_report(tr, 800.0), jball.drop_report(jtr, 800.0)
    assert sorted(rep) == sorted(jrep)
    for k in rep:
        if rep[k] is None:
            assert jrep[k] is None, k
        else:
            np.testing.assert_allclose(rep[k], jrep[k], rtol=1e-7, err_msg=k)
    if tr.gravity_mm_s2 is not None:
        assert abs(tr.gravity_mm_s2 - 9800.0) < 200.0


def _mp_landmarks(seed, T=30):
    rng = np.random.default_rng(seed)
    lm = np.zeros((T, 33, 4))
    lm[:, :, :3] = rng.normal(0, 200, (33, 3)) + np.cumsum(rng.normal(0, 5, (T, 33, 3)), axis=0)
    lm[:, :, 3] = rng.uniform(0.2, 1.0, (T, 33))
    lm[:4, :, 3] = 0.9  # ties between the cameras
    return lm


def test_dual_and_single_camera_match_jax():
    left, right = _mp_landmarks(0), _mp_landmarks(1)
    right[:4, :, 3] = 0.9
    res = dual_camera.analyze_dual_camera(left, right, 0.5, device=CPU)
    jres = jdual.analyze_dual_camera(left, right, 0.5)
    for a, b in zip(res[:3], jres[:3]):
        _close(a, b)
    np.testing.assert_array_equal(res.chose_left, jres.chose_left)
    assert res.occlusion_stats == jres.occlusion_stats
    np.testing.assert_array_equal(dual_camera.occlusion_matrix(res.occlusion_stats),
                                  jdual.occlusion_matrix(jres.occlusion_stats))
    s, js = single_camera.analyze_single_camera(left, 0.6, device=CPU), jsingle.analyze_single_camera(left, 0.6)
    _close(s.angles, js.angles)
    _close(s.mean_confidence, js.mean_confidence)
    assert sorted(s.stats) == sorted(js.stats)
    for k in s.stats:
        assert sorted(s.stats[k]) == sorted(js.stats[k])
        np.testing.assert_allclose([s.stats[k][m] for m in sorted(s.stats[k])],
                                   [js.stats[k][m] for m in sorted(js.stats[k])], rtol=RTOL)


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_run_pose_workflow_artifacts_match_jax(tmp_path):
    rig, jrig = _rig()
    lm_l, lm_r = _landmarks(24, 5)
    res = pose_pipeline.run_pose_workflow(rig, lm_l, lm_r, "smalliphone", 0.65, tmp_path / "port", 30.0, device=CPU)
    jres = jpipe.run_pose_workflow(jrig, lm_l, lm_r, "smalliphone", 0.65, tmp_path / "jax", 30.0)
    for a, b in zip(res[:4], jres[:4]):
        _close(a, b)
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert port_files == jax_files and len(port_files) == 8  # the plots: angles.png, trajectory.png
    for name in ("pose_3d_original.pkl", "pose_3d_smoothed.pkl"):
        with open(tmp_path / "port" / name, "rb") as f, open(tmp_path / "jax" / name, "rb") as g:
            _close(pickle.load(f), pickle.load(g))
    for name in ("joint_angles.csv", "angle_statistics.csv"):
        a, b = _csv_rows(tmp_path / "port" / name), _csv_rows(tmp_path / "jax" / name)
        assert a[0] == b[0] and len(a) == len(b)
        for ra, rb in zip(a[1:], b[1:]):
            assert ra[0] == rb[0]
            np.testing.assert_allclose(np.asarray(ra[1:], float), np.asarray(rb[1:], float), rtol=0, atol=1e-2)
    txt = (tmp_path / "port" / "angle_statistics.txt").read_text()
    assert txt.splitlines()[0] == (tmp_path / "jax" / "angle_statistics.txt").read_text().splitlines()[0]
    st = json.loads((tmp_path / "port" / "smoothing_stats.json").read_text())
    jst = json.loads((tmp_path / "jax" / "smoothing_stats.json").read_text())
    assert sorted(st) == sorted(jst)
    assert {k: v for k, v in st.items() if k != "processing_time"} == {
        k: v for k, v in jst.items() if k != "processing_time"}
