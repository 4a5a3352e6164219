"""Stereo pose fusion: triangulation with single-camera recovery.

Port of ``stereo_vision_tpu/track/fusion.py``:

- the EMA landmark filter, weight 0.7 on the current frame;
- triangulation of the 13 key joints that both views see (undistort with
  P = K, then the DLT of :mod:`stereo_vision_tpu_torch.ops.triangulate`);
- single-camera recovery of a joint only one view sees: back-projection
  at the most recent historical depth, blended 0.7 / 0.3 with the
  historical position, else the anatomical-ratio estimate;
- back-projection at a known depth, with the right camera's rigid
  transform.

The joints whose recovery does not read the pose being built (the
triangulation, the historical depth, the historical bone vectors) are
computed for all joints at once; the anatomical cascade then runs joint by
joint in ``JOINT_INDEX`` order, because a joint's estimate reads the joints
fused before it. :func:`fuse_pose_sequence` is the reference's ``lax.scan``
over frames as a host loop whose state (EMA landmarks, rolling history)
stays on the landmarks' device. Dtypes follow the inputs as in the JAX
package under ``jax_enable_x64``: the fused pose is float64 (the rig's
dtype), the EMA landmarks and the history keep the landmarks' dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.distortion import undistort_points
from stereo_vision_tpu_torch.ops.rotation import as_tensor, mv
from stereo_vision_tpu_torch.ops.triangulate import triangulate_points
from stereo_vision_tpu_torch.track.joints import JOINT_INDEX, MEDIAPIPE_INDICES, NUM_JOINTS

# Anatomical estimation table: joint -> (ref_joint, ref_joint2 | None,
# ratio). With two references the estimate is ref + (ref2 - ref) * ratio;
# with one, the most recent history frame supplies the bone vector.
_ANATOMY_RULES: dict[str, tuple[str, str | None, float]] = {
    "left_elbow": ("left_shoulder", "left_wrist", 0.5),
    "right_elbow": ("right_shoulder", "right_wrist", 0.5),
    "left_wrist": ("left_elbow", "left_shoulder", 2.0),
    "right_wrist": ("right_elbow", "right_shoulder", 2.0),
    "left_knee": ("left_hip", "left_ankle", 0.5),
    "right_knee": ("right_hip", "right_ankle", 0.5),
    "left_ankle": ("left_knee", "left_hip", 2.0),
    "right_ankle": ("right_knee", "right_hip", 2.0),
    "left_shoulder": ("left_hip", "nose", 0.6),
    "right_shoulder": ("right_hip", "nose", 0.6),
    "left_hip": ("left_shoulder", None, 1.7),
    "right_hip": ("right_shoulder", None, 1.7),
}
# The rules by joint index: (joint, ref, ref2 | None, ratio), and each
# ruled joint's row in them.
_RULES = tuple((JOINT_INDEX[n], JOINT_INDEX[r], None if r2 is None else JOINT_INDEX[r2], ratio)
               for n, (r, r2, ratio) in _ANATOMY_RULES.items())
_RULE_ROW = {rule[0]: k for k, rule in enumerate(_RULES)}
_RULE_JOINTS = np.array([[j, r] for j, r, *_ in _RULES])


@dataclasses.dataclass(frozen=True)
class StereoRig:
    """Calibrated stereo rig (the left camera frame is the world frame):
    P1 = K1 [I|0], P2 = K2 [R|T]."""

    K1: np.ndarray
    d1: np.ndarray
    K2: np.ndarray
    d2: np.ndarray
    R: np.ndarray
    T: np.ndarray

    @property
    def P1(self) -> np.ndarray:
        return np.asarray(self.K1) @ np.hstack([np.eye(3), np.zeros((3, 1))])

    @property
    def P2(self) -> np.ndarray:
        return np.asarray(self.K2) @ np.hstack([np.asarray(self.R), np.asarray(self.T).reshape(3, 1)])

    def as_arrays(self, device=None) -> tuple[torch.Tensor, ...]:
        """(K1, d1, K2, d2, R, T, P1, P2) as float64 tensors on ``device``
        (None: the CUDA card)."""
        arrays = (self.K1, self.d1, self.K2, self.d2, self.R, np.asarray(self.T).reshape(3), self.P1, self.P2)
        return tuple(as_tensor(np.asarray(a, np.float64), device) for a in arrays)


def extract_key_joints(landmarks, device=None) -> torch.Tensor:
    """(..., 33, C) MediaPipe landmarks -> (..., 13, C) key joints."""
    landmarks = as_tensor(landmarks, device)
    return landmarks[..., torch.as_tensor(MEDIAPIPE_INDICES, dtype=torch.long, device=landmarks.device), :]


def ema_filter(current: torch.Tensor, previous: torch.Tensor, weight: float = 0.7) -> torch.Tensor:
    """Weighted moving average, the current frame weighted ``weight``,
    rounded as XLA's CPU compiles the reference's jitted ``ema_filter``:
    fma(weight, current, (1 - weight) * previous) (``torch.addcmul``, one
    rounding for a product and the sum)."""
    w = torch.tensor(weight, dtype=current.dtype, device=current.device)
    return torch.addcmul((1.0 - weight) * previous, current, w)


def _ema_scan_step(current: torch.Tensor, previous: torch.Tensor, weight: float) -> torch.Tensor:
    """The same average as XLA compiles it inside the reference's
    ``lax.scan``: fma(1 - weight, previous, weight * current). A plain
    multiply-add differs from either in the last bit on a tenth to a fifth
    of float32 values: 0.02 mm of depth at 12 m."""
    w1 = torch.tensor(1.0 - weight, dtype=current.dtype, device=current.device)
    return torch.addcmul(weight * current, previous, w1)


def _backproject(K, R, T, pt, depth, is_right):
    """Pixels (..., 2) at depths (...) -> (..., 3) points in the left
    camera's frame; K (..., 3, 3) and is_right (...) per point."""
    x = (pt[..., 0] - K[..., 0, 2]) * depth / K[..., 0, 0]
    y = (pt[..., 1] - K[..., 1, 2]) * depth / K[..., 1, 1]
    p = torch.stack([x, y, depth], dim=-1)
    Rt = R.T
    p_right = mv(Rt, p) - mv(Rt, T)
    return torch.where(is_right[..., None], p_right, p)


def _latest(ok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For (H, n) flags over history frames (most recent last): whether any
    is set, and the index into the reversed history of the latest one
    (0 when none is set), per column."""
    rev = ok.flip(0)
    return rev.any(0), torch.argmax(rev.to(torch.uint8), dim=0)


def fuse_pose(left_xy, left_conf, right_xy, right_conf, history, calib_arrays,
              conf_threshold: float = 0.65, blend_alpha: float = 0.7) -> torch.Tensor:
    """Fuse one frame's stereo 2D keypoints into a (J, 3) pose.

    Args:
      left_xy, right_xy: (J, 2) pixel keypoints of the 13 key joints.
      left_conf, right_conf: (J,) visibilities.
      history: (H, J, 3) recent fused poses, most recent LAST; NaN = gap.
        Pass an all-NaN array when no history exists.
      calib_arrays: StereoRig.as_arrays().
      conf_threshold: visibility gate.
      blend_alpha: new/historical blend for depth recovery.

    Returns:
      (J, 3) pose in mm with NaN for unrecoverable joints.
    """
    K1, d1, K2, d2, R, T, P1, P2 = calib_arrays
    J = left_xy.shape[0]
    dev = left_xy.device
    ar = torch.arange(J, device=dev)

    lvis = left_conf > conf_threshold
    rvis = right_conf > conf_threshold
    both = lvis & rvis
    one_cam = lvis ^ rvis
    is_right = rvis & ~lvis

    tri = triangulate_points(P1, P2, undistort_points(left_xy, K1, d1, P=K1),
                             undistort_points(right_xy, K2, d2, P=K2))  # (J, 3)
    dt = tri.dtype

    # Historical-depth recovery: the most recent finite sample per joint.
    hist_ok = torch.isfinite(history).all(-1)  # (H, J)
    rev_hist = history.flip(0)
    has_hist, first = _latest(hist_ok)
    hist_pos = torch.nan_to_num(rev_hist[first, ar])  # (J, 3)

    pt = torch.where(is_right[:, None], right_xy, left_xy)
    sel = is_right.to(dt)[:, None, None]
    K = sel * K2 + (1.0 - sel) * K1  # (J, 3, 3): K2 where is_right, else K1
    upd = _backproject(K, R, T, pt, hist_pos[:, 2], is_right)
    blended = blend_alpha * upd + (1.0 - blend_alpha) * hist_pos
    nan3 = torch.full((3,), torch.nan, dtype=dt, device=dev)
    rec = torch.where(has_hist[:, None], blended, nan3)

    # The one-reference fallback's historical bone vectors, for every ruled joint.
    rj, ri = torch.as_tensor(_RULE_JOINTS.T, device=dev)
    hb_ok, hrev = _latest(hist_ok[:, rj] & hist_ok[:, ri])
    bone = torch.nan_to_num(rev_hist[hrev, rj]) - torch.nan_to_num(rev_hist[hrev, ri])  # (rules, 3)

    finite_rec = torch.isfinite(rec).all(-1)
    vals = torch.where(both[:, None], tri, torch.where(one_cam[:, None], rec, nan3))
    pose = torch.full((J, 3), torch.nan, dtype=dt, device=dev)
    for j in JOINT_INDEX.values():
        k = _RULE_ROW.get(j)
        if k is None:
            pose[j] = vals[j]
            continue
        _, r, r2, ratio = _RULES[k]
        ref_pos = pose[r]
        ref_valid = torch.isfinite(ref_pos).all()
        ref0 = torch.nan_to_num(ref_pos)
        est2 = ref0 + bone[k]
        if r2 is None:
            anat2 = _backproject(K[j], R, T, pt[j], est2[2], is_right[j])
            anat = torch.where(ref_valid & hb_ok[k], anat2, nan3)
        else:
            ref2_pos = pose[r2]
            est = ref0 + (torch.nan_to_num(ref2_pos) - ref0) * ratio
            anat, anat2 = _backproject(K[j], R, T, pt[j], torch.stack([est[2], est2[2]]), is_right[j].expand(2))
            anat_ok = ref_valid & torch.isfinite(ref2_pos).all()
            anat = torch.where(anat_ok, anat, torch.where(ref_valid & hb_ok[k], anat2, nan3))
        rec_j = torch.where(finite_rec[j], rec[j], anat)
        pose[j] = torch.where(both[j], tri[j], torch.where(one_cam[j], rec_j, nan3))
    return pose


def fuse_pose_sequence(left_landmarks, right_landmarks, calib_arrays, conf_threshold: float = 0.65,
                       blend_alpha: float = 0.7, smooth_window: int = 5,
                       temporal_filter_weight: float = 0.7, device=None) -> torch.Tensor:
    """The streaming tracker over a whole sequence: (T, 33, 4) [x, y, z,
    visibility] per view -> (T, 13, 3) fused poses in mm, NaN for
    unrecoverable joints, equal to StereoPoseTracker.process_frame frame by
    frame. Arrays go to ``device`` (None: the CUDA card); the rig's arrays
    must lie on the landmarks' device."""
    lk_all = extract_key_joints(left_landmarks, device)
    rk_all = extract_key_joints(right_landmarks, lk_all.device)
    w = temporal_filter_weight
    hist = torch.full((smooth_window, NUM_JOINTS, 3), torch.nan, dtype=lk_all.dtype, device=lk_all.device)
    poses = []
    lk = rk = None
    for t in range(lk_all.shape[0]):
        if t == 0:
            lk, rk = lk_all[0], rk_all[0]
        else:
            lk = _ema_scan_step(lk_all[t], lk, w)
            rk = _ema_scan_step(rk_all[t], rk, w)
        pose = fuse_pose(lk[:, :2], lk[:, 3], rk[:, :2], rk[:, 3], hist, calib_arrays,
                         conf_threshold=conf_threshold, blend_alpha=blend_alpha)
        # Rolling history, most recent last; NaN rows read as absent.
        hist = torch.cat([hist[1:], pose[None].to(hist.dtype)], dim=0)
        poses.append(pose)
    return torch.stack(poses)


class StereoPoseTracker:
    """Stateful streaming tracker (smooth_window 5, confidence 0.65,
    temporal filter weight 0.7); the fusion runs on ``device`` (None: the
    CUDA card)."""

    def __init__(self, rig: StereoRig, conf_threshold: float = 0.65, temporal_filter_weight: float = 0.7,
                 smooth_window: int = 5, device=None):
        self.rig = rig
        self._calib = rig.as_arrays(device)
        self.device = self._calib[0].device
        self.conf_threshold = conf_threshold
        self.w = temporal_filter_weight
        self.smooth_window = smooth_window
        self._lm_prev: dict[str, torch.Tensor] = {}
        self.pose_history: list[np.ndarray] = []

    def process_frame(self, left_landmarks, right_landmarks) -> np.ndarray:
        """(33, 4) [x_px, y_px, z, visibility] per view -> (13, 3) pose."""
        lk = extract_key_joints(as_tensor(left_landmarks, self.device, torch.float64))
        rk = extract_key_joints(as_tensor(right_landmarks, self.device, torch.float64))
        if "left" in self._lm_prev:
            lk = ema_filter(lk, self._lm_prev["left"], self.w)
            rk = ema_filter(rk, self._lm_prev["right"], self.w)
        self._lm_prev = {"left": lk, "right": rk}

        if self.pose_history:
            hist = np.stack(self.pose_history[-self.smooth_window:])
        else:
            hist = np.full((1, NUM_JOINTS, 3), np.nan)
        pose = fuse_pose(lk[:, :2], lk[:, 3], rk[:, :2], rk[:, 3], as_tensor(hist, self.device), self._calib,
                         conf_threshold=self.conf_threshold).cpu().numpy()
        self.pose_history.append(pose)
        if len(self.pose_history) > self.smooth_window:
            self.pose_history.pop(0)
        return pose
