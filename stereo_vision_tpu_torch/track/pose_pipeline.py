"""The stereo-pose workflow: fuse, constrain, smooth, angles, artifacts.

Port of ``stereo_vision_tpu/track/pose_pipeline.py``: synchronised
landmark sequences in, the fused and smoothed 3D poses and their joint
angles out, with the reference's artifact set: the pose pickles (before
and after smoothing), the angle CSV, the smoothing stats JSON and the
per-joint angle statistics (text and CSV), and, best-effort as in the JAX
package, ``angles.png`` and ``trajectory.png`` through ``pipeline.reporting``
(skipped where they cannot be drawn, e.g. without matplotlib).
"""

from __future__ import annotations

import csv
import json
import pickle
from pathlib import Path
from typing import NamedTuple

import numpy as np

from stereo_vision_tpu_torch.track.angles import pose_angles
from stereo_vision_tpu_torch.track.fusion import StereoRig, fuse_pose_sequence
from stereo_vision_tpu_torch.track.joints import ANGLE_NAMES
from stereo_vision_tpu_torch.track.smoothing import MotionSmoother


class PoseWorkflowResult(NamedTuple):
    poses_raw: np.ndarray       # (T, 13, 3) fused 3D poses (mm)
    poses_smoothed: np.ndarray  # (T, 13, 3)
    angles_raw: np.ndarray      # (T, 8) degrees
    angles_smoothed: np.ndarray
    smoothing_stats: dict


def _write_artifacts(out: Path, poses, smoothed, ang_raw, ang_sm, stats: dict, fps: float) -> None:
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "pose_3d_original.pkl", "wb") as f:
        pickle.dump(poses, f)
    with open(out / "pose_3d_smoothed.pkl", "wb") as f:
        pickle.dump(smoothed, f)
    with open(out / "joint_angles.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "time_s", *ANGLE_NAMES])
        for t in range(len(ang_sm)):
            w.writerow([t, t / fps, *[f"{a:.3f}" for a in ang_sm[t]]])
    (out / "smoothing_stats.json").write_text(json.dumps(stats, indent=2))
    stat_rows = []
    with np.errstate(all="ignore"):
        for j, name in enumerate(ANGLE_NAMES):
            a = ang_sm[:, j]
            a = a[np.isfinite(a)]
            if len(a):
                stat_rows.append((name, a.mean(), np.median(a), a.std(), a.min(), a.max()))
    txt = ["Angle Statistics for 3D Pose", ""]
    for name, mean, med, std, lo, hi in stat_rows:
        txt += [
            f"{name.replace('_', ' ').title()}:",
            f"  Mean: {mean:.2f}°",
            f"  Median: {med:.2f}°",
            f"  Standard Deviation: {std:.2f}°",
            f"  Range: {lo:.2f}° - {hi:.2f}°",
            "",
        ]
    (out / "angle_statistics.txt").write_text("\n".join(txt) + "\n")
    with open(out / "angle_statistics.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["joint", "mean", "median", "std", "min", "max"])
        for name, mean, med, std, lo, hi in stat_rows:
            w.writerow([name] + [f"{v:.2f}" for v in (mean, med, std, lo, hi)])
    try:
        from stereo_vision_tpu_torch.pipeline.reporting import save_angle_series, save_trajectory_3d

        save_angle_series(ang_raw, fps, out / "angles.png", smoothed=ang_sm)
        save_trajectory_3d(smoothed, out / "trajectory.png")
    except Exception:  # plotting is best-effort (headless variations)
        pass


def run_pose_workflow(
    rig: StereoRig,
    left_landmarks: np.ndarray,
    right_landmarks: np.ndarray,
    smoothing_preset: str = "smalliphone",
    conf_threshold: float = 0.65,
    out_dir: str | Path | None = None,
    fps: float = 30.0,
    device=None,
) -> PoseWorkflowResult:
    """Fuse + constrain + smooth a synchronised landmark sequence pair on
    ``device`` (None: the CUDA card).

    Args:
      left_landmarks, right_landmarks: (T, 33, 4) pixel-space landmark
        sequences [x, y, z, visibility], already synchronised.
      out_dir: when given, the artifacts are written there (see the module
        docstring).
    """
    calib = rig.as_arrays(device)
    dev = calib[0].device
    poses = fuse_pose_sequence(np.asarray(left_landmarks, np.float64), np.asarray(right_landmarks, np.float64),
                               calib, conf_threshold=conf_threshold, device=dev).cpu().numpy()
    smoother = MotionSmoother(smoothing_preset, device=dev)
    smoothed = smoother.smooth_pose_sequence(poses)
    ang_raw = pose_angles(poses, dev).cpu().numpy()
    ang_sm = pose_angles(smoothed, dev).cpu().numpy()
    if out_dir is not None:
        _write_artifacts(Path(out_dir), poses, smoothed, ang_raw, ang_sm, smoother.stats, fps)
    return PoseWorkflowResult(poses, smoothed, ang_raw, ang_sm, smoother.stats)
