"""Plots, visual diagnostics and calibration reports.

Port of ``stereo_vision_tpu/pipeline/reporting.py``, a rebuild of the
reference's reporting surface:
- rectified side-by-side with epipolar scanlines every 50 px
  (reference: calibrate_v4/extrinsic.py:362-430),
- distortion grid map (intrinsic.py:366-408),
- 3D camera-pose plot (extrinsic.py:503-565),
- joint-angle time series with Savgol overlay (3dpose.py:1025-1177),
- 3D trajectory plot (3dpose.py:1179-1259),
- occlusion heatmap (non_extrinsic_3d_pose.py:954),
- jitter/limb-length smoothing comparison (test_smoothing.py:81-301),
- text + PDF calibration report (calibrate_v4/extrinsic.py:182-430).

All functions write files and return the path; matplotlib uses the Agg
backend (no display), as the reference's headless mode does. matplotlib is
imported by the functions that plot (:func:`pyplot`), not with this
module: the package imports where matplotlib is not installed, and a plot
asked for there raises ``ImportError`` naming it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stereo_vision_tpu_torch.track.joints import ANGLE_NAMES, JOINT_INDEX

MATPLOTLIB_MISSING = "matplotlib is not installed: the port's plots, animations and PDF report draw with it"


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend.

    Raises:
      ImportError: matplotlib is not installed (:data:`MATPLOTLIB_MISSING`).
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(MATPLOTLIB_MISSING) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_rectification_preview(
    left_rect: np.ndarray,
    right_rect: np.ndarray,
    out_path: str | Path,
    line_spacing: int = 50,
) -> Path:
    """Side-by-side rectified pair with horizontal epipolar scanlines
    (calibrate_v4/extrinsic.py:390-394): after rectification, matching
    features must sit on the same scanline."""
    plt = pyplot()
    out_path = Path(out_path)
    h = min(left_rect.shape[0], right_rect.shape[0])
    pair = np.hstack([left_rect[:h], right_rect[:h]])
    fig, ax = plt.subplots(figsize=(14, 6))
    ax.imshow(pair, cmap="gray")
    for y in range(0, h, line_spacing):
        ax.axhline(y, color="lime", linewidth=0.5)
    ax.set_title("Rectified pair — epipolar scanlines")
    ax.axis("off")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def save_distortion_map(
    map_x: np.ndarray, map_y: np.ndarray, out_path: str | Path, step: int = 64
) -> Path:
    """Distortion displacement grid (intrinsic.py:366-408): arrows from the
    rectified grid to the source sampling positions."""
    plt = pyplot()
    out_path = Path(out_path)
    h, w = map_x.shape
    ys, xs = np.mgrid[0:h:step, 0:w:step]
    dx = map_x[::step, ::step] - xs
    dy = map_y[::step, ::step] - ys
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.quiver(xs, ys, dx, dy, np.hypot(dx, dy), angles="xy", scale_units="xy", scale=1)
    ax.invert_yaxis()
    ax.set_title("Undistort/rectify displacement field (px)")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def save_camera_pose_plot(R: np.ndarray, T: np.ndarray, out_path: str | Path) -> Path:
    """3D rig layout: camera 1 at origin, camera 2 from (R, T)
    (extrinsic.py:503-565)."""
    plt = pyplot()
    out_path = Path(out_path)
    cam2_pos = -np.asarray(R).T @ np.asarray(T).reshape(3)
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter([0], [0], [0], c="b", s=60, label="camera 1")
    ax.scatter(*cam2_pos, c="r", s=60, label="camera 2")
    for i, axis_color in enumerate("rgb"):
        v = np.asarray(R).T[:, i] * 200
        ax.quiver(*cam2_pos, *v, color=axis_color, linewidth=1)
    ax.plot([0, cam2_pos[0]], [0, cam2_pos[1]], [0, cam2_pos[2]], "k--", linewidth=0.8)
    ax.set_title(f"Stereo rig — baseline {np.linalg.norm(T):.1f} mm")
    ax.legend()
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def save_angle_series(
    angles: np.ndarray,
    fps: float,
    out_path: str | Path,
    smoothed: np.ndarray | None = None,
) -> Path:
    """(T, 8) joint-angle time series, optional smoothed overlay
    (3dpose.py:1025-1177)."""
    plt = pyplot()
    out_path = Path(out_path)
    T = angles.shape[0]
    t = np.arange(T) / fps
    fig, axes = plt.subplots(4, 2, figsize=(12, 10), sharex=True)
    for j, (name, ax) in enumerate(zip(ANGLE_NAMES, axes.ravel())):
        ax.plot(t, angles[:, j], alpha=0.5, label="raw")
        if smoothed is not None:
            ax.plot(t, smoothed[:, j], linewidth=1.5, label="smoothed")
        ax.set_title(name)
        ax.set_ylabel("deg")
    axes[-1, 0].set_xlabel("time (s)")
    axes[-1, 1].set_xlabel("time (s)")
    axes[0, 0].legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def save_trajectory_3d(
    seq: np.ndarray, out_path: str | Path, joint: str = "right_wrist"
) -> Path:
    """3D joint trajectory (3dpose.py:1179-1259)."""
    plt = pyplot()
    out_path = Path(out_path)
    p = seq[:, JOINT_INDEX[joint]]
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ok = np.isfinite(p).all(-1)
    ax.plot(p[ok, 0], p[ok, 2], p[ok, 1], "-o", markersize=2)
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("z (mm)")
    ax.set_zlabel("y (mm)")
    ax.set_title(f"{joint} trajectory")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def save_occlusion_heatmap(occ_matrix: np.ndarray, out_path: str | Path) -> Path:
    """(8, 4) visibility-category heatmap (non_extrinsic_3d_pose.py:954)."""
    plt = pyplot()
    out_path = Path(out_path)
    cats = ("both", "left only", "right only", "neither")
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(occ_matrix, cmap="viridis", aspect="auto")
    ax.set_xticks(range(4), cats)
    ax.set_yticks(range(len(ANGLE_NAMES)), ANGLE_NAMES)
    for i in range(occ_matrix.shape[0]):
        for j in range(occ_matrix.shape[1]):
            ax.text(j, i, int(occ_matrix[i, j]), ha="center", va="center", color="w", fontsize=8)
    fig.colorbar(im, label="frames")
    ax.set_title("Joint visibility by camera")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def smoothing_comparison_stats(original: np.ndarray, smoothed: np.ndarray, device=None) -> dict:
    """Jitter (mean |second derivative|) and limb-length variability before
    vs after smoothing — the reference's regression harness metrics
    (test_smoothing.py:81-301); the mean limb lengths on ``device`` (None:
    the CUDA card)."""
    from stereo_vision_tpu_torch.track.constraints import average_limb_lengths
    from stereo_vision_tpu_torch.track.joints import LIMB_PAIR_INDICES

    def jitter(seq):
        d2 = np.diff(seq, n=2, axis=0)
        return float(np.nanmean(np.abs(d2)))

    def limb_std(seq):
        a = seq[:, LIMB_PAIR_INDICES[:, 0]]
        b = seq[:, LIMB_PAIR_INDICES[:, 1]]
        lengths = np.linalg.norm(a - b, axis=-1)  # (T, P)
        return float(np.nanmean(np.nanstd(lengths, axis=0)))

    return {
        "jitter_before": jitter(original),
        "jitter_after": jitter(smoothed),
        "jitter_reduction_pct": 100.0 * (1.0 - jitter(smoothed) / max(jitter(original), 1e-12)),
        "limb_length_std_before_mm": limb_std(original),
        "limb_length_std_after_mm": limb_std(smoothed),
        "mean_limb_lengths_mm": average_limb_lengths(smoothed, device).tolist(),
    }


def save_calibration_report(
    out_path: str | Path,
    intrinsics: dict[str, dict],
    stereo: dict | None = None,
    validation: list | None = None,
) -> Path:
    """Multi-page PDF calibration report (calibrate_v4/extrinsic.py:182-430
    style): parameter tables + quality numbers."""
    plt = pyplot()
    from matplotlib.backends.backend_pdf import PdfPages

    out_path = Path(out_path)
    with PdfPages(out_path) as pdf:
        fig, ax = plt.subplots(figsize=(8.5, 11))
        ax.axis("off")
        lines = ["Stereo Calibration Report", ""]
        for cam, d in intrinsics.items():
            K = np.asarray(d["K"])
            lines += [
                f"[{cam}]",
                f"  fx={K[0,0]:.2f}  fy={K[1,1]:.2f}  cx={K[0,2]:.2f}  cy={K[1,2]:.2f}",
                f"  dist: {np.array2string(np.asarray(d['dist']).ravel()[:5], precision=4)}",
                f"  rms: {d.get('rms', float('nan')):.4f} px",
                "",
            ]
        if stereo is not None:
            lines += [
                "[stereo]",
                f"  baseline: {stereo['baseline']:.2f} mm",
                f"  rms: {stereo['rms']:.4f} px",
                f"  R: {np.array2string(np.asarray(stereo['R']), precision=4)}",
                f"  T: {np.array2string(np.asarray(stereo['T']).ravel(), precision=2)}",
                "",
            ]
        if validation:
            lines.append("[validation]")
            for v in validation:
                lines.append(
                    f"  {v.name}: measured={v.measured:.2f} expected={v.expected:.2f} "
                    f"err={v.error_percent:.2f}% {'PASS' if v.passed else 'FAIL'}"
                )
        ax.text(0.02, 0.98, "\n".join(lines), family="monospace", fontsize=9, va="top")
        pdf.savefig(fig)
        plt.close(fig)
    return out_path
