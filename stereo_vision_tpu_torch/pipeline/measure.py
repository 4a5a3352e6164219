"""Click-to-measure: point-pair distance measurement from clicked pixels.

Port of ``stereo_vision_tpu/pipeline/measure.py``. It rebuilds the
reference's interactive DistanceMeasurementTool
(calibration_tests/calibrate_v4/distance.py:227-486, select_points +
measure_point_to_point_distance; also calibrate_v3/DISTANCEmeasurement.py:
17-457) for a headless framework:

- the measurement math (undistort -> triangulate -> distances + known-
  distance validation) is identical and fully scriptable, in float64 on
  ``device`` (None: the CUDA card);
- clicks come from a REPLAY FILE (JSON) instead of an OpenCV mouse
  callback, so measurements are reproducible and testable; a matplotlib
  ``ginput`` picker is provided for interactive use where a display
  exists (it writes the same clicks file, closing the loop).

Clicks file schema (one JSON object)::

    {"measurements": [
        {"name": "doorway",
         "left":  [[x1, y1], [x2, y2]],
         "right": [[x1, y1], [x2, y2]],
         "expected_mm": 813.0}          # optional known distance
    ]}

Each measurement triangulates its N clicked correspondences; N >= 2
reports the point-to-point distance between the first two points
(reference measure_point_to_point_distance:distance.py:331-436), N == 1
reports the distance from the camera (|P|, reference distance.py:419).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

import torch

from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops.distortion import undistort_points
from stereo_vision_tpu_torch.ops.triangulate import triangulate_points
from stereo_vision_tpu_torch.track.validators import ValidationResult, validate_length


@dataclass
class ClickMeasurement:
    name: str
    left: np.ndarray   # (N, 2) pixel clicks in the left image
    right: np.ndarray  # (N, 2) matched clicks in the right image
    expected_mm: float | None = None


@dataclass
class MeasureReport:
    name: str
    points_3d: np.ndarray           # (N, 3) mm, camera-1 frame
    distance_mm: float | None       # point-to-point (first two points)
    camera_distance_mm: np.ndarray  # (N,) |P| per point
    validation: ValidationResult | None = None

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "points_3d_mm": np.asarray(self.points_3d).tolist(),
            "camera_distance_mm": np.asarray(self.camera_distance_mm).tolist(),
        }
        if self.distance_mm is not None:
            out["distance_mm"] = float(self.distance_mm)
        if self.validation is not None:
            out["validation"] = self.validation._asdict()
        return out


def load_clicks(path: str | Path) -> list[ClickMeasurement]:
    data = json.loads(Path(path).read_text())
    out = []
    for m in data["measurements"]:
        left = np.asarray(m["left"], np.float64).reshape(-1, 2)
        right = np.asarray(m["right"], np.float64).reshape(-1, 2)
        if len(left) != len(right):
            raise ValueError(
                f"measurement {m.get('name')!r}: left/right click counts differ"
            )
        out.append(
            ClickMeasurement(
                name=str(m.get("name", f"measurement_{len(out)}")),
                left=left,
                right=right,
                expected_mm=(float(m["expected_mm"]) if "expected_mm" in m else None),
            )
        )
    return out


def save_clicks(path: str | Path, measurements: list[ClickMeasurement]) -> None:
    data = {"measurements": []}
    for m in measurements:
        entry = {"name": m.name, "left": m.left.tolist(), "right": m.right.tolist()}
        if m.expected_mm is not None:
            entry["expected_mm"] = m.expected_mm
        data["measurements"].append(entry)
    Path(path).write_text(json.dumps(data, indent=2))


def measure_clicks(
    clicks: list[ClickMeasurement],
    K1, d1, K2, d2, P1, P2,
    R1=None, R2=None,
    tolerance_percent: float = 10.0,
    device=None,
) -> list[MeasureReport]:
    """Triangulate clicked correspondences and measure distances.

    With ``R1/R2`` given, clicks are undistorted into the RECTIFIED frame
    and P1/P2 must be the rectified projections (the reference's
    StereoCameraSystem.triangulate_points path, distance.py:159-207);
    without them, P1/P2 are K1[I|0] / K2[R|T]-style projections and each
    camera's clicks are undistorted with its OWN intrinsics (P=K): the
    undistorted pixel x = K @ x_norm is exactly what those projections
    expect. (Passing P2 = K2@[R|T] to the undistort reprojection would
    silently read fx'/cx' out of K2@R and drop its lower rows — wrong
    whenever the rig rotation is not identity.)
    """
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    rectified = R1 is not None or R2 is not None
    reports = []
    for m in clicks:
        ul = undistort_points(t(m.left), t(K1), t(d1), R=None if R1 is None else t(R1),
                              P=t(P1 if rectified else K1))
        ur = undistort_points(t(m.right), t(K2), t(d2), R=None if R2 is None else t(R2),
                              P=t(P2 if rectified else K2))
        pts = triangulate_points(t(P1)[:3, :4], t(P2)[:3, :4], ul, ur).cpu().numpy()
        dist = None
        validation = None
        if len(pts) >= 2:
            dist = float(np.linalg.norm(pts[0] - pts[1]))
            if m.expected_mm is not None:
                validation = validate_length(
                    pts[0], pts[1], m.expected_mm, tolerance_percent, name=m.name
                )
        elif m.expected_mm is not None:
            cam = float(np.linalg.norm(pts[0]))
            validation = ValidationResult.make(
                m.name, cam, m.expected_mm, tolerance_percent
            )
        reports.append(
            MeasureReport(
                name=m.name,
                points_3d=pts,
                distance_mm=dist,
                camera_distance_mm=np.linalg.norm(pts, axis=-1),
                validation=validation,
            )
        )
    return reports


def pick_points_matplotlib(
    image: np.ndarray, num_points: int, title: str = "click points"
) -> np.ndarray:
    """Interactive picker (matplotlib ginput) for environments with a
    display — the offline stand-in for the reference's cv2 mouse loop
    (distance.py:239-329). Returns (num_points, 2) pixel coords. Raises
    ``ImportError`` where matplotlib is not installed."""
    from stereo_vision_tpu_torch.pipeline.reporting import MATPLOTLIB_MISSING

    try:
        import matplotlib.pyplot as plt  # the caller's backend: this one needs a display
    except ImportError as e:
        raise ImportError(MATPLOTLIB_MISSING) from e

    fig, ax = plt.subplots()
    ax.imshow(image, cmap="gray" if image.ndim == 2 else None)
    ax.set_title(f"{title} — click {num_points} point(s)")
    pts = fig.ginput(num_points, timeout=0)
    plt.close(fig)
    if len(pts) != num_points:
        raise RuntimeError(f"expected {num_points} clicks, got {len(pts)}")
    return np.asarray(pts, np.float64)
