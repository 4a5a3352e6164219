"""Artifact store: the reference's on-disk calibration schema.

Port of ``stereo_vision_tpu/pipeline/artifacts.py``. It reads and writes the
file layout the reference produces, and each file is one the JAX package's
``ArtifactStore`` reads (and the other way round):

- ``results/intrinsic_params/{cam}_matrix.txt`` / ``{cam}_distortion.txt``
  / ``{cam}_intrinsics.pkl`` (reference: intrinsic.py:410-448),
- ``results/extrinsic_params/stereo_rotation_matrix.txt``,
  ``stereo_translation_vector.txt``, ``essential_matrix.txt``,
  ``fundamental_matrix.txt``, ``extrinsic_params.pkl``
  (extrinsic.py:457-460; load contract ball_drop.py:162-223),
- rectification products ``rect_R1/R2.txt``, ``rect_P1/P2.txt``,
  ``disparity_to_depth_matrix.txt`` (calibrate_v3/v4 schema, SURVEY.md §2c),
- ``sync_data.pkl`` offset cache (ball_drop.py:15-74).

Every writer takes numpy arrays or tensors on any device (a stage's
results stay on its device until they are written here); the pickles hold
numpy arrays, as the reference's do.

``save_calibration_xml`` / ``load_calibration_xml`` write and read OpenCV's
XML storage format (``cv2.FileStorage``: ``<opencv_storage>``, matrices
``type_id="opencv-matrix"`` with rows, cols, ``dt`` and data) without
OpenCV; the doubles are written with 17 significant digits, so a matrix
reads back bit for bit, through either.
"""

from __future__ import annotations

import csv
import math
import pickle
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from stereo_vision_tpu_torch.track.fusion import StereoRig


def _host(a, dtype=None) -> np.ndarray:
    """``a`` (numpy, a tensor on any device, nested lists) as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


class ArtifactStore:
    """Test-directory-rooted artifact persistence (reference layout)."""

    def __init__(self, test_dir: str | Path):
        self.root = Path(test_dir)
        self.results = self.root / "results"
        self.intrinsic_dir = self.results / "intrinsic_params"
        self.extrinsic_dir = self.results / "extrinsic_params"
        self.rectify_dir = self.results / "rectification"
        self.sync_dir = self.results / "sync_results"

    # -- intrinsics ---------------------------------------------------------

    def save_intrinsics(self, camera_id: str, K, dist, rms: float | None = None) -> None:
        self.intrinsic_dir.mkdir(parents=True, exist_ok=True)
        K = _host(K, np.float64)
        dist = _host(dist, np.float64).reshape(1, -1)
        np.savetxt(self.intrinsic_dir / f"{camera_id}_matrix.txt", K)
        np.savetxt(self.intrinsic_dir / f"{camera_id}_distortion.txt", dist)
        with open(self.intrinsic_dir / f"{camera_id}_intrinsics.pkl", "wb") as f:
            pickle.dump((K, dist), f)
        if rms is not None:
            (self.intrinsic_dir / f"{camera_id}_info.txt").write_text(
                f"Camera: {camera_id}\nRMS Reprojection Error: {rms}\n"
            )

    def load_intrinsics(self, camera_id: str) -> tuple[np.ndarray, np.ndarray]:
        """pkl-first, txt fallback (ball_drop.py:176-189)."""
        pkl = self.intrinsic_dir / f"{camera_id}_intrinsics.pkl"
        if pkl.exists():
            with open(pkl, "rb") as f:
                K, dist = pickle.load(f)
        else:
            K = np.loadtxt(self.intrinsic_dir / f"{camera_id}_matrix.txt")
            dist = np.loadtxt(self.intrinsic_dir / f"{camera_id}_distortion.txt")
        return np.asarray(K, np.float64), np.asarray(dist, np.float64).reshape(-1)

    # -- extrinsics ---------------------------------------------------------

    def save_extrinsics(self, R, T, E=None, F=None) -> None:
        self.extrinsic_dir.mkdir(parents=True, exist_ok=True)
        R, T = _host(R), _host(T).reshape(3, 1)
        np.savetxt(self.extrinsic_dir / "stereo_rotation_matrix.txt", R)
        np.savetxt(self.extrinsic_dir / "stereo_translation_vector.txt", T)
        if E is not None:
            np.savetxt(self.extrinsic_dir / "essential_matrix.txt", _host(E))
        if F is not None:
            np.savetxt(self.extrinsic_dir / "fundamental_matrix.txt", _host(F))
        with open(self.extrinsic_dir / "extrinsic_params.pkl", "wb") as f:
            pickle.dump({"R": R, "T": T}, f)

    def load_extrinsics(self) -> tuple[np.ndarray, np.ndarray]:
        """pkl-first, txt fallback (ball_drop.py:196-211)."""
        pkl = self.extrinsic_dir / "extrinsic_params.pkl"
        if pkl.exists():
            with open(pkl, "rb") as f:
                d = pickle.load(f)
            return np.asarray(d["R"]), np.asarray(d["T"]).reshape(3, 1)
        R = np.loadtxt(self.extrinsic_dir / "stereo_rotation_matrix.txt")
        T = np.loadtxt(self.extrinsic_dir / "stereo_translation_vector.txt").reshape(3, 1)
        return R, T

    def load_rig(self) -> StereoRig:
        """Full calibration bundle (load_calibration, ball_drop.py:162-223)."""
        K1, d1 = self.load_intrinsics("left")
        K2, d2 = self.load_intrinsics("right")
        R, T = self.load_extrinsics()
        return StereoRig(K1=K1, d1=d1, K2=K2, d2=d2, R=R, T=T)

    # -- rectification ------------------------------------------------------

    def save_rectification(self, R1, R2, P1, P2, Q) -> None:
        self.rectify_dir.mkdir(parents=True, exist_ok=True)
        for name, a in (("rect_R1", R1), ("rect_R2", R2), ("rect_P1", P1), ("rect_P2", P2),
                        ("disparity_to_depth_matrix", Q)):
            np.savetxt(self.rectify_dir / f"{name}.txt", _host(a))

    def load_rectification(self):
        return tuple(
            np.loadtxt(self.rectify_dir / n)
            for n in (
                "rect_R1.txt",
                "rect_R2.txt",
                "rect_P1.txt",
                "rect_P2.txt",
                "disparity_to_depth_matrix.txt",
            )
        )

    # -- sync ----------------------------------------------------------------

    def save_sync(self, left_flash: int, right_flash: int, offset: int) -> None:
        self.sync_dir.mkdir(parents=True, exist_ok=True)
        with open(self.sync_dir / "sync_data.pkl", "wb") as f:
            pickle.dump(
                {
                    "left_flash_frame": left_flash,
                    "right_flash_frame": right_flash,
                    "frame_offset": offset,
                },
                f,
            )

    def load_sync(self) -> dict | None:
        p = self.sync_dir / "sync_data.pkl"
        if not p.exists():
            return None
        with open(p, "rb") as f:
            return pickle.load(f)


# -- OpenCV FileStorage XML / CSV interop (calibrate_v3 schema) ---------------

_XML_KEYS = ("camera_matrix_1", "dist_coeffs_1", "camera_matrix_2", "dist_coeffs_2", "R", "T")
# OpenCV's element types by their ``dt`` letter.
_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16, "i": np.int32, "f": np.float32,
       "d": np.float64}
_XML_LINE = 70  # OpenCV's data lines hold about this many characters


def _xml_number(v: float) -> str:
    """A double as OpenCV's XML writer spells it: ``.Nan``, ``.Inf``,
    ``-.Inf``, an integral value with a trailing point, otherwise 17
    significant digits (read back bit for bit)."""
    if math.isnan(v):
        return ".Nan"
    if math.isinf(v):
        return ".Inf" if v > 0 else "-.Inf"
    if v == 0:
        return "-0." if math.copysign(1.0, v) < 0 else "0."
    if v == int(v) and abs(v) < 1e15:
        return f"{int(v)}."
    text = f"{v:.17g}"
    return text if any(c in text for c in ".e") else text + "."


def _xml_matrix(name: str, m: np.ndarray) -> list[str]:
    lines, line = [], "   "
    for v in m.reshape(-1):
        token = _xml_number(float(v))
        if len(line) + 1 + len(token) > _XML_LINE and line.strip():
            lines.append(line)
            line = "   "
        line += " " + token
    lines.append(line)
    return [f'<{name} type_id="opencv-matrix">', f"  <rows>{m.shape[0]}</rows>", f"  <cols>{m.shape[1]}</cols>",
            "  <dt>d</dt>", "  <data>", *lines[:-1], f"{lines[-1]}</data></{name}>"]


def save_calibration_xml(path, K1, d1, K2, d2, R, T, E=None, F=None) -> None:
    """OpenCV FileStorage XML bundle (calibration_utils.py:15-255 schema:
    the v3 generation persisted XML alongside txt/csv), written without
    OpenCV; ``cv2.FileStorage`` reads it back bit for bit.

    Raises:
      ValueError: ``path`` names OpenCV's YAML or JSON storage
        (``.yml``, ``.yaml``, ``.json``), which the port does not write.
    """
    path = Path(path)
    if path.suffix.lower() in (".yml", ".yaml", ".json", ".gz"):
        raise ValueError(f"{path}: the port writes OpenCV's XML storage format only (a .xml path)")
    mats = [("camera_matrix_1", _host(K1, np.float64)), ("dist_coeffs_1", _host(d1, np.float64).reshape(1, -1)),
            ("camera_matrix_2", _host(K2, np.float64)), ("dist_coeffs_2", _host(d2, np.float64).reshape(1, -1)),
            ("R", _host(R, np.float64)), ("T", _host(T, np.float64).reshape(3, 1))]
    if E is not None:
        mats.append(("E", _host(E, np.float64)))
    if F is not None:
        mats.append(("F", _host(F, np.float64)))
    lines = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for name, m in mats:
        lines += _xml_matrix(name, m.reshape(m.shape[0], -1))
    lines.append("</opencv_storage>")
    path.write_text("\n".join(lines) + "\n")


def _xml_value(token: str) -> float:
    low = token.lower()
    if low in (".nan", "nan"):
        return math.nan
    if low in (".inf", "+.inf", "inf"):
        return math.inf
    if low in ("-.inf", "-inf"):
        return -math.inf
    return float(token)


def read_opencv_xml(path) -> dict[str, np.ndarray]:
    """The ``opencv-matrix`` nodes at the top of an OpenCV XML storage file,
    by name: (rows, cols) arrays of their ``dt`` (one channel)."""
    root = ET.parse(str(path)).getroot()
    if root.tag != "opencv_storage":
        raise ValueError(f"{path}: not an OpenCV storage file (root <{root.tag}>)")
    out = {}
    for node in root:
        if node.get("type_id") != "opencv-matrix":
            continue
        rows, cols = int(node.findtext("rows")), int(node.findtext("cols"))
        dt = node.findtext("dt").strip()
        if dt not in _DT:
            raise ValueError(f"{path}: matrix {node.tag} has element type {dt!r}, not one channel of {sorted(_DT)}")
        data = [_xml_value(t) for t in (node.findtext("data") or "").split()]
        out[node.tag] = np.asarray(data, np.float64).astype(_DT[dt]).reshape(rows, cols)
    return out


def load_calibration_xml(path):
    """Read a FileStorage bundle back: (K1, d1, K2, d2, R, T), None for a
    missing node (as ``FileNode.mat()``)."""
    mats = read_opencv_xml(path)
    return tuple(mats.get(k) for k in _XML_KEYS)


def load_calibration_results_pkl(path):
    """Read the reference's per-camera ``calibration_results.pkl`` schema
    (committed in calibration_tests/calibrate_v1..v2: dict with
    camera_matrix / dist_coeffs / rvecs / tvecs / reprojection_error).

    Returns (K (3,3), dist (N,), rvecs (F,3), tvecs (F,3), rms): a user
    migrating from the reference brings these files directly.
    """
    with open(path, "rb") as f:
        d = pickle.load(f)
    K = np.asarray(d["camera_matrix"], np.float64)
    dist = np.asarray(d["dist_coeffs"], np.float64).ravel()
    rvecs = np.asarray([np.asarray(r).ravel() for r in d["rvecs"]], np.float64)
    tvecs = np.asarray([np.asarray(t).ravel() for t in d["tvecs"]], np.float64)
    return K, dist, rvecs, tvecs, float(d.get("reprojection_error", np.nan))


def save_calibration_csv(path, K, dist) -> None:
    """Flat CSV export (calibrate_v3 csv schema: name,value rows)."""
    K = _host(K)
    dist = _host(dist).ravel()
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["parameter", "value"])
        w.writerow(["fx", K[0, 0]])
        w.writerow(["fy", K[1, 1]])
        w.writerow(["cx", K[0, 2]])
        w.writerow(["cy", K[1, 2]])
        for i, v in enumerate(dist):
            w.writerow([f"dist_{i}", v])
