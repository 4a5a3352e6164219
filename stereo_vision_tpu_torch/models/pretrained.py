"""The in-repo pretrained detectors: loaders and frame-level inference.

Port of ``stereo_vision_tpu/models/pretrained.py``'s serving half. The
weights are the JAX package's own files, read in place
(``stereo_vision_tpu/models/weights/*.npz``, written by its ``save_tree``)
through :func:`stereo_vision_tpu_torch.models.convert.load_tree`: the ball
detector is YOLOv8 variant n with one class at 128x128, the pose net
PoseNet width 32 at 256x256.

Frames are letterboxed on the device: cv2's fixed-point bilinear resize
to the aspect-preserving size (:func:`..detect.image_ops.resize_bilinear_u8`,
equal to ``cv2.resize`` bit for bit), padded with gray 114, divided by
255. Each model is loaded once per process and device. Training waits for
the port's training slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from stereo_vision_tpu_torch.detect.ball import BallDetection
from stereo_vision_tpu_torch.detect.image_ops import linear_source_rows, resize_bilinear_u8
from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.models.convert import load_tree
from stereo_vision_tpu_torch.models.pose import PoseNet
from stereo_vision_tpu_torch.models.yolov8 import YOLOv8, detect
from stereo_vision_tpu_torch.ops.rotation import as_tensor

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "stereo_vision_tpu" / "models" / "weights"
BALL_WEIGHTS = WEIGHTS_DIR / "ball_yolov8n.npz"
POSE_WEIGHTS = WEIGHTS_DIR / "posenet_w32.npz"

BALL_IMG_HW = (128, 128)
POSE_IMG_HW = (256, 256)
POSE_WIDTH = 32

_LOADED: dict[tuple[str, torch.device], torch.nn.Module] = {}


def _load(name: str, make, path: Path, device) -> torch.nn.Module:
    dev = resolve_device(device)
    model = _LOADED.get((name, dev))
    if model is None:
        model = _LOADED[(name, dev)] = load_tree(path, make()).to(dev).eval()
    return model


def load_ball_detector(device=None) -> YOLOv8:
    """The in-repo ball detector on ``device`` (None: the CUDA card)."""
    return _load("ball", lambda: YOLOv8(num_classes=1, variant="n"), BALL_WEIGHTS, device)


def load_pose_net(device=None) -> PoseNet:
    """The in-repo 33-landmark pose net on ``device`` (None: the CUDA card)."""
    return _load("pose", lambda: PoseNet(width=POSE_WIDTH), POSE_WEIGHTS, device)


def letterbox(frames, out_hw: tuple[int, int], device=None) -> tuple[torch.Tensor, float]:
    """(T, H, W, 3) uint8 frames -> ((T, Ht, Wt, 3) float32 in [0, 1], s):
    resized by s = min(Wt / W, Ht / H) into the top-left corner, the rest
    gray 114 (a plain resize would squash balls and bodies out of the
    training distribution), on ``device`` (None: the CUDA card; a tensor
    stays on its own). Of a host array only the 2 Hr rows the resize reads
    are gathered (on the host) and moved to the device."""
    Ht, Wt = out_hw
    T, H, W = frames.shape[:3]
    s = min(Wt / W, Ht / H)
    Wr, Hr = int(round(W * s)), int(round(H * s))
    if isinstance(frames, torch.Tensor):
        rows = as_tensor(frames, device)
        resized = resize_bilinear_u8(rows, Hr, Wr)
    else:  # only the rows the resize reads cross the bus (2 Hr of H)
        rows = torch.from_numpy(np.ascontiguousarray(frames))[:, torch.from_numpy(linear_source_rows(H, Hr))]
        resized = resize_bilinear_u8(as_tensor(rows, device), Hr, Wr, src_h=H)
    small = torch.full((T, Ht, Wt, 3), 114.0, dtype=torch.float32, device=resized.device)
    small[:, :Hr, :Wr] = resized.to(torch.float32)
    # A true division (the card divides by a host scalar as a multiply by its reciprocal).
    return small / torch.tensor(255.0, device=resized.device), s


def detect_balls_in_frames(frames, score_threshold: float = 0.3, device=None) -> list[BallDetection | None]:
    """(T, H, W, 3) uint8 frames -> the best ball of each frame in frame
    pixels, or None; the letterbox, the detector and its NMS on ``device``
    (None: the CUDA card)."""
    model = load_ball_detector(device)
    small, s = letterbox(frames, BALL_IMG_HW, next(model.parameters()).device)
    dets = detect(model, small, score_threshold=score_threshold, max_det=8)
    boxes, scores, valid = (t.cpu().numpy() for t in (dets.boxes, dets.scores, dets.valid))
    out: list[BallDetection | None] = []
    for t in range(len(boxes)):
        ok = valid[t]
        if not ok.any():
            out.append(None)
            continue
        k = int(np.argmax(np.where(ok, scores[t], -1)))
        x1, y1, x2, y2 = boxes[t, k] / s
        out.append(BallDetection(cx=float((x1 + x2) / 2), cy=float((y1 + y2) / 2),
                                 radius=float((x2 - x1) + (y2 - y1)) / 4, confidence=float(scores[t, k])))
    return out


def pose_landmarks_in_frames(frames, device=None) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, 33, 4) float32 landmarks in pixels of the
    input frames (x, y, z, visibility), the MediaPipe interface the
    trackers take; the letterbox and the net on ``device`` (None: the CUDA
    card)."""
    model = load_pose_net(device)
    small, s = letterbox(frames, POSE_IMG_HW, next(model.parameters()).device)
    with torch.no_grad():
        lm = model(small).cpu().numpy()
    Ht, Wt = POSE_IMG_HW
    lm[:, :, 0] *= Wt / s
    lm[:, :, 1] *= Ht / s
    return lm
