"""The in-repo pretrained detectors: training entry points, loaders and
frame-level inference.

Port of ``stereo_vision_tpu/models/pretrained.py``. The served weights are
the JAX package's own files, read in place
(``stereo_vision_tpu/models/weights/*.npz``, written by its ``save_tree``)
through :func:`stereo_vision_tpu_torch.models.convert.load_tree`: the ball
detector is YOLOv8 variant n with one class at 128x128, the pose net
PoseNet width 32 at 256x256.

Frames are letterboxed on the device: cv2's fixed-point bilinear resize
to the aspect-preserving size (:func:`..detect.image_ops.resize_bilinear_u8`,
equal to ``cv2.resize`` bit for bit), padded with gray 114, divided by
255. Each model is loaded once per process and device.

Train on the card (the reference's defaults; the weights go to
``TRAINED_DIR``, never into the JAX package's files):

    python3 -m stereo_vision_tpu_torch.models.pretrained ball|pose|both [--steps N]

The ball detector trains on rendered ball scenes at 128x128, batch 16, one
float32 batch rendered on the host and uploaded a step; the pose net at
256x256, batch 16, ``scan_chunk`` steps rendered as uint8, uploaded at once
and run with no read-back between them. Both from flax's initialisation
(``layers.init_flax_style``), with AdamW (weight decay 1e-4 on every
parameter) under optax's warmup-cosine schedule from 0 to a 2e-3 peak,
evaluated at the count of steps taken (the first step runs at lr 0).
"""

from __future__ import annotations

import argparse
import contextlib
import math
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from stereo_vision_tpu_torch.detect.ball import BallDetection
from stereo_vision_tpu_torch.detect.image_ops import linear_source_rows, resize_bilinear_u8
from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.models.convert import load_tree, reference_arrays
from stereo_vision_tpu_torch.models.layers import fp32_forward, init_flax_style
from stereo_vision_tpu_torch.models.pose import PoseNet, pose_loss_full
from stereo_vision_tpu_torch.models.yolov8 import YOLOv8, detect, detection_loss
from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.synth.scenes import ball_training_batch, pose_training_batch, render_pool

# The served weights: the JAX package's files (read only).
WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "stereo_vision_tpu" / "models" / "weights"
BALL_WEIGHTS = WEIGHTS_DIR / "ball_yolov8n.npz"
POSE_WEIGHTS = WEIGHTS_DIR / "posenet_w32.npz"
# Where the port's trainers write by default (git-ignored).
TRAINED_DIR = Path(__file__).resolve().parent / "weights"

BALL_IMG_HW = (128, 128)
POSE_IMG_HW = (256, 256)
POSE_WIDTH = 32

_LOADED: dict[tuple[str, torch.device], torch.nn.Module] = {}


def save_tree(path: str | Path, variables: nn.Module) -> None:
    """Save a model's reference variable tree as ``arr_0..`` in
    ``jax.tree_util``'s flatten order and flax's layouts (the reference's
    ``save_tree`` format: its ``load_tree`` and :func:`..convert.load_tree`
    read it)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, *[a for _, a in reference_arrays(variables)])


def _load(name: str, make, path: Path, device) -> torch.nn.Module:
    dev = resolve_device(device)
    model = _LOADED.get((name, dev))
    if model is None:
        model = _LOADED[(name, dev)] = load_tree(path, make()).to(dev).eval()
    return model


def load_ball_detector(device=None) -> YOLOv8:
    """The in-repo ball detector on ``device`` (None: the CUDA card)."""
    return _load("ball", _ball_model, BALL_WEIGHTS, device)


def load_pose_net(device=None) -> PoseNet:
    """The in-repo 33-landmark pose net on ``device`` (None: the CUDA card)."""
    return _load("pose", _pose_model, POSE_WEIGHTS, device)


def _ball_model() -> YOLOv8:
    return YOLOv8(num_classes=1, variant="n")


def _pose_model() -> PoseNet:
    return PoseNet(width=POSE_WIDTH)


def warmup_cosine_lr(count: int, warmup: int, total: int, peak: float) -> float:
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)`` at
    ``count``: linear from 0 to ``peak`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``."""
    if count < warmup:
        return (0.0 - peak) * (1.0 - count / warmup) + peak
    c = min(count - warmup, total - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / (total - warmup)))


def adamw_warmup_cosine(params, steps: int, peak: float = 2e-3):
    """(optimizer, scheduler) of the reference's trainers: ``torch.optim.AdamW``
    (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4 on every parameter) and
    a ``LambdaLR`` that sets step k's lr to :func:`warmup_cosine_lr` (k,
    warmup = min(50, max(steps // 10, 1)), max(steps, warmup + 1)); k counts
    the steps already taken, so step 0 runs at lr 0 (Adam's moments still
    move)."""
    warm = min(50, max(steps // 10, 1))
    total = max(steps, warm + 1)
    opt = torch.optim.AdamW(params, lr=peak, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: warmup_cosine_lr(k, warm, total, peak) / peak)


def _make_bn_train_step(model: nn.Module, loss_of_out: Callable, tx, apply_kwargs=None):
    """A training step of ``model`` in ``train()`` mode (BatchNorm on the
    batch's statistics, its running statistics moved): ``step(images,
    *targets)`` runs forward, loss and backward in IEEE float32
    (``fp32_forward``), the optimizer and the scheduler of ``tx``
    (``(optimizer, scheduler)``), and returns the loss on the device (no
    read-back). The parameters' gradients stay until the next step."""
    opt, sched = tx
    kw = apply_kwargs or {}

    def step(images: torch.Tensor, *targets) -> torch.Tensor:
        model.train()
        opt.zero_grad(set_to_none=True)
        with fp32_forward():
            loss = loss_of_out(model(images, **kw), *targets)
            loss.backward()
        opt.step()
        sched.step()
        return loss.detach()

    return step


def _make_bn_train_scan(model: nn.Module, loss_of_out: Callable, tx, apply_kwargs=None):
    """K steps of :func:`_make_bn_train_step` over a (K, B, H, W, 3) uint8
    batch on the device (converted there, a true division by 255) and (K,
    ...) targets, with no read-back between them; returns the (K,) losses
    on the device."""
    step = _make_bn_train_step(model, loss_of_out, tx, apply_kwargs)

    def steps(imgs_u8: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
        scale = torch.tensor(255.0, device=imgs_u8.device)
        return torch.stack([step(img.to(torch.float32) / scale, gt) for img, gt in zip(imgs_u8, gts)])

    return steps


def _renderers(dev: torch.device):
    """Where the batches' pixels are rendered: on the card's host a pool of
    spawned processes (:func:`..synth.scenes.render_pool`), on the CPU, whose
    cores train, this process (None)."""
    return render_pool() if dev.type == "cuda" else contextlib.nullcontext()


def train_ball_detector(steps: int = 800, batch: int = 16, seed: int = 0, out_path: str | Path | None = None,
                        log_every: int = 50, device=None) -> dict:
    """Train the single-class YOLOv8-n on rendered ball scenes on ``device``
    (None: the CUDA card) from flax's initialisation drawn from ``seed``,
    and save it with :func:`save_tree` to ``out_path`` (default
    ``TRAINED_DIR / "ball_yolov8n.npz"``). The batches' random numbers are
    drawn here in the reference's order; their pixels are rendered on a
    pool of processes on the card's host. Returns {"final_loss", "path",
    "losses" (every step's), "model" (the trained model, in eval mode)}."""
    dev = resolve_device(device)
    H, W = BALL_IMG_HW
    model = init_flax_style(_ball_model(), torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.default_rng(seed)
    step = _make_bn_train_step(model, lambda raw, b, c, v: detection_loss(raw, b, c, v, (H, W), 1),
                               adamw_warmup_cosine(model.parameters(), steps))
    losses, last = [], float("nan")
    with _renderers(dev) as pool:
        for i in range(steps):
            batch_np = ball_training_batch(rng, batch, H, W, pool=pool)
            losses.append(step(*(torch.from_numpy(a).to(dev) for a in batch_np)))
            if i % log_every == 0 or i == steps - 1:
                last = float(losses[-1])
                print(f"ball step {i}: loss {last:.4f}", flush=True)
    model.eval()
    out_path = Path(out_path) if out_path is not None else TRAINED_DIR / "ball_yolov8n.npz"
    save_tree(out_path, model)
    return {"final_loss": last, "path": str(out_path), "losses": torch.stack(losses).cpu().tolist(), "model": model}


def train_pose_net(steps: int = 3000, batch: int = 16, seed: int = 0, out_path: str | Path | None = None,
                   log_every: int = 50, scan_chunk: int = 25, device=None) -> dict:
    """Train the 33-landmark PoseNet on rendered stick figures on ``device``
    (None: the CUDA card) from flax's initialisation drawn from ``seed``,
    with the coordinate, visibility and heatmap loss (``pose_loss_full``),
    and save it with :func:`save_tree` to ``out_path`` (default
    ``TRAINED_DIR / "posenet_w32.npz"``). ``scan_chunk`` steps are rendered
    on the host as uint8 (as in :func:`train_ball_detector`), uploaded at
    once and run with their losses read back once. Returns {"final_loss",
    "path", "losses", "model"}."""
    dev = resolve_device(device)
    H, W = POSE_IMG_HW
    model = init_flax_style(_pose_model(), torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.default_rng(seed)
    step_many = _make_bn_train_scan(model, lambda out, gt: pose_loss_full(out[0], out[1], gt),
                                    adamw_warmup_cosine(model.parameters(), steps),
                                    apply_kwargs={"return_heatmap": True})

    losses, last, done = [], float("nan"), 0
    with _renderers(dev) as pool:
        while done < steps:
            k = min(scan_chunk, steps - done)
            imgs = np.zeros((k, batch, H, W, 3), np.uint8)
            gts = np.zeros((k, batch, 33, 4), np.float32)
            for j in range(k):
                im, gts[j] = pose_training_batch(rng, batch, H, W, pool=pool)
                imgs[j] = np.round(im * 255.0).astype(np.uint8)
            chunk = step_many(torch.from_numpy(imgs).to(dev), torch.from_numpy(gts).to(dev)).cpu()
            losses += chunk.tolist()
            done += k
            if done % log_every < k or done == steps:
                last = float(chunk[-1])
                print(f"pose step {done - 1}: loss {last:.4f}", flush=True)
    model.eval()
    out_path = Path(out_path) if out_path is not None else TRAINED_DIR / "posenet_w32.npz"
    save_tree(out_path, model)
    return {"final_loss": last, "path": str(out_path), "losses": losses, "model": model}


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


def detect_balls_in_frames(frames, score_threshold: float = 0.3, device=None,
                           model: YOLOv8 | None = None) -> list[BallDetection | None]:
    """(T, H, W, 3) uint8 frames -> the best ball of each frame in frame
    pixels, or None; the letterbox, the detector and its NMS on ``device``
    (None: the CUDA card), or on ``model``'s device where a detector is
    given (default: the in-repo one)."""
    model = model if model is not None else load_ball_detector(device)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train the in-repo ball detector and pose net on the CUDA card.")
    ap.add_argument("which", choices=["ball", "pose", "both"])
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    kw = {"steps": args.steps} if args.steps else {}
    for name, train in (("ball", train_ball_detector), ("pose", train_pose_net)):
        if args.which in (name, "both"):
            res = train(**kw)
            print({k: res[k] for k in ("final_loss", "path")})


if __name__ == "__main__":
    main()
