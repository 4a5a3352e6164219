"""YOLOv8-class anchor-free detector (inference).

Port of ``stereo_vision_tpu/models/yolov8.py``'s serving path: the CSP
backbone with C2f blocks and SPPF, the PAN neck, the decoupled head with
DFL box regression (reg_max 16) over strides 8 / 16 / 32, the decode
(DFL expectation, ltrb -> xyxy) and the class-aware greedy NMS with static
shapes. Images are (B, H, W, 3) in [0, 1] and the raw maps (B, Hs, Ws,
4 * REG_MAX + C), as in the reference; the forward pass runs in IEEE
float32 (no TF32) on the images' device. The training loss waits for the
port's training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from stereo_vision_tpu_torch.models.layers import C2f, SPPF, ConvBnSiLU, fp32_forward, make_divisible, upsample2x

# depth/width multipliers per variant (public YOLOv8 scaling table).
VARIANTS = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}

STRIDES = (8, 16, 32)
REG_MAX = 16


def repeats(variant: str) -> tuple[int, int]:
    """The C2f repeat counts (n1, n2) of a variant."""
    d = VARIANTS[variant][0]
    return max(round(3 * d), 1), max(round(6 * d), 1)


class YOLOv8(nn.Module):
    """Backbone + PAN neck + decoupled head; forward returns the per-scale
    raw maps, a list of (B, Hs, Ws, 4 * REG_MAX + num_classes)."""

    def __init__(self, num_classes: int = 80, variant: str = "m"):
        super().__init__()
        self.num_classes = num_classes
        self.variant = variant
        _, w, maxc = VARIANTS[variant]
        ch = [make_divisible(min(c, maxc) * w) for c in (64, 128, 256, 512, 1024)]
        n1, n2 = repeats(variant)
        cbs = [(3, ch[0], 3, 2), (ch[0], ch[1], 3, 2), (ch[1], ch[2], 3, 2), (ch[2], ch[3], 3, 2),
               (ch[3], ch[4], 3, 2), (ch[2], ch[2], 3, 2), (ch[3], ch[3], 3, 2)]
        c2f = [(ch[1], ch[1], n1, True), (ch[2], ch[2], n2, True), (ch[3], ch[3], n2, True),
               (ch[4], ch[4], n1, True), (ch[4] + ch[3], ch[3], n1, False), (ch[3] + ch[2], ch[2], n1, False),
               (ch[2] + ch[3], ch[3], n1, False), (ch[3] + ch[4], ch[4], n1, False)]
        c_reg = max(16, ch[2] // 4, 4 * REG_MAX)
        c_cls = max(ch[2], min(num_classes, 100))
        for s, c in enumerate((ch[2], ch[3], ch[4])):
            cbs += [(c, c_reg, 3, 1), (c_reg, c_reg, 3, 1), (c, c_cls, 3, 1), (c_cls, c_cls, 3, 1)]
            setattr(self, f"Conv_{2 * s}", nn.Conv2d(c_reg, 4 * REG_MAX, 1))
            setattr(self, f"Conv_{2 * s + 1}", nn.Conv2d(c_cls, num_classes, 1))
        for i, args in enumerate(cbs):
            setattr(self, f"ConvBnSiLU_{i}", ConvBnSiLU(*args))
        for i, args in enumerate(c2f):
            setattr(self, f"C2f_{i}", C2f(*args))
        self.SPPF_0 = SPPF(ch[4], ch[4])

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        m = self._modules
        with fp32_forward():
            x = x.permute(0, 3, 1, 2)  # NHWC in, channels-last NCHW
            x = m["ConvBnSiLU_1"](m["ConvBnSiLU_0"](x))
            x = m["ConvBnSiLU_2"](m["C2f_0"](x))
            p3 = m["C2f_1"](x)
            p4 = m["C2f_2"](m["ConvBnSiLU_3"](p3))
            p5 = m["SPPF_0"](m["C2f_3"](m["ConvBnSiLU_4"](p4)))
            t4 = m["C2f_4"](torch.cat([upsample2x(p5), p4], dim=1))
            o3 = m["C2f_5"](torch.cat([upsample2x(t4), p3], dim=1))
            o4 = m["C2f_6"](torch.cat([m["ConvBnSiLU_5"](o3), t4], dim=1))
            o5 = m["C2f_7"](torch.cat([m["ConvBnSiLU_6"](o4), p5], dim=1))
            outs = []
            for s, feat in enumerate((o3, o4, o5)):
                k = 7 + 4 * s
                b = m[f"Conv_{2 * s}"](m[f"ConvBnSiLU_{k + 1}"](m[f"ConvBnSiLU_{k}"](feat)))
                c = m[f"Conv_{2 * s + 1}"](m[f"ConvBnSiLU_{k + 3}"](m[f"ConvBnSiLU_{k + 2}"](feat)))
                outs.append(torch.cat([b, c], dim=1).permute(0, 2, 3, 1))
        return outs


def anchor_points(img_hw: tuple[int, int], strides: Sequence[int] = STRIDES, device=None):
    """Concatenated (N, 2) float32 cell-centre points and (N,) strides."""
    pts, svec = [], []
    H, W = img_hw
    for s in strides:
        hs, ws = H // s, W // s
        ys = torch.arange(hs, dtype=torch.float32, device=device) + 0.5
        xs = torch.arange(ws, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        svec.append(torch.full((hs * ws,), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts), torch.cat(svec)


def dfl_expectation(box_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4, REG_MAX) logits -> (..., 4) expected ltrb distances."""
    p = torch.softmax(box_logits, dim=-1)
    bins = torch.arange(REG_MAX, dtype=p.dtype, device=p.device)
    return (p * bins).sum(-1)


def decode_predictions(raw_maps, img_hw: tuple[int, int], num_classes: int):
    """Raw per-scale maps -> ((B, N, 4) xyxy boxes in pixels, (B, N, C)
    class probabilities)."""
    B = raw_maps[0].shape[0]
    x = torch.cat([m.reshape(B, -1, m.shape[-1]) for m in raw_maps], dim=1)  # (B, N, 4 REG_MAX + C)
    ltrb = dfl_expectation(x[..., : 4 * REG_MAX].reshape(B, -1, 4, REG_MAX))  # stride units
    pts, strides = anchor_points(img_hw, device=x.device)
    x1y1 = (pts[None] - ltrb[..., :2]) * strides[None, :, None]
    x2y2 = (pts[None] + ltrb[..., 2:]) * strides[None, :, None]
    return torch.cat([x1y1, x2y2], dim=-1), torch.sigmoid(x[..., 4 * REG_MAX :])


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) xyxy
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int32
    valid: torch.Tensor    # (B, K) bool


def _iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) x (..., K, 4) -> (..., K, K) IoU."""
    def area(t):
        return (t[..., 2] - t[..., 0]).clamp(min=0) * (t[..., 3] - t[..., 1]).clamp(min=0)

    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of (..., N) non-negative float32 scores in
    ``lax.top_k``'s order: descending, the lower index first among equal
    scores. Each key is the score's bits (non-negative float32 bits order
    as the floats) above the inverted index, so the keys are distinct and
    any top-k returns the one order."""
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device, dtype=torch.int64)
    key = scores.contiguous().view(torch.int32).to(torch.int64) * (1 << 32) + ((1 << 32) - 1 - idx)
    top = torch.topk(key, k, dim=-1).values
    return (1 << 32) - 1 - (top & ((1 << 32) - 1))


def _nms_batch(boxes, scores, classes, iou_threshold: float, score_threshold: float, max_det: int) -> Detections:
    """Greedy class-aware NMS of every image of (B, N, ...) at once: the
    reference's ``fori_loop`` over the k candidates, each suppressing the
    later ones it overlaps while it is itself kept."""
    k = min(max_det, scores.shape[-1])
    idx = _top_k(scores, k)
    top_scores = torch.gather(scores, -1, idx)
    top_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    top_cls = torch.gather(classes, -1, idx)
    # Offset boxes by class so cross-class overlaps never suppress.
    ob = top_boxes + top_cls.to(boxes.dtype)[..., None] * 1e5
    iou = _iou_matrix(ob, ob)
    keep = torch.ones(idx.shape, dtype=torch.bool, device=boxes.device)
    later = torch.arange(k, device=boxes.device)
    for i in range(k):
        keep = keep & ~((iou[..., i, :] > iou_threshold) & keep[..., i : i + 1] & (later > i))
    return Detections(top_boxes, top_scores, top_cls, keep & (top_scores > score_threshold))


def nms(boxes, scores, classes, iou_threshold: float = 0.45, score_threshold: float = 0.25,
        max_det: int = 100) -> Detections:
    """Class-aware greedy NMS with static shapes of one image: boxes (N, 4),
    scores (N,), classes (N,) int."""
    d = _nms_batch(boxes[None], scores[None], classes[None], iou_threshold, score_threshold, max_det)
    return Detections(*(t[0] for t in d))


def detections_from_maps(raw, img_hw: tuple[int, int], num_classes: int, iou_threshold: float = 0.45,
                         score_threshold: float = 0.25, max_det: int = 100) -> Detections:
    """Decode + NMS of a batch's raw maps (the half of :func:`detect` after
    the forward pass)."""
    boxes, probs = decode_predictions(raw, img_hw, num_classes)
    scores, classes = probs.max(-1)
    return _nms_batch(boxes, scores, classes.to(torch.int32), iou_threshold, score_threshold, max_det)


def detect(model: YOLOv8, images: torch.Tensor, iou_threshold: float = 0.45, score_threshold: float = 0.25,
           max_det: int = 100) -> Detections:
    """Batched inference on (B, H, W, 3) images in [0, 1] on their device."""
    with torch.no_grad():
        raw = model(images)
    return detections_from_maps(raw, tuple(images.shape[1:3]), model.num_classes, iou_threshold,
                                score_threshold, max_det)
