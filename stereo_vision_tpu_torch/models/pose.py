"""33-landmark pose network (MediaPipe Pose interface) and its losses.

Port of ``stereo_vision_tpu/models/pose.py``: a CSP
backbone to /16 into a /4 heatmap head through two upsample + skip stages,
decoded by a spatial soft-argmax (optionally restricted to a window around
each landmark's argmax cell), plus z and visibility regressed from the
pooled features. Images (B, H, W, 3) -> landmarks (B, 33, 4) with (x, y)
normalised to [0, 1], z and visibility. The forward pass runs in IEEE
float32 (no TF32) on the images' device; the soft-argmax expectations are
products and sums. Training supervises the coordinates and visibility
(:func:`pose_loss`) and the heatmap's distribution (:func:`heatmap_loss`,
a spatial cross-entropy against a Gaussian target): coordinate L1 alone
leaves the softmax diffuse, and a diffuse global soft-argmax drifts toward
the image centre (:func:`pose_loss_full` is the two together).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stereo_vision_tpu_torch.models.layers import C2f, SPPF, ConvBnSiLU, fp32_forward, upsample2x

NUM_LANDMARKS = 33


class PoseNet(nn.Module):
    """33-landmark pose estimator with soft-argmax heatmap decoding."""

    def __init__(self, width: int = 32, num_landmarks: int = NUM_LANDMARKS):
        super().__init__()
        w = self.width = width
        self.num_landmarks = num_landmarks
        self.ConvBnSiLU_0 = ConvBnSiLU(3, w, 3, 2)
        self.ConvBnSiLU_1 = ConvBnSiLU(w, 2 * w, 3, 2)
        self.C2f_0 = C2f(2 * w, 2 * w, 1)
        self.ConvBnSiLU_2 = ConvBnSiLU(2 * w, 4 * w, 3, 2)
        self.C2f_1 = C2f(4 * w, 4 * w, 2)
        self.ConvBnSiLU_3 = ConvBnSiLU(4 * w, 8 * w, 3, 2)
        self.C2f_2 = C2f(8 * w, 8 * w, 2)
        self.SPPF_0 = SPPF(8 * w, 8 * w)
        self.C2f_3 = C2f(12 * w, 4 * w, 1, shortcut=False)
        self.C2f_4 = C2f(6 * w, 2 * w, 1, shortcut=False)
        self.Conv_0 = nn.Conv2d(2 * w, num_landmarks, 1)
        # flax names the outer Dense first: it is constructed before the inner one.
        self.Dense_0 = nn.Linear(8 * w, 2 * num_landmarks)
        self.Dense_1 = nn.Linear(8 * w, 8 * w)

    def forward(self, x: torch.Tensor, return_heatmap: bool = False, local_window: int = 0):
        """``local_window`` > 0 restricts the soft-argmax to the (2w+1)^2
        window around each landmark's argmax cell (the reference measured it
        worse than the global decode; kept as a decode option)."""
        L = self.num_landmarks
        with fp32_forward():
            x = x.permute(0, 3, 1, 2)  # NHWC in, channels-last NCHW
            p4 = self.C2f_0(self.ConvBnSiLU_1(self.ConvBnSiLU_0(x)))
            p8 = self.C2f_1(self.ConvBnSiLU_2(p4))
            x = self.SPPF_0(self.C2f_2(self.ConvBnSiLU_3(p8)))
            h = self.C2f_3(torch.cat([upsample2x(x), p8], dim=1))
            h = self.C2f_4(torch.cat([upsample2x(h), p4], dim=1))
            heat = self.Conv_0(h)  # (B, L, H/4, W/4)
            B, _, Hh, Wh = heat.shape
            logits = heat.reshape(B, L, Hh * Wh)  # cells in row-major order
            if local_window > 0:
                am = torch.argmax(logits, dim=-1)  # (B, L) flat cell index
                ay = (am // Wh).to(heat.dtype)
                ax = (am % Wh).to(heat.dtype)
                yy = torch.arange(Hh, dtype=heat.dtype, device=heat.device)
                xx = torch.arange(Wh, dtype=heat.dtype, device=heat.device)
                my = torch.abs(yy[None, None, :] - ay[..., None]) <= local_window  # (B, L, Hh)
                mx = torch.abs(xx[None, None, :] - ax[..., None]) <= local_window  # (B, L, Wh)
                mask = (my[..., :, None] & mx[..., None, :]).reshape(B, L, Hh * Wh)
                logits = torch.where(mask, logits, -1e9)
            att = torch.softmax(logits, dim=-1).reshape(B, L, Hh, Wh)
            ys = (torch.arange(Hh, dtype=att.dtype, device=att.device) + 0.5) / Hh
            xs = (torch.arange(Wh, dtype=att.dtype, device=att.device) + 0.5) / Wh
            ex = (att * xs).sum((-2, -1))
            ey = (att * ys[:, None]).sum((-2, -1))

            g = x.mean(dim=(2, 3))
            zv = self.Dense_0(F.silu(self.Dense_1(g)))
        out = torch.stack([ex, ey, zv[:, :L], torch.sigmoid(zv[:, L:])], dim=-1)  # (B, 33, 4)
        if return_heatmap:
            return out, heat.permute(0, 2, 3, 1)
        return out


def landmarks_to_pixels(landmarks: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Normalised (B, 33, 4) -> pixel coordinates."""
    scale = torch.tensor([width, height, 1.0, 1.0], dtype=landmarks.dtype, device=landmarks.device)
    return landmarks * scale


def pose_loss(pred: torch.Tensor, gt: torch.Tensor, vis_weight: float = 1.0) -> torch.Tensor:
    """L1 on (x, y, z) weighted by the GT visibility + BCE on visibility, of
    (B, 33, 4) landmark tensors with gt[..., 3] in {0, 1}."""
    v = gt[..., 3]
    l1 = (pred[..., :3] - gt[..., :3]).abs().sum(-1)
    one = pred.new_ones(())
    coord = (l1 * v).sum() / torch.maximum(v.sum(), one)
    # jnp.clip's tie rule: the gradient splits where the value equals a bound
    p = torch.minimum(torch.maximum(pred[..., 3], pred.new_tensor(1e-6)), pred.new_tensor(1 - 1e-6))
    bce = -(v * torch.log(p) + (1 - v) * torch.log(1 - p)).mean()
    return coord + vis_weight * bce


def heatmap_loss(heat: torch.Tensor, gt: torch.Tensor, sigma_px: float = 1.25) -> torch.Tensor:
    """Spatial cross-entropy between each landmark's softmax over the
    (B, Hh, Wh, L) heatmap (``forward(..., return_heatmap=True)``'s second
    output) and a unit-mass Gaussian centred on its GT (heatmap pixels);
    landmarks of GT visibility 0 are left out."""
    B, Hh, Wh, L = heat.shape
    gx = gt[..., 0] * Wh - 0.5  # (B, L) in heatmap pixel-centre coordinates
    gy = gt[..., 1] * Hh - 0.5
    ys = torch.arange(Hh, dtype=heat.dtype, device=heat.device)
    xs = torch.arange(Wh, dtype=heat.dtype, device=heat.device)
    d2 = (ys[None, :, None, None] - gy[:, None, None, :]) ** 2 + (xs[None, None, :, None] - gx[:, None, None, :]) ** 2
    tgt = torch.exp(-d2 / (2.0 * sigma_px * sigma_px))
    tgt = tgt / torch.maximum(tgt.sum(dim=(1, 2), keepdim=True), heat.new_tensor(1e-9))
    logp = torch.log_softmax(heat.reshape(B, Hh * Wh, L), dim=1).reshape(heat.shape)
    ce = -(tgt * logp).sum(dim=(1, 2))  # (B, L)
    v = gt[..., 3]
    return (ce * v).sum() / torch.maximum(v.sum(), heat.new_ones(()))


def pose_loss_full(pred: torch.Tensor, heat: torch.Tensor, gt: torch.Tensor, hm_weight: float = 0.1) -> torch.Tensor:
    """Coordinate / visibility loss + the heatmap's distribution loss (the
    training objective of ``models.pretrained.train_pose_net``)."""
    return pose_loss(pred, gt) + hm_weight * heatmap_loss(heat, gt)
