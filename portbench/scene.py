"""The clip a run streams: the textured ramp+box scene, seen by the rig's raw cameras, rendered on the device.

Frozen from ``stereo_vision_tpu_torch/synth/scenes.py`` (``scene``, ``scene_truth``, ``_smooth_texture``:
``bench.py``'s ``_scene``) at commit 32282d13a4194c9fbd48da53129198c48182e76c, in torch so that the
frames are made on the card from one ``torch.Generator``: a smoothed uniform texture, disparity ramps
20..80 px with a 90 px box, the left view the texture shifted by the disparity, Gaussian sensor noise of
sigma 1.5, clipped and truncated to 8 bits. Unlike the original the box moves from frame to frame, the
texture pans 2 px a frame, and each camera sees the rectified scene through its own distortion and
rotation (``rig.raw_to_rectified``).
"""

from __future__ import annotations

import math

import torch

PAD = 160  # texture columns left of the view, as the original's


def smooth_texture(g: torch.Generator, shape: tuple[int, int], device) -> torch.Tensor:
    t = torch.rand(shape, generator=g, device=device) * 255.0
    for _ in range(2):
        t = (t + t.roll(1, 1) + t.roll(-1, 1) + t.roll(1, 0) + t.roll(-1, 0)) / 5.0
    return (t - t.min()) / (t.max() - t.min() + 1e-9) * 255.0


def _sample(tex: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (Ht, Wt) ``tex`` at real (rows, cols), edges replicated."""
    Ht, Wt = tex.shape
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr, fc = rows - r0, cols - c0
    r0, c0 = r0.long(), c0.long()
    flat = tex.reshape(-1)

    def at(r, c):
        return flat[r.clamp(0, Ht - 1) * Wt + c.clamp(0, Wt - 1)]

    return ((at(r0, c0) * (1 - fc) + at(r0, c0 + 1) * fc) * (1 - fr)
            + (at(r0 + 1, c0) * (1 - fc) + at(r0 + 1, c0 + 1) * fc) * fr)


def disparity(u: torch.Tensor, v: torch.Tensor, t: int, n: int, H: int, W: int, box_disp: float) -> torch.Tensor:
    """True disparity at rectified (u, v) in frame t of n: ramps 20..80 px, a box of a ninth of the frame
    at ``box_disp`` px circling the centre once a clip."""
    d = 20.0 + 40.0 * u / W + 20.0 * v / H
    x0 = W / 3 + W / 6 * math.sin(2 * math.pi * t / n)
    y0 = H / 3 + H / 8 * math.cos(2 * math.pi * t / n)
    box = (u >= x0) & (u < x0 + W / 3) & (v >= y0) & (v < y0 + H / 3)
    return torch.where(box, box_disp, d)


def render_clip(seed: int, n: int, H: int, W: int, views, device, box_disp: float = 90.0, chunk: int = 8):
    """(left, right) (n, H, W) uint8 host arrays of a clip of ``n`` frames; ``views`` holds each camera's
    (u, v) rectified coordinates of its raw pixels (``rig.raw_to_rectified``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tex = smooth_texture(g, (H, W + PAD + 2 * n), device)
    (u1, v1), (u2, v2) = ((torch.as_tensor(a, device=device) for a in view) for view in views)
    outs = ([], [])
    for t0 in range(0, n, chunk):
        pair = ([], [])
        for t in range(t0, min(t0 + chunk, n)):
            pan = PAD + 2.0 * t
            pair[0].append(_sample(tex, v1, u1 + pan - disparity(u1, v1, t, n, H, W, box_disp)))
            pair[1].append(_sample(tex, v2, u2 + pan))
        for side, frames in enumerate(pair):
            img = torch.stack(frames)
            img = img + torch.randn(img.shape, generator=g, device=device) * 1.5
            outs[side].append(img.clamp(0, 255).to(torch.uint8).cpu())
    return tuple(torch.cat(o).numpy() for o in outs)
