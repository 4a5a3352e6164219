"""Plain reference of the streamed pipeline: raw gray frames -> remap + round -> matcher -> 3D -> stats.

Frozen copy of ``stereo_vision_tpu_torch/parallel/streaming.py::batched_stereo_pipeline`` at commit
32282d13a4194c9fbd48da53129198c48182e76c, with the matcher's reference named by the configuration
(``"matcher_reference"``: a module of this package with ``disparity``). Plain torch; nothing of the
program is imported.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.reference import common


def sgbm_settings(cfg: dict) -> dict:
    """The configuration's StereoSGBM settings with P1, P2 and ftzero worked out as cv2 does."""
    p = dict(cfg["params"])
    bs = p["block_size"]
    p["P1"] = p["p1"] if p.get("p1") is not None else 8 * bs * bs
    p["P2"] = p["p2"] if p.get("p2") is not None else 32 * bs * bs
    p["ftzero"] = max(p["prefilter_cap"], 15) | 1
    return p


def run(left: np.ndarray, right: np.ndarray, maps, Q, cfg: dict, device, fdt=torch.float32, block: int = 4):
    """(N, H, W) uint8 raw frames -> (disparity (N, H, W), points (N, H, W, 3), stats (N, 2)) as numpy
    arrays, ``block`` frames at a time on ``device``; every float32 stage in ``fdt``."""
    matcher = importlib.import_module(cfg["matcher_reference"])
    p = sgbm_settings(cfg)
    hp = cfg.get("hier")
    mx1, my1, mx2, my2 = (torch.as_tensor(np.asarray(m, np.float32), device=device) for m in maps)
    Qd = torch.as_tensor(np.asarray(Q, np.float32), device=device)
    outs = []
    for i in range(0, len(left), block):
        lt, rt = (torch.as_tensor(a[i:i + block], device=device) for a in (left, right))
        lr = torch.round(common.remap_bilinear(lt, mx1, my1, fdt)).to(torch.int32)
        rr = torch.round(common.remap_bilinear(rt, mx2, my2, fdt)).to(torch.int32)
        disp = matcher.disparity(lr, rr, p, hp, fdt)
        pts = common.reproject(disp, Qd)
        stats = common.frame_stats(disp, pts)
        outs.append(tuple(t.float().cpu().numpy() for t in (disp, pts, stats)))
        del lt, rt, lr, rr, disp, pts, stats
    return tuple(np.concatenate(o) for o in zip(*outs))
