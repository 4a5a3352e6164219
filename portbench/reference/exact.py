"""Plain reference of the exact SGBM matcher (cv2.StereoSGBM semantics) on rectified frames.

Frozen copy of ``stereo_vision_tpu_torch/stereo/sgbm.py::stereo_sgbm`` and ``sgbm_stats`` with their
plain forms, at commit 32282d13a4194c9fbd48da53129198c48182e76c: the full-range cost volume, the
aggregation over ``num_paths``, the WTA with uniqueness, the subpixel parabola, the LR check and the
speckle filter. Plain torch; nothing of the program is imported.
"""

from __future__ import annotations

import torch

from portbench.reference import common


def disparity(left: torch.Tensor, right: torch.Tensor, p: dict, hp: dict | None = None,
              fdt=torch.float32) -> torch.Tensor:
    """(B, H, W) int32 rectified frames -> (B, H, W) disparity in ``fdt``, invalid min_disparity - 1.
    ``p`` holds the configuration's StereoSGBM settings (P1, P2 and ftzero already worked out); the exact
    matcher has no hierarchy, so ``hp`` is None."""
    B, H, W = left.shape
    ndisp, mindisp = p["num_disparities"], p["min_disparity"]
    minX1 = max(mindisp + ndisp, 0)
    invalid_val = float(mindisp - 1)
    full = torch.full((B, H, W), invalid_val, dtype=fdt, device=left.device)
    if minX1 >= W:
        return full
    C = common.cost_volume(left, right, ndisp=ndisp, mindisp=mindisp, block_size=p["block_size"],
                           ftzero=p["ftzero"], x_offset=minX1)
    S = common.aggregate(C, p["P1"], p["P2"], p["num_paths"])
    del C
    minS, best, sm, s0, sp, unique_ok = common.wta_scan(S, ndisp, p["uniqueness_ratio"])
    del S
    disp = common.subpixel_disp16(best, sm, s0, sp, ndisp).to(fdt) / 16.0 + mindisp
    valid = unique_ok
    if p["disp12_max_diff"] >= 0:
        valid = valid & ~common.lr_fail(minS, best, disp, W=W, min_x=minX1, ndisp=ndisp, mindisp=mindisp,
                                        max_diff=p["disp12_max_diff"])
    full[..., minX1:] = torch.where(valid, disp, torch.as_tensor(invalid_val, dtype=fdt, device=disp.device))
    if p["speckle_window_size"] > 0:
        full = common.speckle_filter(full, float(p["speckle_range"]), p["speckle_window_size"], invalid_val)
    return full
