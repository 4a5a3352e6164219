"""Levenberg-Marquardt least squares, the solver behind calibrate_camera and
calibrate_stereo.

Port of ``stereo_vision_tpu/calib/lm.py``. The reference runs one
``lax.while_loop``; here the loop runs on the host and each step on the
device of ``x0``: the residual Jacobian from ``torch.func.jacfwd``, the
dense normal equations (a few hundred parameters) solved with
``torch.linalg.solve``, the multiplicative damping rule. The step's
``done`` flag is read back once an iteration, so a solve synchronises at
most ``max_iters`` times. Everything runs in the dtype of ``x0`` (the
calibrations pass float64, where no TF32 setting applies).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd

from stereo_vision_tpu_torch.ops.rotation import as_tensor


class LMResult(NamedTuple):
    params: torch.Tensor  # optimized parameter vector
    cost: torch.Tensor  # final 0.5 * sum(r^2)
    iterations: int
    lam: torch.Tensor  # final damping


def levenberg_marquardt(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0,
    max_iters: int = 60,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 0.1,
    lam_max: float = 1e10,
    rtol: float = 1e-12,
    mask=None,
    device=None,
) -> LMResult:
    """Minimize 0.5 * ||residual_fn(x)||^2 over x.

    Args:
      residual_fn: maps (P,) params to (N,) residuals; composable with
        ``torch.func`` transforms (no data-dependent Python control flow).
      x0: (P,) initial parameters (a tensor stays on its device; anything
        else goes to ``device``, None = the CUDA card).
      mask: optional (P,) {0,1}; zero entries are frozen (cv2's FIX_* flags).

    Returns:
      LMResult. An iteration: J = jacobian * mask, damped = JtJ + lam *
      diag(diag(JtJ) + 1e-12) + diag(1 - mask), dx = -solve(damped, J^T r) *
      mask; the step is taken if it lowers the cost (lam *= lam_down, at
      least 1e-12), else lam *= lam_up; it stops once an improving step
      changes the cost by less than ``rtol`` relatively, lam exceeds
      ``lam_max``, or after ``max_iters`` steps.
    """
    x = as_tensor(x0, device)
    mask = torch.ones_like(x) if mask is None else as_tensor(mask, x.device, x.dtype)
    frozen = torch.diag(1.0 - mask)

    def with_residuals(p):
        r = residual_fn(p)
        return r, r

    # The Jacobian and, as its aux output, the residuals at the same point.
    jac = jacfwd(with_residuals, has_aux=True)

    def cost_of(p):
        r = residual_fn(p)
        return 0.5 * torch.sum(r * r)

    lam = torch.tensor(lam0, dtype=x.dtype, device=x.device)
    cost = cost_of(x)
    it = 0
    while it < max_iters:
        J, r = jac(x)
        J = J * mask[None, :]
        JtJ = J.T @ J
        g = J.T @ r
        damped = JtJ + lam * torch.diag(torch.diagonal(JtJ) + 1e-12) + frozen
        dx = -torch.linalg.solve(damped, g[:, None])[:, 0] * mask
        x_new = x + dx
        new_cost = cost_of(x_new)
        improved = new_cost < cost
        x = torch.where(improved, x_new, x)
        rel = torch.abs(cost - new_cost) / torch.clamp(cost, min=1e-30)
        lam = torch.where(improved, torch.clamp(lam * lam_down, min=1e-12), lam * lam_up)
        done = (improved & (rel < rtol)) | (lam > lam_max)
        cost = torch.where(improved, new_cost, cost)
        it += 1
        if bool(done):
            break
    return LMResult(x, cost, it, lam)
