"""Building blocks of the detection and pose networks (torch.nn).

Port of ``stereo_vision_tpu/models/layers.py`` (flax): Conv + BatchNorm +
SiLU, the Bottleneck, C2f (split, bottlenecks appending each output,
concatenate, fuse) and SPPF (three stacked 5x5 max-pools). The port's
modules compute in NCHW (a network's entry point takes the reference's
NHWC images and permutes them, so the convolutions run channels-last in
memory); the channel order of every split and concatenation is the
reference's.

Each submodule's attribute name is the flax auto-name of the module it
ports (``ConvBnSiLU_0``, ``Conv_0``, ``BatchNorm_0``, ...), and each leaf
module's parameters map one to one onto flax's leaves, so the reference's
variable trees load by name (:mod:`stereo_vision_tpu_torch.models.convert`).
The batch norm is flax's, epsilon 1e-3 (torch's default is 1e-5) and
momentum 0.97: in ``eval()`` mode it normalises with the running statistics,
in ``train()`` mode with the batch's own, as flax's ``train=True``.
:func:`init_flax_style` initialises a fresh model as flax's ``init`` does
(its draws from a ``torch.Generator``, not JAX's PRNG).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function_unary


def batch_statistics(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's batch statistics of an NCHW batch over (N, H, W): the mean and
    the biased variance in its fast form, E[x^2] - E[x]^2 clamped at 0, with
    the gradient through both. A ``TorchFunctionMode`` sees the call, as it
    sees ``F.batch_norm`` (``models.train.make_train_step``'s probe stops
    there)."""
    if has_torch_function_unary(x):
        return handle_torch_function(batch_statistics, (x,), x)
    mean = x.mean(dim=(0, 2, 3))
    return mean, torch.maximum((x * x).mean(dim=(0, 2, 3)) - mean * mean, x.new_zeros(()))


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over channel axis 1, the running statistics
    as buffers. ``eval()``: (x - running_mean) / sqrt(running_var + eps) *
    weight + bias. ``train()``: the batch's mean and biased variance over
    (N, H, W) in flax's fast form, E[x^2] - E[x]^2 clamped at 0, with the
    gradient through both, and the buffers moved to ``momentum * r + (1 -
    momentum) * stat`` without a gradient. (``F.batch_norm(training=True)``
    weighs the buffers the other way round and stores the unbiased
    variance.) The batch's statistics come from :func:`batch_statistics`."""

    momentum = 0.97

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        mean, var = batch_statistics(x)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight  # flax's order: (x - mean) * (rsqrt * scale) + bias
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class ConvBnSiLU(nn.Module):
    """k x k convolution (no bias, k // 2 padding each side) + BatchNorm +
    SiLU, the universal YOLO block."""

    def __init__(self, c_in: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, features, kernel, stride, padding=kernel // 2, bias=False)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.BatchNorm_0(self.Conv_0(x)))


class Bottleneck(nn.Module):
    """Two 3x3 ConvBnSiLU with a residual where the widths agree."""

    def __init__(self, c_in: int, features: int, shortcut: bool = True):
        super().__init__()
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, features, 3)
        self.ConvBnSiLU_1 = ConvBnSiLU(features, features, 3)
        self.residual = shortcut and c_in == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBnSiLU_1(self.ConvBnSiLU_0(x))
        return x + y if self.residual else y


class C2f(nn.Module):
    """Cross-stage-partial block: a 1x1 conv to 2c channels split in two
    halves, n bottlenecks on the second half appending each output, all
    concatenated and fused by a 1x1 conv."""

    def __init__(self, c_in: int, features: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c = features // 2
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, 2 * c, 1)
        self.n = n
        for i in range(n):
            setattr(self, f"Bottleneck_{i}", Bottleneck(c, c, shortcut))
        self.ConvBnSiLU_1 = ConvBnSiLU((2 + n) * c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1, y2 = self.ConvBnSiLU_0(x).chunk(2, dim=1)
        outs = [y1, y2]
        for i in range(self.n):
            y2 = getattr(self, f"Bottleneck_{i}")(y2)
            outs.append(y2)
        return self.ConvBnSiLU_1(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three stacked 5x5 max-pools, stride
    1, padded with -inf to keep the size (flax's 'SAME')."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        c = features // 2
        self.ConvBnSiLU_0 = ConvBnSiLU(c_in, c, 1)
        self.ConvBnSiLU_1 = ConvBnSiLU(4 * c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBnSiLU_0(x)
        p1 = F.max_pool2d(x, 5, 1, padding=2)
        p2 = F.max_pool2d(p1, 5, 1, padding=2)
        p3 = F.max_pool2d(p2, 5, 1, padding=2)
        return self.ConvBnSiLU_1(torch.cat([x, p1, p2, p3], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an (N, C, H, W) tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def make_divisible(v: float, divisor: int = 8) -> int:
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


def scaled_widths(widths: Sequence[int], width_mult: float) -> list[int]:
    return [make_divisible(w * width_mult) for w in widths]


@torch.no_grad()
def init_flax_style(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``model`` (in place, returned) as flax's ``init`` does,
    drawing from ``generator`` in the order of ``model.modules()``:
    ``lecun_normal`` for every convolution and linear weight (a normal
    truncated at 2 standard deviations, scaled to variance 1 / fan_in; fan_in
    = kernel height x width x input channels, the same in flax's HWIO and
    torch's OIHW), zero biases, BatchNorm's weight and running variance 1,
    its bias and running mean 0. JAX's PRNG cannot be reproduced, so the
    draws differ from the reference's."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # the std of a unit normal cut at +-2
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model


@contextlib.contextmanager
def fp32_forward():
    """Context in which cuDNN convolutions and cuBLAS matrix products run
    in IEEE float32, not TF32 (cuDNN's default allows TF32); the caller's
    settings come back on exit, and no global flag changes on import. A
    training step runs its ``backward()`` inside it too: the flags are read
    when each convolution launches."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
