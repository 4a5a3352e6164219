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
The batch norm is the inference form with flax's epsilon, 1e-3 (torch's
default is 1e-5); training waits for the port's training slice.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Inference batch norm over channel axis 1: (x - mean) / sqrt(var +
    eps) * weight + bias, with the running statistics as buffers."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


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


@contextlib.contextmanager
def fp32_forward():
    """Context in which cuDNN convolutions and cuBLAS matrix products run
    in IEEE float32, not TF32 (cuDNN's default allows TF32); the caller's
    settings come back on exit, and no global flag changes on import."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
