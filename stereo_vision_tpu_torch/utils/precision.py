"""Matmul precision control.

The counterpart of ``stereo_vision_tpu/utils/precision.py``. On a TPU a
float32 matmul runs in bfloat16 passes unless asked for ``"highest"``; on an
H100, cuBLAS and cuDNN may run float32 products in TF32 (10-bit mantissa),
which costs about the same three decimal digits. ``highest_precision``
runs a function in IEEE float32, with the settings
``models.layers.fp32_forward`` sets (TF32 off for cuBLAS and cuDNN), the
caller's settings restored after it.
"""

from __future__ import annotations

import functools

from stereo_vision_tpu_torch.models.layers import fp32_forward


def highest_precision(fn):
    """Decorator: run ``fn`` with TF32 off (``fp32_forward``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with fp32_forward():
            return fn(*args, **kwargs)

    return wrapper
