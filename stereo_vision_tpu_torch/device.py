"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; there is no silent drift to the CPU.

    Raises:
      RuntimeError: ``device`` is None and no CUDA device is available.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch forms on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def device_index(t: torch.Tensor) -> int:
    """The CUDA device index of ``t`` (the current device for a bare ``cuda``)."""
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, as the
    kernels' C entries take it: ``torch.cuda.current_stream(d).cuda_stream``
    without building a Stream object (0.46 us a call against 8.64 on an
    H100's host, ``tools/kernel_variants/pyramid_lr.py --host``: a small
    kernel's wrapper feels the difference)."""
    return torch._C._cuda_getCurrentRawStream(device_index(t))
