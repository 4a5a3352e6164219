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
