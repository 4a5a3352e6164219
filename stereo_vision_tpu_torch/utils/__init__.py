"""Shared utilities."""

from stereo_vision_tpu_torch.utils.precision import highest_precision
from stereo_vision_tpu_torch.utils.profiling import StageTimer, time_jitted, trace

__all__ = ["highest_precision", "StageTimer", "time_jitted", "trace"]
