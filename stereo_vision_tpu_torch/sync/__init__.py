"""Stereo stream synchronization: flash pulses, frame content, timestamps.

Port of ``stereo_vision_tpu/sync``: the per-frame brightness reduction, the
trailing-window jump test and the similarity matrix run on the device with
time as a batch axis; the offset searches over timestamps and the frame
mapper are host code.
"""

from stereo_vision_tpu_torch.sync.flash import (FlashSyncResult, adaptive_flash_threshold, compute_sync_offset,
                                                detect_flash, frame_brightness, synchronize_streams)
from stereo_vision_tpu_torch.sync.mapper import StereoFrameMapper
from stereo_vision_tpu_torch.sync.matching import (find_best_offset_by_content, frame_similarity,
                                                   match_frames_by_timestamp, similarity_matrix)

__all__ = [
    "frame_brightness",
    "adaptive_flash_threshold",
    "detect_flash",
    "compute_sync_offset",
    "FlashSyncResult",
    "synchronize_streams",
    "frame_similarity",
    "similarity_matrix",
    "find_best_offset_by_content",
    "match_frames_by_timestamp",
    "StereoFrameMapper",
]
