"""Host-side data IO without OpenCV: video decode (raw AVI in numpy,
anything else through ffmpeg), ffprobe timestamps, frame extraction, and
(``io.loader``) the prefetching window loader over the native frame ring."""

from stereo_vision_tpu_torch.io.video import (
    VIDEO_EXTENSIONS,
    find_video,
    iter_frames,
    extract_frames,
    video_info,
    extract_timestamps_ffprobe,
)

__all__ = [
    "VIDEO_EXTENSIONS",
    "find_video",
    "iter_frames",
    "extract_frames",
    "video_info",
    "extract_timestamps_ffprobe",
]
