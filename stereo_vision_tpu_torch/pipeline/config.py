"""Typed configuration for the whole pipeline.

Port of ``stereo_vision_tpu/pipeline/config.py`` (plain dataclasses, the
same JSON). The reference's configuration is argparse flags scattered per script with
drifting defaults (checkerboard 7x4 vs 9x7 vs 9x6; square 100 vs 25 vs 26
vs 30 mm — SURVEY.md §5 "Config / flag system"). This unifies them into
one dataclass tree; every stage consumes the same object.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class BoardConfig:
    """Checkerboard target (reference defaults: intrinsic.py:452-467)."""

    cols: int = 7
    rows: int = 4
    square_mm: float = 100.0

    @property
    def size(self) -> tuple[int, int]:
        return (self.cols, self.rows)


@dataclasses.dataclass(frozen=True)
class FrameExtractionConfig:
    """Frame sampling (intrinsic.py defaults: interval 15, max 20, start 30)."""

    interval: int = 15
    max_frames: int = 20
    start_frame: int = 30


@dataclasses.dataclass(frozen=True)
class IntrinsicConfig:
    """Per-camera calibration (reference iPhone flags, intrinsic.py:282-285)."""

    rational_model: bool = True
    fix_k4: bool = True
    fix_k5: bool = True
    fix_k6: bool = True
    error_threshold_px: float = 1.0
    relative_threshold: float = 1.5
    max_drop_fraction: float = 0.2
    min_frames: int = 10


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Stereo calibration + gates (extrinsic.py:424-433, runner.py:45-106)."""

    fix_intrinsic: bool = True
    min_pairs: int = 5
    max_rms_warn: float = 0.5
    max_rms_fail: float = 1.0
    actual_baseline_mm: float | None = None


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """Flash sync (flash_sync.py defaults)."""

    threshold: float | None = None   # None = adaptive
    window_size: int = 5
    max_frames: int = 900
    post_flash_skip: int = 90        # 3dpose.py:313 seeks to flash + 90


@dataclasses.dataclass(frozen=True)
class DisparityConfig:
    """Dense matcher (BASELINE.json configs)."""

    matcher: str = "sgbm"            # "bm" | "sgbm"
    num_disparities: int = 128
    block_size: int = 5
    uniqueness_ratio: int = 10
    disp12_max_diff: int = 1
    speckle_window_size: int = 100
    speckle_range: int = 2


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Pose fusion + smoothing (3dpose.py:69-71, motion_smoothing presets)."""

    confidence_threshold: float = 0.65
    temporal_filter_weight: float = 0.7
    smooth_window: int = 5
    smoothing_preset: str = "smalliphone"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    board: BoardConfig = BoardConfig()
    frames: FrameExtractionConfig = FrameExtractionConfig()
    intrinsic: IntrinsicConfig = IntrinsicConfig()
    stereo: StereoConfig = StereoConfig()
    sync: SyncConfig = SyncConfig()
    disparity: DisparityConfig = DisparityConfig()
    track: TrackConfig = TrackConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        d = json.loads(text)

        def build(tp, sub: dict[str, Any]):
            return tp(**sub)

        return cls(
            board=build(BoardConfig, d.get("board", {})),
            frames=build(FrameExtractionConfig, d.get("frames", {})),
            intrinsic=build(IntrinsicConfig, d.get("intrinsic", {})),
            stereo=build(StereoConfig, d.get("stereo", {})),
            sync=build(SyncConfig, d.get("sync", {})),
            disparity=build(DisparityConfig, d.get("disparity", {})),
            track=build(TrackConfig, d.get("track", {})),
        )

    @classmethod
    def load(cls, path: str | Path) -> "PipelineConfig":
        return cls.from_json(Path(path).read_text())

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())
