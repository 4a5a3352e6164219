"""Typed configs, artifact store (reference on-disk schema interop),
orchestrated stages with quality gates (SURVEY.md §7.8): the port of
``stereo_vision_tpu/pipeline``, with the same exports."""

from stereo_vision_tpu_torch.pipeline.config import (
    PipelineConfig,
    BoardConfig,
    FrameExtractionConfig,
    IntrinsicConfig,
    StereoConfig,
    SyncConfig,
    DisparityConfig,
    TrackConfig,
)
from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
from stereo_vision_tpu_torch.pipeline.aggregation import (
    collect_run_results,
    error_vs_distance_table,
    generate_validation_report,
    overall_metrics,
)
from stereo_vision_tpu_torch.pipeline.animations import (
    create_pose_comparison_video,
    create_rolling_animation,
    save_sync_visualizations,
    write_sync_report,
)
from stereo_vision_tpu_torch.pipeline.stages import (
    PipelineGateError,
    StageReport,
    run_intrinsic_stage,
    run_extrinsic_stage,
    run_rectification_stage,
    run_sync_stage,
)

__all__ = [
    "PipelineConfig",
    "BoardConfig",
    "FrameExtractionConfig",
    "IntrinsicConfig",
    "StereoConfig",
    "SyncConfig",
    "DisparityConfig",
    "TrackConfig",
    "ArtifactStore",
    "collect_run_results",
    "error_vs_distance_table",
    "generate_validation_report",
    "overall_metrics",
    "create_pose_comparison_video",
    "create_rolling_animation",
    "save_sync_visualizations",
    "write_sync_report",
    "PipelineGateError",
    "StageReport",
    "run_intrinsic_stage",
    "run_extrinsic_stage",
    "run_rectification_stage",
    "run_sync_stage",
]
