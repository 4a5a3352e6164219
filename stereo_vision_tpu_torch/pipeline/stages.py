"""Orchestrated pipeline stages with quality gates.

Port of ``stereo_vision_tpu/pipeline/stages.py``. The reference's v4 runner
chains subprocesses with reprojection-error gates between stages
(reference: calibration_tests/calibrate_v4/runner.py:108-320, gates
:45-106). Here the stages are in-process functions over the typed config +
artifact store; gate failures raise ``PipelineGateError`` (the runner's
abort path) and warnings are collected in the stage report.

Each stage runs on ``device`` (None: the CUDA card; the CPU only where the
caller asks for it), and its tensors stay there until the artifact store
writes them.

Stage graph (mirrors the reference workflow, SURVEY.md §1):
  calibrate_intrinsics -> calibrate_extrinsics [gate] -> rectify
  -> synchronize -> analyze (disparity / pose / ball)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from stereo_vision_tpu_torch.calib import (
    CalibrationFlags,
    calibrate_camera,
    calibrate_stereo,
    check_intrinsic_quality,
    check_stereo_quality,
    checkerboard_object_points,
)
from stereo_vision_tpu_torch.calib.gates import GateStatus
from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops.rectify import init_undistort_rectify_map, stereo_rectify
from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
from stereo_vision_tpu_torch.pipeline.config import PipelineConfig
from stereo_vision_tpu_torch.sync.flash import synchronize_streams
from stereo_vision_tpu_torch.utils.profiling import StageTimer


class PipelineGateError(RuntimeError):
    """A quality gate failed (v4 runner abort semantics, runner.py:130-140)."""


@dataclasses.dataclass
class StageReport:
    name: str
    status: str
    metrics: dict[str, Any]
    warnings: list[str] = dataclasses.field(default_factory=list)


def _board(config: PipelineConfig, dev: torch.device) -> torch.Tensor:
    return checkerboard_object_points(config.board.cols, config.board.rows, config.board.square_mm, device=dev)


def run_intrinsic_stage(
    store: ArtifactStore,
    config: PipelineConfig,
    detections: dict[str, np.ndarray],
    image_size: tuple[int, int],
    device=None,
) -> list[StageReport]:
    """Per-camera intrinsic calibration + gate (stage 2 of the v4 runner).

    Args:
      detections: {"left": (F, N, 2), "right": (F, N, 2)} corner arrays.
      device: where the solves run (None: the CUDA card).
    """
    dev = resolve_device(device)
    obj = _board(config, dev)
    flags = CalibrationFlags(
        rational_model=config.intrinsic.rational_model,
        fix_k4=config.intrinsic.fix_k4,
        fix_k5=config.intrinsic.fix_k5,
        fix_k6=config.intrinsic.fix_k6,
    )
    reports = []
    for cam, corners in detections.items():
        timer = StageTimer()
        with timer("solve"):
            calib = calibrate_camera(
                obj,
                corners,
                image_size,
                flags=flags,
                error_threshold_px=config.intrinsic.error_threshold_px,
                relative_threshold=config.intrinsic.relative_threshold,
                max_drop_fraction=config.intrinsic.max_drop_fraction,
                min_frames=config.intrinsic.min_frames,
                device=dev,
            )
        status = check_intrinsic_quality(calib.rms, len(calib.kept_frames))
        if status == GateStatus.FAIL:
            raise PipelineGateError(
                f"intrinsic gate failed for {cam}: rms={calib.rms:.3f}px, "
                f"frames={len(calib.kept_frames)}"
            )
        store.save_intrinsics(cam, calib.K, calib.dist, calib.rms)
        rep = StageReport(
            name=f"intrinsic/{cam}",
            status=status.value,
            metrics={"rms_px": calib.rms, "frames": len(calib.kept_frames),
                     **timer.metrics},
        )
        if status == GateStatus.WARN:
            rep.warnings.append(f"rms {calib.rms:.3f}px > warn threshold")
        reports.append(rep)
    return reports


def run_extrinsic_stage(
    store: ArtifactStore,
    config: PipelineConfig,
    corners_left: np.ndarray,
    corners_right: np.ndarray,
    image_size: tuple[int, int] = (1920, 1080),
    device=None,
) -> StageReport:
    """Stereo calibration + gate + baseline check (v4 runner stage 3) on
    ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    obj = _board(config, dev)
    K1, d1 = store.load_intrinsics("left")
    K2, d2 = store.load_intrinsics("right")
    if corners_left.shape[0] < config.stereo.min_pairs:
        raise PipelineGateError(
            f"only {corners_left.shape[0]} stereo pairs (< {config.stereo.min_pairs})"
        )
    timer = StageTimer()
    with timer("solve"):
        calib = calibrate_stereo(
            obj, corners_left, corners_right, K1, d1, K2, d2, image_size, device=dev
        )
    baseline_err = None
    if config.stereo.actual_baseline_mm:
        baseline_err = (
            abs(calib.baseline - config.stereo.actual_baseline_mm)
            / config.stereo.actual_baseline_mm
            * 100.0
        )
    status = check_stereo_quality(calib.rms, corners_left.shape[0], baseline_err)
    if status == GateStatus.FAIL:
        raise PipelineGateError(f"stereo gate failed: rms={calib.rms:.3f}px")
    store.save_extrinsics(calib.R, calib.T, calib.E, calib.F)
    rep = StageReport(
        name="extrinsic",
        status=status.value,
        metrics={
            "rms_px": calib.rms,
            "baseline_mm": calib.baseline,
            "baseline_error_pct": baseline_err,
            **timer.metrics,
        },
    )
    if status == GateStatus.WARN:
        rep.warnings.append("stereo rms or baseline error above warn threshold")
    return rep


def run_rectification_stage(
    store: ArtifactStore,
    image_size: tuple[int, int],
    alpha: float = 0.0,
    device=None,
) -> StageReport:
    """Bouguet rectification + map generation on ``device`` (None: the CUDA
    card), persisted in the reference schema (checkerboard_distance.py:49-57
    semantics); the maps as ``maps.npy`` (4, H, W) float32."""
    dev = resolve_device(device)
    rig = store.load_rig()
    K1, d1, K2, d2, R, T = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                            for a in (rig.K1, rig.d1, rig.K2, rig.d2, rig.R, rig.T))
    timer = StageTimer()
    with timer("rectify"):
        R1, R2, P1, P2, Q = stereo_rectify(K1, d1, K2, d2, image_size, R, T, alpha=alpha)
    store.save_rectification(R1, R2, P1, P2, Q)
    with timer("maps", pixels=2 * image_size[0] * image_size[1]):
        mx1, my1 = init_undistort_rectify_map(K1, d1, R1, P1, image_size)
        mx2, my2 = init_undistort_rectify_map(K2, d2, R2, P2, image_size)
        maps = torch.stack([mx1, my1, mx2, my2])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    np.save(store.rectify_dir / "maps.npy", maps.cpu().numpy())
    return StageReport(
        name="rectify",
        status="pass",
        metrics={"Q_diag": [float(v) for v in torch.diagonal(Q).cpu()],
                 **timer.metrics},
    )


def run_sync_stage(
    store: ArtifactStore,
    config: PipelineConfig,
    left_frames: np.ndarray,
    right_frames: np.ndarray,
    device=None,
) -> StageReport:
    """Flash synchronization on ``device`` (None: the CUDA card) with the
    abort-on-no-flash rule (3dpose.py:288-290) softened to a warning +
    offset 0 fallback (ball_drop.py:73-74)."""
    dev = resolve_device(device)
    timer = StageTimer()
    with timer("sync", pixels=int(np.size(left_frames) + np.size(right_frames))):
        res = synchronize_streams(
            left_frames,
            right_frames,
            threshold=config.sync.threshold,
            window_size=config.sync.window_size,
            max_frames=config.sync.max_frames,
            device=dev,
        )
    warnings = []
    offset = res.offset
    if offset is None:
        warnings.append("no flash detected in one or both streams; offset=0 fallback")
        offset = 0
    store.save_sync(res.left_flash or -1, res.right_flash or -1, offset)
    return StageReport(
        name="sync",
        status="pass" if not warnings else "warn",
        metrics={
            "left_flash": res.left_flash,
            "right_flash": res.right_flash,
            "offset": offset,
            **timer.metrics,
        },
        warnings=warnings,
    )
