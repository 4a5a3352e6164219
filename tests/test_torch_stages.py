"""The port's pipeline stages (``pipeline/stages.py``) against the JAX
package's ``run_*_stage``, on the CPU.

One JAX run of each stage (module-scoped: each costs seconds of compile
here) on a synthetic 640x400 rig: a 7x4 board of 100 mm squares seen in 12
views by both cameras (``synth.boards.board_views``, 0.1 px noise), the
right camera 100 mm to the right, a flash pair for the sync. The port runs
the same stages from the same inputs at ``device="cpu"``. Tolerances, those
of ``tests/test_torch_calib.py`` (float64 on both sides, sums in other
orders): intrinsics and extrinsics within rtol 1e-5 / atol 1e-6, the RMS
within rtol 1e-6, the frame counts and gate statuses equal; rectification
within rtol 1e-9 / atol 1e-9 and its maps within 1e-3 px
(``tests/test_torch_geometry.py``); the sync stage's metrics and pickle
equal. The gates pass and fail as ``tests/test_pipeline.py::TestStages``'s
on the same inputs.
"""

import shutil

import numpy as np
import pytest
import torch

from stereo_vision_tpu.pipeline import artifacts as jartifacts
from stereo_vision_tpu.pipeline import stages as jstages
from stereo_vision_tpu_torch.pipeline import ArtifactStore, PipelineConfig, PipelineGateError, stages
from stereo_vision_tpu_torch.pipeline.config import IntrinsicConfig
from stereo_vision_tpu_torch.synth.boards import board_views

CPU = "cpu"
SIZE = (640, 400)
K = np.array([[520.0, 0, 319.5], [0, 520.0, 199.5], [0, 0, 1]])
DIST = np.array([-0.05, 0.01, 0.0, 0.0, 0.0])


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flash_pair():
    rng = np.random.default_rng(0)
    left = np.clip(40 + rng.normal(0, 2, (80, 12, 12)), 0, 255).astype(np.uint8)
    right = left.copy()
    left[30] = 200
    right[35] = 200
    return left, right


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's four stages on the rig, in one store."""
    root = tmp_path_factory.mktemp("jax")
    _, c1, c2 = board_views(12, 5, K, DIST, SIZE, K, DIST, np.eye(3), np.array([-100.0, 0, 0]), cols=7, rows=4,
                            depth=(1200.0, 2200.0), margin=15.0)
    cfg = PipelineConfig()
    store = jartifacts.ArtifactStore(root)
    intr = jstages.run_intrinsic_stage(store, cfg, {"left": c1, "right": c2}, SIZE)
    extr = jstages.run_extrinsic_stage(store, cfg, c1, c2, SIZE)
    rect = jstages.run_rectification_stage(store, SIZE)
    sync = jstages.run_sync_stage(store, cfg, *_flash_pair())
    return dict(root=root, c1=c1, c2=c2, intr=intr, extr=extr, rect=rect, sync=sync)


def _same_metrics(mine, ref, rtol):
    assert mine.name == ref.name and mine.status == ref.status and mine.warnings == ref.warnings
    assert sorted(mine.metrics) == sorted(ref.metrics)
    for k, v in ref.metrics.items():
        if v is None:
            assert mine.metrics[k] is None, k
        elif not k.endswith(("_ms", "_mpx_per_s")):
            np.testing.assert_allclose(mine.metrics[k], v, rtol=rtol, err_msg=k)


def test_intrinsic_and_extrinsic_stages_match_jax(jax_run, tmp_path):
    cfg = PipelineConfig()
    store = ArtifactStore(tmp_path)
    reps = stages.run_intrinsic_stage(store, cfg, {"left": jax_run["c1"], "right": jax_run["c2"]}, SIZE, device=CPU)
    for mine, ref in zip(reps, jax_run["intr"]):
        _same_metrics(mine, ref, 1e-6)
    jstore = jartifacts.ArtifactStore(jax_run["root"])
    for cam in ("left", "right"):
        for a, b in zip(store.load_intrinsics(cam), jstore.load_intrinsics(cam)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # the extrinsic stage from the JAX package's intrinsics, so that both solve the same problem
    shutil.copytree(jstore.intrinsic_dir, store.intrinsic_dir, dirs_exist_ok=True)
    rep = stages.run_extrinsic_stage(store, cfg, jax_run["c1"], jax_run["c2"], SIZE, device=CPU)
    _same_metrics(rep, jax_run["extr"], 1e-6)
    for a, b in zip(store.load_extrinsics(), jstore.load_extrinsics()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for name in ("essential_matrix.txt", "fundamental_matrix.txt"):
        np.testing.assert_allclose(np.loadtxt(store.extrinsic_dir / name), np.loadtxt(jstore.extrinsic_dir / name),
                                   rtol=1e-5, atol=1e-9)


def test_rectification_stage_matches_jax(jax_run, tmp_path):
    store = ArtifactStore(tmp_path)
    jstore = jartifacts.ArtifactStore(jax_run["root"])
    for d in (jstore.intrinsic_dir, jstore.extrinsic_dir):
        shutil.copytree(d, tmp_path / d.relative_to(jax_run["root"]))
    rep = stages.run_rectification_stage(store, SIZE, device=CPU)
    _same_metrics(rep, jax_run["rect"], 1e-9)
    for a, b in zip(store.load_rectification(), jstore.load_rectification()):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    maps, jmaps = np.load(store.rectify_dir / "maps.npy"), np.load(jstore.rectify_dir / "maps.npy")
    assert maps.shape == jmaps.shape == (4, SIZE[1], SIZE[0]) and maps.dtype == jmaps.dtype == np.float32
    assert np.abs(maps - jmaps).max() < 1e-3


def test_sync_stage_matches_jax(jax_run, tmp_path):
    store = ArtifactStore(tmp_path)
    rep = stages.run_sync_stage(store, PipelineConfig(), *_flash_pair(), device=CPU)
    _same_metrics(rep, jax_run["sync"], 0)
    assert rep.metrics["offset"] == 5 and rep.metrics["sync_ms"] > 0
    assert store.load_sync() == jartifacts.ArtifactStore(jax_run["root"]).load_sync()
    # no flash: a warning and offset 0, as the reference
    flat = np.full((20, 8, 8), 40, np.uint8)
    rep, jrep = (f(s, PipelineConfig(), flat, flat, **kw) for f, s, kw in (
        (stages.run_sync_stage, ArtifactStore(tmp_path / "p"), {"device": CPU}),
        (jstages.run_sync_stage, jartifacts.ArtifactStore(tmp_path / "j"), {})))
    _same_metrics(rep, jrep, 0)
    assert rep.status == "warn" and rep.metrics["offset"] == 0
    assert ArtifactStore(tmp_path / "p").load_sync() == jartifacts.ArtifactStore(tmp_path / "j").load_sync()


def test_gates_pass_and_fail_as_the_reference(tmp_path):
    """tests/test_pipeline.py::TestStages's inputs: the rectification stage
    passes on a parallel 1280x720 rig, the extrinsic gate fails on junk
    corners; too few views fail the intrinsic gate, too few pairs the
    extrinsic one."""
    store = ArtifactStore(tmp_path)
    Kc = np.array([[1000.0, 0, 640], [0, 1000, 360], [0, 0, 1]])
    store.save_intrinsics("left", Kc, np.zeros(8))
    store.save_intrinsics("right", Kc, np.zeros(8))
    store.save_extrinsics(np.eye(3), np.array([-500.0, 0, 0]))
    rep = stages.run_rectification_stage(store, (1280, 720), device=CPU)
    assert rep.status == "pass" and rep.metrics["rectify_ms"] > 0 and rep.metrics["maps_mpx_per_s"] > 0
    R1, R2, P1, P2, Q = store.load_rectification()
    assert R1.shape == (3, 3) and Q.shape == (4, 4)
    rng = np.random.default_rng(1)
    junk = rng.uniform(0, 1000, (6, 28, 2))
    with pytest.raises(PipelineGateError, match="stereo gate failed"):
        stages.run_extrinsic_stage(store, PipelineConfig(), junk, junk + rng.uniform(0, 50, junk.shape), device=CPU)
    with pytest.raises(PipelineGateError, match="stereo pairs"):
        stages.run_extrinsic_stage(store, PipelineConfig(), junk[:4], junk[:4], device=CPU)
    _, c1 = board_views(6, 2, K, DIST, SIZE, cols=7, rows=4, depth=(1200.0, 2200.0), margin=15.0)
    with pytest.raises(PipelineGateError, match="intrinsic gate failed for left"):
        stages.run_intrinsic_stage(store, PipelineConfig(intrinsic=IntrinsicConfig(min_frames=5)), {"left": c1},
                                   SIZE, device=CPU)


def test_stages_default_to_the_card(monkeypatch):
    """device=None is the CUDA card: without one each stage raises, never
    runs on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: stages.run_sync_stage(ArtifactStore("unused"), PipelineConfig(), *_flash_pair()),
                 lambda: stages.run_rectification_stage(ArtifactStore("unused"), SIZE)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
