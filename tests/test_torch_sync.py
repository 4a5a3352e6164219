"""The port's stream synchronization (``stereo_vision_tpu_torch.sync``)
against the JAX package's ``sync`` modules, on the CPU.

Brightness series are float32 means on both sides, summed in another order:
rtol 1e-5. Flash indices, offsets and frame pairs are exact. The PSNR
matrix is float32 on both sides but the port's cross term is an exact
float64 product rounded once, where XLA sums float32 products: on frames
that differ (mse in the thousands) the PSNR agrees within 1e-3 dB. On
near-equal frames ``l2 + r2 - 2 cross`` cancels in float32 on both sides,
so there the offsets are held exactly and the mean PSNR within 0.05 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.sync import flash as jflash
from stereo_vision_tpu.sync import mapper as jmapper
from stereo_vision_tpu.sync import matching as jmatch
from stereo_vision_tpu_torch import sync
from stereo_vision_tpu_torch.sync import flash as tflash


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the plain forms are many small ops, and
    several test workers sharing the cores otherwise oversubscribe them
    (a test here ran ~80x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flash_video(T, H, W, flash_at, base=40.0, flash_level=200.0, noise=2.0, seed=0, rgb=False):
    """uint8 frames around ``base`` with a flash at ``flash_at`` (and 0.8 of
    it on the next frame), as tests/test_sync.py makes them."""
    rng = np.random.default_rng(seed)
    shape = (T, H, W, 3) if rgb else (T, H, W)
    frames = np.clip(base + rng.normal(0, noise, shape), 0, 255)
    if flash_at is not None:
        frames[flash_at] = flash_level
        frames[flash_at + 1] = flash_level * 0.8
    return frames.astype(np.uint8)


@pytest.mark.parametrize("rgb", [False, True])
def test_frame_brightness_matches_jax(rgb):
    frames = np.random.default_rng(1).integers(0, 256, (7, 48, 64, 3) if rgb else (7, 48, 64)).astype(np.uint8)
    ref = np.asarray(jflash.frame_brightness(jnp.asarray(frames)))
    mine = sync.frame_brightness(frames, device="cpu")
    assert mine.dtype == torch.float32 and mine.shape == (7,)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("level,spread,T", [(30.0, 0.0, 300), (30.0, 9.0, 300), (220.0, 0.0, 300),
                                            (220.0, 12.0, 300), (120.0, 8.0, 300), (120.0, 1.0, 300),
                                            (120.0, 8.0, 95), (120.0, 8.0, 91)])
def test_adaptive_flash_threshold_matches_jax(level, spread, T):
    """Dark (mean < 50), bright (> 200) and mid videos, 3 std above and
    below 15, and too few samples (the base threshold)."""
    b = (level + np.random.default_rng(T).normal(0, spread, T)).astype(np.float32)
    ref = float(jflash.adaptive_flash_threshold(jnp.asarray(b)))
    mine = tflash.adaptive_flash_threshold(torch.from_numpy(b))
    assert mine.dtype == torch.float32
    np.testing.assert_allclose(float(mine), ref, rtol=1e-5)
    assert float(tflash.adaptive_flash_threshold(torch.from_numpy(b), base_threshold=7.0, min_samples=40)) == float(
        jflash.adaptive_flash_threshold(jnp.asarray(b), base_threshold=7.0, min_samples=40))


@pytest.mark.parametrize("kw", [dict(), dict(threshold=60.0), dict(threshold=200.0), dict(max_frames=100),
                                dict(max_frames=160, window_size=9)])
@pytest.mark.parametrize("flash_at", [None, 3, 50, 150])
def test_detect_flash_matches_jax(kw, flash_at):
    frames = _flash_video(200, 16, 16, flash_at, seed=flash_at or 0)
    ref = jflash.detect_flash(frames, **kw)
    assert tflash.detect_flash(frames, **kw, device="cpu") == ref
    b = np.array(jflash.frame_brightness(jnp.asarray(frames)))  # a brightness series in
    assert tflash.detect_flash(torch.from_numpy(b), **kw) == jflash.detect_flash(b, **kw)
    if flash_at == 50 and not kw:
        assert ref == 50


@pytest.mark.parametrize("case", ["offset", "rgb", "right_missing", "fixed_threshold"])
def test_synchronize_streams_matches_jax(case):
    rgb = case == "rgb"
    left = _flash_video(120, 16, 16, 40, seed=1, rgb=rgb)
    right = _flash_video(120, 16, 16, None if case == "right_missing" else 47, seed=2, rgb=rgb)
    kw = dict(threshold=50.0) if case == "fixed_threshold" else {}
    ref = jflash.synchronize_streams(left, right, **kw)
    mine = sync.synchronize_streams(left, right, **kw, device="cpu")
    assert (mine.left_flash, mine.right_flash, mine.offset) == (ref.left_flash, ref.right_flash, ref.offset)
    np.testing.assert_allclose([mine.threshold_left, mine.threshold_right],
                               [ref.threshold_left, ref.threshold_right], rtol=1e-5)
    if case != "right_missing":
        assert mine.offset == 7
    assert sync.compute_sync_offset(3, None) is None and sync.compute_sync_offset(3, 10) == 7


def test_similarity_matrix_matches_jax():
    rng = np.random.default_rng(2)
    left = rng.integers(0, 256, (5, 48, 64)).astype(np.uint8)
    right = rng.integers(0, 256, (7, 48, 64)).astype(np.uint8)
    ref = np.asarray(jmatch.similarity_matrix(jnp.asarray(left), jnp.asarray(right)))
    mine = sync.similarity_matrix(left, right, device="cpu")
    assert mine.dtype == torch.float32 and mine.shape == (5, 7)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-3)
    for i, j in ((0, 0), (4, 6), (2, 3)):
        np.testing.assert_allclose(float(sync.frame_similarity(left[i], right[j], device="cpu")),
                                   float(jmatch.frame_similarity(jnp.asarray(left[i]), jnp.asarray(right[j]))),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(float(sync.frame_similarity(left[i], right[j], device="cpu")), mine[i, j],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("shift,noise", [(3, 3.0), (-5, 3.0), (0, 6.0)])
def test_find_best_offset_by_content_matches_jax(shift, noise):
    """A right stream ``shift`` frames behind the left one in content, each
    frame with its own noise (no two frames equal)."""
    rng = np.random.default_rng(abs(shift))
    base = rng.integers(20, 235, (50, 24, 32)).astype(np.float64)
    left = np.clip(base[10:40] + rng.normal(0, noise, (30, 24, 32)), 0, 255).astype(np.uint8)
    right = np.clip(base[10 + shift:40 + shift] + rng.normal(0, noise, (30, 24, 32)), 0, 255).astype(np.uint8)
    ref = jmatch.find_best_offset_by_content(left, right, search_window=8)
    mine = sync.find_best_offset_by_content(left, right, search_window=8, device="cpu")
    assert mine[0] == ref[0] == -shift
    assert isinstance(mine[1], float)
    assert abs(mine[1] - ref[1]) <= 0.05


@pytest.mark.parametrize("true_offset", [-4, 0, 6])
@pytest.mark.parametrize("jitter", [0.0, 0.004])
def test_timestamp_matching_matches_jax(true_offset, jitter):
    t = np.arange(60) / 30.0
    right = t + true_offset / 30.0 + np.random.default_rng(5).normal(0, jitter, 60)
    assert tflash.match_offset_by_timestamps(t, right) == jflash.match_offset_by_timestamps(t, right)
    assert tflash.match_offset_by_timestamps(t, right, search=3, probe=4) == jflash.match_offset_by_timestamps(
        t, right, search=3, probe=4)
    for max_dt in (0.01, 0.003):
        assert (sync.match_frames_by_timestamp(t, right, max_time_diff=max_dt)
                == jmatch.match_frames_by_timestamp(t, right, max_time_diff=max_dt))


def test_timestamp_matching_identity_fallback_matches_jax():
    """No aligned pair within max_time_diff: identity pairs over the shorter stream."""
    left, right = np.arange(12) / 30.0, np.arange(9) / 30.0 + 5.0
    mine = sync.match_frames_by_timestamp(left, right, max_time_diff=0.01)
    assert mine == jmatch.match_frames_by_timestamp(left, right, max_time_diff=0.01)
    assert mine == [(i, i) for i in range(9)]


@pytest.mark.parametrize("offset,left_count,right_count", [(3, 100, 90), (-4, None, 50), (0, 20, None),
                                                            (7, None, None)])
def test_frame_mapper_files_cross_load(tmp_path, offset, left_count, right_count):
    ref = jmapper.StereoFrameMapper(offset, left_count, right_count)
    mine = sync.StereoFrameMapper(offset, left_count, right_count)
    ref.save(tmp_path / "jax.json")
    mine.save(tmp_path / "port.json")
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "port.json").read_text()
    loaded, back = sync.StereoFrameMapper.load(tmp_path / "jax.json"), jmapper.StereoFrameMapper.load(
        tmp_path / "port.json")
    for m in (mine, loaded):
        assert (m.offset, m.left_count, m.right_count) == (back.offset, back.left_count, back.right_count)
        assert m.valid_range() == ref.valid_range()
        assert list(m.pairs()) == list(ref.pairs())
        for i in (-10, -1, 0, 5, 49, 89, 95, 120):
            assert m.left_to_right(i) == ref.left_to_right(i)
            assert m.right_to_left(i) == ref.right_to_left(i)


def test_sync_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = _flash_video(30, 8, 8, 10)
    for call in (lambda: sync.frame_brightness(frames), lambda: sync.detect_flash(frames),
                 lambda: sync.synchronize_streams(frames, frames), lambda: sync.similarity_matrix(frames, frames),
                 lambda: sync.find_best_offset_by_content(frames, frames)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
