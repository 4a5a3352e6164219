"""The port's ``make_sharded_pipeline`` and ``StereoStreamProcessor``
(``stereo_vision_tpu_torch.parallel``) on 1x1 and larger meshes, on the CPU.

The closure and the processor run ``batched_stereo_pipeline`` on each data
device's frames with the maps and Q moved there once, so their outputs must
equal the batched pipeline's bit for bit, for every matcher. For ``sgbm``
and ``bm`` the JAX package's ``make_sharded_pipeline`` on a CPU mesh of the
same shape (the virtual devices of tests/conftest.py; the port's on
``host_cpu_mesh``) is the reference too: disparity exact, points within
float32 rtol 1e-6 (as tests/test_torch_pipeline.py holds the batched
pipeline). JAX's hier under ``shard_map`` in interpret mode takes about a
minute a call, so the hier closure is held to the port's batched pipeline
only (which tests/test_torch_hier.py holds to JAX), pack by pack.
"""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.parallel import mesh as jmesh
from stereo_vision_tpu.parallel import streaming as jstream
from stereo_vision_tpu.stereo.bm import StereoBMParams as JBMParams
from stereo_vision_tpu.stereo.sgbm import StereoSGBMParams as JSGBMParams
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.parallel import mesh, streaming
from stereo_vision_tpu_torch.stereo.bm import StereoBMParams
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams
from stereo_vision_tpu_torch.synth.scenes import scene

H, W = 48, 192
_JP = {"sgbm": JSGBMParams(num_disparities=96, block_size=3, uniqueness_ratio=10, disp12_max_diff=1,
                           speckle_window_size=15, speckle_range=2, backend="scan"),
       "bm": JBMParams(num_disparities=96, block_size=9, uniqueness_ratio=5, texture_threshold=5, backend="xla")}
# The hier batch rule: 8 frames at band 16 (HIER_FAST), D = 128, 3 paths.
HIER_PARAMS = StereoSGBMParams(num_disparities=128, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                               speckle_window_size=30, speckle_range=2, num_paths=3)
HIER_FRAMES = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the plain forms are many small ops, and
    several test workers sharing the cores otherwise oversubscribe them
    (a test here ran ~80x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(matcher):
    if matcher == "sgbm_hier":
        return HIER_PARAMS
    conv = convert.bm_params_from_reference if matcher == "bm" else convert.sgbm_params_from_reference
    return conv(_JP[matcher])


def _rig():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = (xx + 0.35 * np.sin(yy / 4.0), yy + 0.3 * np.cos(xx / 6.0) - 0.2,
            xx + 0.25 * np.sin(yy / 5.0) + 0.1, yy + 0.3 * np.cos(xx / 6.0) - 0.2)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 400.0], [0, 0, 12.5, 0]], np.float32)
    return tuple(m.astype(np.float32) for m in maps), Q


def _frames(n, seed0=0):
    """n uint8 (left, right) frames of the ramp+box scene."""
    frames = [scene(seed=seed0 + s, H=H, W=W) for s in range(n)]
    return tuple(np.stack([f[i] for f in frames]).astype(np.uint8) for i in (0, 1))


def _cpu_mesh():
    return mesh.create_mesh(devices=[torch.device("cpu")])


def test_create_mesh():
    m = _cpu_mesh()
    assert m.axis_names == (mesh.DATA_AXIS, mesh.SPACE_AXIS) == ("data", "space")
    assert m.devices.shape == (1, 1) and m.devices[0, 0] == torch.device("cpu")
    assert m.shape == {"data": 1, "space": 1} and m.size == 1
    m2 = mesh.create_mesh(n_space=2, devices=["cpu"] * 4)
    assert m2.devices.shape == (2, 2) and m2.shape == {"data": 2, "space": 2}
    assert mesh.create_mesh(1, 2, devices=["cpu"] * 3).devices.shape == (1, 2)
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        mesh.create_mesh(2, 2, devices=["cpu"] * 3)


@pytest.mark.parametrize("matcher", ["sgbm", "bm", "sgbm_hier"])
@pytest.mark.parametrize("stats_only", [False, True])
def test_sharded_pipeline_equals_batched_pipeline(matcher, stats_only):
    maps, Q = _rig()
    n = HIER_FRAMES if matcher == "sgbm_hier" else 2
    left, right = _frames(n)
    params = _params(matcher)
    run = streaming.make_sharded_pipeline(_cpu_mesh(), maps, Q, matcher, params, stats_only=stats_only)
    out = run(left, right)
    ref = streaming.batched_stereo_pipeline(left, right, maps, Q, matcher, params, stats_only=stats_only,
                                            device="cpu")
    outs, refs = (out, ref) if not stats_only else ((out,), (ref,))
    for a, b in zip(outs, refs):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert torch.equal(a, b) if not a.isnan().any() else torch.equal(a.nan_to_num(), b.nan_to_num())
    if not stats_only:
        assert out[0].shape == (n, H, W) and (out[0] > -1).float().mean() > 0.2
        # The tensors of a second call: the closure's maps were moved once.
        out2 = run(torch.from_numpy(left), torch.from_numpy(right))
        assert torch.equal(out2[0], out[0])


def test_sharded_pipeline_moves_maps_once(monkeypatch):
    """The maps and Q are converted when the closure is made, not per call."""
    maps, Q = _rig()
    calls = []
    real = streaming._to
    monkeypatch.setattr(streaming, "_to", lambda a, d, t: calls.append(type(a)) or real(a, d, t))
    run = streaming.make_sharded_pipeline(_cpu_mesh(), maps, Q, "sgbm", _params("sgbm"))
    assert calls == [np.ndarray] * 5
    calls.clear()
    left, right = _frames(2)
    run(left, right)
    run(left, right)
    # Per call: the two frame stacks from numpy; the five tensors already on the device.
    assert calls.count(np.ndarray) == 4 and calls.count(torch.Tensor) == 10


@pytest.mark.parametrize("matcher", ["sgbm", "bm"])
def test_sharded_pipeline_matches_jax(matcher):
    maps, Q = _rig()
    left, right = _frames(2, seed0=3)
    jm = jmesh.create_mesh(1, 1, devices=jax.devices("cpu")[:1])
    jrun = jstream.make_sharded_pipeline(jm, tuple(jnp.asarray(m) for m in maps), jnp.asarray(Q), matcher,
                                         _JP[matcher])
    jd, jp = jrun(jnp.asarray(left), jnp.asarray(right))
    td, tp = streaming.make_sharded_pipeline(_cpu_mesh(), maps, Q, matcher, _params(matcher))(left, right)
    assert (np.asarray(jd) > -1).mean() > 0.1
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    jstats = jstream.make_sharded_pipeline(jm, tuple(jnp.asarray(m) for m in maps), jnp.asarray(Q), matcher,
                                           _JP[matcher], stats_only=True)(jnp.asarray(left), jnp.asarray(right))
    tstats = streaming.make_sharded_pipeline(_cpu_mesh(), maps, Q, matcher, _params(matcher), stats_only=True)(
        left, right)
    np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats), rtol=1e-6)


def test_processor_contract():
    """drain with nothing pending is None; two submits then drain return the
    second window (the first was waited on and dropped); a caller's array
    rewritten after submit does not change the result; a drained processor
    is empty again."""
    maps, Q = _rig()
    params = _params("sgbm")
    proc = streaming.StereoStreamProcessor(_cpu_mesh(), maps, Q, "sgbm", params)
    assert proc.drain() is None
    w1, w2 = _frames(2, seed0=0), _frames(2, seed0=5)
    ref2 = streaming.batched_stereo_pipeline(*w2, maps, Q, "sgbm", params, device="cpu")
    proc.submit(*w1)
    left, right = w2[0].copy(), w2[1].copy()
    proc.submit(left, right)
    left[:] = 0
    right[:] = 255
    disp, pts = proc.drain()
    assert isinstance(disp, np.ndarray) and isinstance(pts, np.ndarray)
    np.testing.assert_array_equal(disp, ref2[0].numpy())
    np.testing.assert_array_equal(pts, ref2[1].numpy())
    assert proc.drain() is None
    # Tensors in: the processor copies them too.
    lt, rt = torch.from_numpy(w1[0].copy()), torch.from_numpy(w1[1].copy())
    proc.submit(lt, rt)
    lt.zero_()
    np.testing.assert_array_equal(proc.drain()[0],
                                  streaming.batched_stereo_pipeline(*w1, maps, Q, "sgbm", params, device="cpu")[0])


def test_processor_hier_window_equals_batched_pipeline():
    maps, Q = _rig()
    left, right = _frames(HIER_FRAMES)
    proc = streaming.StereoStreamProcessor(_cpu_mesh(), maps, Q, "sgbm_hier", HIER_PARAMS)
    proc.submit(left, right)
    disp, pts = proc.drain()
    ref = streaming.batched_stereo_pipeline(left, right, maps, Q, "sgbm_hier", HIER_PARAMS, device="cpu")
    np.testing.assert_array_equal(disp, ref[0].numpy())
    np.testing.assert_array_equal(pts, ref[1].numpy())


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("matcher", ["sgbm", "bm"])
def test_sharded_pipeline_on_a_mesh_matches_jax(matcher, shape):
    """Frames split over ``data`` (4 on a 4x1 mesh: one a device; 2x2: two
    a data device, ``space`` unused), gathered on the first device."""
    maps, Q = _rig()
    left, right = _frames(4, seed0=3)
    n_data, n_space = shape
    jm = jmesh.create_mesh(n_data, n_space, devices=jax.devices("cpu")[:4])
    jmaps = tuple(jnp.asarray(m) for m in maps)
    jd, jp = jstream.make_sharded_pipeline(jm, jmaps, jnp.asarray(Q), matcher, _JP[matcher])(
        jnp.asarray(left), jnp.asarray(right))
    m = mesh.host_cpu_mesh(4, n_space)
    td, tp = streaming.make_sharded_pipeline(m, maps, Q, matcher, _params(matcher))(left, right)
    assert td.shape == (4, H, W) and tp.shape == (4, H, W, 3) and (np.asarray(jd) > -1).mean() > 0.1
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    if shape == (4, 1):
        jstats = jstream.make_sharded_pipeline(jm, jmaps, jnp.asarray(Q), matcher, _JP[matcher], stats_only=True)(
            jnp.asarray(left), jnp.asarray(right))
        tstats = streaming.make_sharded_pipeline(m, maps, Q, matcher, _params(matcher), stats_only=True)(left, right)
        assert tstats.shape == (4, 2)
        np.testing.assert_allclose(tstats.numpy(), np.asarray(jstats), rtol=1e-6)


def test_sharded_hier_pipeline_runs_a_pack_a_device():
    """sgbm_hier on a 2x1 mesh, 16 frames given as ``put_batch`` shards:
    each device runs one HIER_FAST pack of 8, equal to the batched pipeline
    on those frames."""
    from stereo_vision_tpu_torch.models import put_batch

    maps, Q = _rig()
    left, right = _frames(2 * HIER_FRAMES)
    m = mesh.host_cpu_mesh(2)
    lt, rt = put_batch(m, left), put_batch(m, right)
    assert isinstance(lt, mesh.ShardedTensor)
    disp, pts = streaming.make_sharded_pipeline(m, maps, Q, "sgbm_hier", HIER_PARAMS)(lt, rt)
    assert disp.shape == (2 * HIER_FRAMES, H, W)
    for i in range(2):
        s = slice(i * HIER_FRAMES, (i + 1) * HIER_FRAMES)
        ref = streaming.batched_stereo_pipeline(left[s], right[s], maps, Q, "sgbm_hier", HIER_PARAMS, device="cpu")
        assert torch.equal(disp[s], ref[0]) and torch.equal(pts[s], ref[1]), f"pack {i}"


def test_sharded_pipeline_refuses_frames_the_data_axis_does_not_divide(monkeypatch):
    maps, Q = _rig()
    left, right = _frames(3)
    run = streaming.make_sharded_pipeline(mesh.host_cpu_mesh(2), maps, Q, "sgbm", _params("sgbm"))
    monkeypatch.setattr(streaming, "batched_stereo_pipeline", lambda *a, **k: pytest.fail("work started"))
    with pytest.raises(ValueError, match="divisible"):
        run(left, right)
    proc = streaming.StereoStreamProcessor(mesh.host_cpu_mesh(2), maps, Q, "sgbm", _params("sgbm"))
    with pytest.raises(ValueError, match="divisible"):
        proc.submit(left, right)


def test_processor_contract_on_four_devices():
    """The processor's contract on a 4x1 mesh: each window split a frame a
    device, drained whole in frame order."""
    maps, Q = _rig()
    params = _params("sgbm")
    proc = streaming.StereoStreamProcessor(mesh.host_cpu_mesh(4), maps, Q, "sgbm", params)
    assert proc.drain() is None and proc.devices == [torch.device("cpu")] * 4
    w1, w2 = _frames(4, seed0=0), _frames(4, seed0=5)
    ref2 = streaming.batched_stereo_pipeline(*w2, maps, Q, "sgbm", params, device="cpu")
    proc.submit(*w1)
    left, right = w2[0].copy(), w2[1].copy()
    proc.submit(left, right)
    left[:] = 0
    right[:] = 255
    disp, pts = proc.drain()
    assert isinstance(disp, np.ndarray) and disp.shape == (4, H, W) and pts.shape == (4, H, W, 3)
    np.testing.assert_array_equal(disp, ref2[0].numpy())
    np.testing.assert_array_equal(pts, ref2[1].numpy())
    assert proc.drain() is None


def test_matcher_and_params_are_checked_before_any_work(monkeypatch):
    maps, Q = _rig()
    monkeypatch.setattr(streaming, "_to", lambda *a: pytest.fail("work started on a refused matcher"))
    with pytest.raises(ValueError, match="unknown matcher"):
        streaming.make_sharded_pipeline(_cpu_mesh(), maps, Q, "census")
    with pytest.raises(TypeError, match="StereoBMParams"):
        streaming.StereoStreamProcessor(_cpu_mesh(), maps, Q, "bm", StereoSGBMParams())
    with pytest.raises(TypeError, match="StereoSGBMParams"):
        streaming.make_sharded_pipeline(_cpu_mesh(), maps, Q, "sgbm", StereoBMParams())


def test_mesh_and_processor_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    maps, Q = _rig()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.create_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.StereoStreamProcessor(mesh.create_mesh(devices=[None]), maps, Q)


def test_stream_video_pair_records_its_spans(tmp_path):
    """``stream_video_pair`` on the CPU with a recording open: for each
    window one ``loader.get`` a clip, one ``stream.launch`` and one
    ``stream.card_wait`` on the consumer's thread, a ``loader.read`` a frame
    and a ``loader.put`` a window on each clip's decode thread, one
    ``stream.open`` and one ``stream.close``; the ring's counters count the
    gets and puts; the outputs are bit-equal to a run with recording off."""
    from stereo_vision_tpu_torch.io.video import VideoSink
    from stereo_vision_tpu_torch.utils import profiling

    n, window = 10, 4
    paths = []
    for name, frames in zip(("l", "r"), _frames(n)):
        sink = VideoSink(tmp_path / f"{name}.avi", is_rgb=False)
        for f in frames:
            sink.append(f)
        sink.close()
        paths.append(tmp_path / f"{name}.avi")
    maps, Q = _rig()

    def run():
        return list(streaming.stream_video_pair(*paths, _cpu_mesh(), maps, Q, "sgbm", _params("sgbm"),
                                                window=window, stats_only=True))

    off = run()
    before = profiling.counters()
    with profiling.recording() as spans:
        on = run()
    after = profiling.counters()
    assert [(s, k) for s, *_, k in on] == [(s, k) for s, *_, k in off] == [(0, 4), (1, 4), (2, 2)]
    for (_, a, _, _), (_, b, _, _) in zip(on, off):
        np.testing.assert_array_equal(a, b)
    me = threading.get_ident()
    count = collections.Counter((s.name, s.seq, s.clip) for s in spans)
    for seq in range(3):
        for clip in ("left", "right"):
            assert count["loader.get", seq, clip] == 1
            assert count["loader.put", seq, clip] == 1
            assert count["loader.read", seq, clip] == (4 if seq < 2 else 2)
        assert count["stream.launch", seq, None] == count["stream.card_wait", seq, None] == 1
    assert count["stream.open", None, None] == count["stream.close", None, None] == 1
    assert {s.thread for s in spans if s.name.startswith("stream.")} == {me}
    assert {s.thread for s in spans if s.name == "loader.get"} == {me}
    decode = {c: {s.thread for s in spans if s.name in ("loader.read", "loader.put") and s.clip == c}
              for c in ("left", "right")}
    assert all(len(t) == 1 and me not in t for t in decode.values())  # a thread's ident may be reused
    gets = sum(count[k] for k in count if k[0] == "loader.get")
    assert after["ring.gets"] - before["ring.gets"] >= gets  # the totals are the process's
    assert after["ring.puts"] - before["ring.puts"] >= 6
