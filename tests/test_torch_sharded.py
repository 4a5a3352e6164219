"""The port's mesh shardings and row-band SGM (``parallel/mesh.py``,
``parallel/sgm_sharded.py``) against the JAX package's, on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``, the port on
``host_cpu_mesh`` (logical shards of the CPU). The shardings' specs and
``devices_indices_map`` are held to JAX's position by position; the
pipelined aggregation and the whole sharded SGBM bit for bit (every value
is an integer, disparities are k/16), on the scenes and parameters of
``tests/test_sgm_sharded.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vision_tpu.parallel import mesh as jmesh
from stereo_vision_tpu.parallel.sgm_sharded import sgm_aggregate_sharded as jagg
from stereo_vision_tpu.parallel.sgm_sharded import stereo_sgbm_sharded as jsgbm
from stereo_vision_tpu.stereo.sgbm import StereoSGBMParams as JParams
from stereo_vision_tpu_torch import convert
from stereo_vision_tpu_torch.parallel import mesh, sgm_sharded
from stereo_vision_tpu_torch.stereo import sgm_cuda
from stereo_vision_tpu_torch.stereo.sgbm import stereo_sgbm

P1, P2 = 200, 800


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the plain forms are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(n, n_space):
    return jmesh.host_cpu_mesh(n, n_space=n_space), mesh.host_cpu_mesh(n, n_space=n_space)


def test_host_cpu_mesh_and_shardings_match_jax():
    jm, m = _meshes(8, 2)
    assert m.devices.shape == jm.devices.shape == (4, 2) and m.axis_names == jm.axis_names
    assert m.shape == dict(jm.shape) and all(d == torch.device("cpu") for d in m.devices.flat)
    assert mesh.host_cpu_mesh(6, 4).devices.shape == jmesh.host_cpu_mesh(6, 4).devices.shape == (1, 4)
    for name in ("batch_sharding", "batch_rows_sharding", "replicated"):
        js, s = getattr(jmesh, name)(jm), getattr(mesh, name)(m)
        assert tuple(s.spec) == tuple(js.spec), name
        for shape in ((8, 48, 64), (4, 32)):
            jmap, tmap = js.devices_indices_map(shape), s.devices_indices_map(shape)
            assert set(tmap) == set(np.ndindex(4, 2))
            for pos in np.ndindex(4, 2):
                assert tmap[pos] == jmap[jm.devices[pos]], (name, shape, pos)
    with pytest.raises(ValueError, match="divisible"):
        mesh.batch_sharding(m).devices_indices_map((6, 3))
    both = mesh.NamedSharding(m, mesh.PartitionSpec(("data", "space")))
    jboth = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(("data", "space")))
    for pos, index in both.devices_indices_map((16, 3)).items():
        assert index == jboth.devices_indices_map((16, 3))[jm.devices[pos]]


def test_device_put_shards_and_gathers():
    _, m = _meshes(8, 2)
    x = np.arange(8 * 6 * 4, dtype=np.int32).reshape(8, 6, 4)
    for sharding in (mesh.batch_sharding(m), mesh.batch_rows_sharding(m), mesh.replicated(m)):
        st = mesh.device_put(x, sharding)
        assert isinstance(st, mesh.ShardedTensor) and st.shape == x.shape and st.dtype == torch.int32
        for pos, index in sharding.devices_indices_map(x.shape).items():
            assert np.array_equal(st.shards[pos].numpy(), x[index])
        assert np.array_equal(st.numpy(), x) and np.array_equal(np.asarray(st), x)
        assert mesh.device_put(st, sharding) is st
    # Replicated over "space": one tensor for the two positions of a data row on one device.
    st = mesh.device_put(x, mesh.batch_sharding(m))
    assert st.shards[(1, 0)] is st.shards[(1, 1)]
    assert np.array_equal(mesh.device_put(st, mesh.batch_rows_sharding(m)).shards[(3, 1)].numpy(), x[6:8, 3:6])
    one = mesh.host_cpu_mesh(1)
    t = mesh.device_put(x, mesh.batch_sharding(one))
    assert isinstance(t, torch.Tensor) and t.device == torch.device("cpu") and np.array_equal(t.numpy(), x)
    pieces = mesh.split_along(st, m, "data")
    assert [p.data_ptr() for p in pieces] == [st.shards[(i, 0)].data_ptr() for i in range(4)]
    with pytest.raises(ValueError, match="divisible"):
        mesh.split_along(x[:6], m, "data")


@pytest.mark.parametrize("num_paths", [8, 4, 3, 2])
@pytest.mark.parametrize("F", [1, 3])
def test_sharded_aggregation_matches_jax(num_paths, F):
    jm, m = _meshes(4, 4)
    rng = np.random.default_rng(42 + F)
    C = rng.integers(0, 3000, (F, 16, 24, 8)).astype(np.int32)
    ref = np.asarray(jagg(jnp.asarray(C), P1, P2, jm, num_paths=num_paths))
    ticks = sgm_sharded.aggregate_bands.band_ticks
    got = sgm_sharded.sgm_aggregate_sharded(C, P1, P2, m, num_paths=num_paths)
    assert got.dtype == torch.int32 and got.shape == C.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # Band s has work at ticks s .. s + F - 1 (down) and S-1-s .. S-2-s+F (up).
    assert sgm_sharded.aggregate_bands.band_ticks - ticks == sum(
        len(set(range(s, s + F)) | set(range(3 - s, 3 - s + F))) for s in range(4))
    for f in range(F):
        np.testing.assert_array_equal(got[f].numpy(), sgm_cuda._aggregate_8(torch.from_numpy(C[f:f + 1]), P1, P2,
                                                                             num_paths)[0].numpy())


@pytest.mark.parametrize("S", [2, 8])
def test_sharded_aggregation_other_band_counts_match_jax(S):
    jm, m = _meshes(S, S)
    rng = np.random.default_rng(S)
    C = rng.integers(0, 2000, (2, 16, 20, 6)).astype(np.int16)
    ref = np.asarray(jagg(jnp.asarray(C), P1, P2, jm))
    # A volume already split over the bands is taken shard by shard.
    Cs = mesh.device_put(C, mesh.NamedSharding(m, mesh.PartitionSpec(None, "space")))
    np.testing.assert_array_equal(sgm_sharded.sgm_aggregate_sharded(Cs, P1, P2, m).numpy(), ref)


def test_uneven_band_raises():
    _, m = _meshes(4, 4)
    with pytest.raises(ValueError, match="divisible"):
        sgm_sharded.sgm_aggregate_sharded(torch.zeros((1, 10, 8, 8), dtype=torch.int32), P1, P2, m)
    with pytest.raises(ValueError, match="num_paths"):
        sgm_sharded.sgm_aggregate_sharded(torch.zeros((1, 8, 8, 8), dtype=torch.int32), P1, P2, m, num_paths=5)


def _scene_pair(rng, F, H, W, max_disp):
    """tests/test_sgm_sharded.py's scenes: smoothed noise, a shift a frame."""
    pairs = []
    for _ in range(F):
        base = rng.uniform(0, 255, (H, W + max_disp)).astype(np.float32)
        for _ in range(2):
            base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1) + np.roll(base, 1, 0)
                    + np.roll(base, -1, 0)) / 5.0
        base = (base - base.min()) / (np.ptp(base) + 1e-9) * 255.0
        d = rng.integers(2, max_disp, ())
        pairs.append((base[:, max_disp - d:max_disp - d + W], base[:, max_disp:max_disp + W]))
    return tuple(np.clip(np.stack([p[i] for p in pairs]), 0, 255).astype(np.int32) for i in (0, 1))


def _sgbm_case(seed, F, H, W, D, **kw):
    l, r = _scene_pair(np.random.default_rng(seed), F, H, W, D - 2)
    jp = JParams(num_disparities=D, backend="scan", **kw)
    return l, r, jp, convert.sgbm_params_from_reference(jp)


@pytest.mark.parametrize("num_paths", [8, 4, 3])
def test_sharded_full_pipeline_matches_jax(num_paths):
    """stereo_sgbm_sharded on 4 bands against JAX's and against the
    port's per-frame stereo_sgbm: the halo, the border fix-ups, the
    pipelined aggregation, the band-local WTA / LR, the gathered speckle."""
    jm, m = _meshes(4, 4)
    l, r, jp, p = _sgbm_case(7, 3, 32, 48, 16, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                             speckle_window_size=50, speckle_range=2, num_paths=num_paths)
    ref = np.asarray(jsgbm(jnp.asarray(l), jnp.asarray(r), jp, jm))
    got = sgm_sharded.stereo_sgbm_sharded(l, r, p, m)
    assert got.dtype == torch.float32 and got.shape == l.shape and (ref > -1).mean() > 0.5
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), stereo_sgbm(torch.from_numpy(l), torch.from_numpy(r), p).numpy())


def test_sharded_full_pipeline_no_post_matches_jax():
    jm, m = _meshes(4, 4)
    l, r, jp, p = _sgbm_case(11, 2, 16, 40, 8, block_size=3, uniqueness_ratio=0, disp12_max_diff=-1,
                             speckle_window_size=0)
    ref = np.asarray(jsgbm(jnp.asarray(l), jnp.asarray(r), jp, jm))
    np.testing.assert_array_equal(sgm_sharded.stereo_sgbm_sharded(l, r, p, m).numpy(), ref)


def test_sharded_sgbm_refusals():
    _, m = _meshes(4, 4)
    l, r, _, p = _sgbm_case(3, 1, 16, 40, 8, block_size=9)
    with pytest.raises(ValueError, match="min_disparity"):
        sgm_sharded.stereo_sgbm_sharded(l, r, p._replace(min_disparity=2), m)
    with pytest.raises(ValueError, match="divisible"):
        sgm_sharded.stereo_sgbm_sharded(l[:, :14], r[:, :14], p, m)
    with pytest.raises(ValueError, match="block_size // 2 \\+ 1"):  # 4-row bands, block 9 reaches 5
        sgm_sharded.stereo_sgbm_sharded(l, r, p, m)
