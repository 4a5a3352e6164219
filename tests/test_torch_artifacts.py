"""The port's pipeline config and artifact store against the JAX package's,
on the CPU: the config's JSON equal both ways; every artifact file written
by each package read by the other (the same arrays, bit for bit: both write
numpy's text and pickles); the calibration XML written by the port read by
``cv2.FileStorage``, and the other way round, bit for bit, NaN and
infinities included; the CSV export equal byte for byte; the reference's
``calibration_results.pkl`` read alike.
"""

import pickle

import cv2
import numpy as np
import pytest
import torch

from stereo_vision_tpu.pipeline import artifacts as jartifacts
from stereo_vision_tpu.pipeline import config as jconfig
from stereo_vision_tpu_torch.pipeline import artifacts, config
from stereo_vision_tpu_torch.track.fusion import StereoRig


def _calibration(seed: int):
    rng = np.random.default_rng(seed)
    K = np.array([[1500.0 + rng.normal(), 0, 959.5 + rng.normal()], [0, 1499.0 + rng.normal(), 539.5], [0, 0, 1]])
    d = np.r_[rng.normal(0, 0.1, 5), 0.0, 0.0, 0.0]
    R = cv2.Rodrigues(rng.normal(0, 0.05, 3))[0]
    T = np.array([-100.0 + rng.normal(), rng.normal(), rng.normal()])
    return K, d, R, T, rng.normal(size=(3, 3)), rng.normal(size=(3, 3))


def test_config_json_matches_jax(tmp_path):
    cfg = config.PipelineConfig(board=config.BoardConfig(9, 6, 25.0), stereo=config.StereoConfig(
        actual_baseline_mm=120.5), sync=config.SyncConfig(threshold=12.5), disparity=config.DisparityConfig("bm"))
    jcfg = jconfig.PipelineConfig.from_json(cfg.to_json())
    assert jcfg.to_json() == cfg.to_json()
    assert config.PipelineConfig.from_json(jcfg.to_json()) == cfg
    assert config.PipelineConfig().to_json() == jconfig.PipelineConfig().to_json()
    cfg.save(tmp_path / "c.json")
    assert jconfig.PipelineConfig.load(tmp_path / "c.json").to_json() == cfg.to_json()
    assert config.PipelineConfig.from_json('{"board": {"cols": 5}}').board == config.BoardConfig(5, 4, 100.0)
    assert config.PipelineConfig().board.size == (7, 4)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_artifacts_read_by_the_other_package(tmp_path, writer):
    """Intrinsics (pkl and txt), extrinsics (pkl and txt), the rig,
    rectification and sync, each written by one package and read by both;
    the port also writes tensors."""
    K, d, R, T, E, F = _calibration(1)
    R1, R2 = np.eye(3), cv2.Rodrigues(np.array([0.01, 0.02, 0.0]))[0]
    P1, P2, Q = np.arange(12.0).reshape(3, 4), -np.arange(12.0).reshape(3, 4), np.diag([1.0, 1.0, 1500.0, 0.01])
    (Store, Other) = ((artifacts.ArtifactStore, jartifacts.ArtifactStore) if writer == "port"
                      else (jartifacts.ArtifactStore, artifacts.ArtifactStore))
    w = Store(tmp_path)
    put = (lambda a: torch.as_tensor(a)) if writer == "port" else (lambda a: a)
    w.save_intrinsics("left", put(K), put(d), rms=0.25)
    w.save_intrinsics("right", K * 1.01, d[::-1].copy())
    w.save_extrinsics(put(R), put(T), E=put(E), F=F)
    w.save_rectification(put(R1), R2, P1, put(P2), Q)
    w.save_sync(3, 7, 4)
    for store in (artifacts.ArtifactStore(tmp_path), jartifacts.ArtifactStore(tmp_path)):
        K1, d1 = store.load_intrinsics("left")
        np.testing.assert_array_equal(K1, K)
        np.testing.assert_array_equal(d1, d)
        R_, T_ = store.load_extrinsics()
        np.testing.assert_array_equal(R_, R)
        np.testing.assert_array_equal(T_, T.reshape(3, 1))
        for got, ref in zip(store.load_rectification(), (R1, R2, P1, P2, Q)):
            np.testing.assert_array_equal(got, ref)
        assert store.load_sync() == {"left_flash_frame": 3, "right_flash_frame": 7, "frame_offset": 4}
    rig = artifacts.ArtifactStore(tmp_path).load_rig()
    assert isinstance(rig, StereoRig)
    np.testing.assert_array_equal(rig.K2, K * 1.01)
    np.testing.assert_array_equal(rig.P2, Other(tmp_path).load_rig().P2)
    # the txt fall-backs, with the pickles gone
    for p in tmp_path.rglob("*.pkl"):
        p.unlink()
    for store in (artifacts.ArtifactStore(tmp_path), jartifacts.ArtifactStore(tmp_path)):
        np.testing.assert_allclose(store.load_intrinsics("left")[0], K, rtol=1e-15)
        np.testing.assert_allclose(store.load_extrinsics()[1], T.reshape(3, 1), rtol=1e-15)
        assert store.load_sync() is None
    other = tmp_path / "other"
    (Other(other)).save_intrinsics("left", K, d, rms=0.25)
    assert (other / "results/intrinsic_params/left_info.txt").read_text() == (
        tmp_path / "results/intrinsic_params/left_info.txt").read_text()


def test_artifact_files_equal_jax_byte_for_byte(tmp_path):
    """The same inputs give the same files, byte for byte, in both packages."""
    K, d, R, T, E, F = _calibration(2)
    for root, Store in ((tmp_path / "p", artifacts.ArtifactStore), (tmp_path / "j", jartifacts.ArtifactStore)):
        s = Store(root)
        s.save_intrinsics("left", K, d, rms=0.5)
        s.save_extrinsics(R, T, E, F)
        s.save_rectification(R, R.T, np.ones((3, 4)), np.zeros((3, 4)), np.eye(4))
        s.save_sync(-1, 5, 0)
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "p") for p in (tmp_path / "p").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def test_calibration_xml_both_ways_against_opencv(tmp_path):
    K1, d1, R, T, E, F = _calibration(3)
    K2, d2 = K1 * 0.999, -d1
    d1[3] = -0.0
    d2[:3] = [np.nan, np.inf, -np.inf]
    E[0, 0], F[1, 1] = 5e-324, 1e300
    # written by the port, read by cv2.FileStorage and by the port
    artifacts.save_calibration_xml(tmp_path / "p.xml", K1, torch.as_tensor(d1), K2, d2, R, T, E=E, F=F)
    fs = cv2.FileStorage(str(tmp_path / "p.xml"), cv2.FILE_STORAGE_READ)
    for key, ref in (("camera_matrix_1", K1), ("dist_coeffs_1", d1.reshape(1, -1)), ("camera_matrix_2", K2),
                     ("dist_coeffs_2", d2.reshape(1, -1)), ("R", R), ("T", T.reshape(3, 1)), ("E", E), ("F", F)):
        got = fs.getNode(key).mat()
        assert got.dtype == np.float64 and got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
        assert np.array_equal(np.signbit(got) | np.isnan(got), np.signbit(ref) | np.isnan(ref)), key  # -0.0 kept
    fs.release()
    mine, ref = artifacts.load_calibration_xml(tmp_path / "p.xml"), jartifacts.load_calibration_xml(tmp_path / "p.xml")
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    # written by the JAX package (cv2.FileStorage), read by the port
    jartifacts.save_calibration_xml(tmp_path / "j.xml", K1, d1, K2, d2, R, T, E=E)
    fs = cv2.FileStorage(str(tmp_path / "c.xml"), cv2.FILE_STORAGE_WRITE)
    fs.write("R", np.arange(6, dtype=np.float32).reshape(2, 3))
    fs.write("T", np.arange(3, dtype=np.int32).reshape(3, 1))
    fs.release()
    for a, b in zip(artifacts.load_calibration_xml(tmp_path / "j.xml"), jartifacts.load_calibration_xml(
            tmp_path / "j.xml")):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert artifacts.read_opencv_xml(tmp_path / "j.xml").keys() == {
        "camera_matrix_1", "dist_coeffs_1", "camera_matrix_2", "dist_coeffs_2", "R", "T", "E"}
    mixed = artifacts.load_calibration_xml(tmp_path / "c.xml")
    assert mixed[:4] == (None, None, None, None)
    assert mixed[4].dtype == np.float32 and mixed[5].dtype == np.int32
    np.testing.assert_array_equal(mixed[4], np.arange(6, dtype=np.float32).reshape(2, 3))
    with pytest.raises(ValueError, match="XML"):
        artifacts.save_calibration_xml(tmp_path / "p.yml", K1, d1, K2, d2, R, T)


def test_csv_and_reference_pickle_match_jax(tmp_path):
    K, d, *_ = _calibration(4)
    artifacts.save_calibration_csv(tmp_path / "p.csv", torch.as_tensor(K), d)
    jartifacts.save_calibration_csv(tmp_path / "j.csv", K, d)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    rng = np.random.default_rng(5)
    with open(tmp_path / "calibration_results.pkl", "wb") as f:
        pickle.dump({"camera_matrix": K, "dist_coeffs": d.reshape(1, -1), "rvecs": list(rng.normal(size=(3, 3, 1))),
                     "tvecs": list(rng.normal(size=(3, 3, 1))), "reprojection_error": 0.31}, f)
    for a, b in zip(artifacts.load_calibration_results_pkl(tmp_path / "calibration_results.pkl"),
                    jartifacts.load_calibration_results_pkl(tmp_path / "calibration_results.pkl")):
        np.testing.assert_array_equal(a, b)
