"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Every test here needs an NVIDIA GPU with nvcc (they skip elsewhere); the
file imports neither JAX nor the JAX package, so on a machine without
them it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Exact equality throughout: every value is an integer (disparities are
k/16).
"""

import numpy as np
import pytest
import torch

from stereo_vision_tpu_torch.parallel.streaming import batched_stereo_pipeline
from stereo_vision_tpu_torch.stereo import cost_cuda, sgm_cuda
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams
from stereo_vision_tpu_torch.synth.scenes import scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (B, H, W)).astype(np.int32)) for _ in range(2))


@pytest.mark.parametrize(
    "H,W,D,bs,mindisp,x_off",
    [(21, 80, 16, 5, 0, 16), (17, 70, 48, 3, 2, 50), (9, 300, 128, 11, 0, 128), (12, 100, 200, 7, 1, 0)],
)
def test_cost_kernel_matches_plain(dev, H, W, D, bs, mindisp, x_off):
    left, right = _images(D, 2, H, W)
    kw = dict(ndisp=D, mindisp=mindisp, block_size=bs, ftzero=15, x_offset=x_off)
    ref = cost_cuda.cost_volume_plain(left, right, **kw)
    n = cost_cuda.cost_volume.launches
    out = cost_cuda.cost_volume(left.to(dev), right.to(dev), **kw)
    torch.cuda.synchronize()
    assert cost_cuda.cost_volume.launches == n + 1
    assert out.dtype == torch.int16 and out.shape == ref.shape
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("D", [16, 48, 64, 128, 200])
@pytest.mark.parametrize("num_paths,uniq", [(8, 10), (4, 0), (3, 10), (2, 0)])
def test_sgm_kernels_match_plain(dev, D, num_paths, uniq):
    rng = np.random.default_rng(D + num_paths)
    C = torch.from_numpy(rng.integers(0, 2326, (2, 13, 37, D)).astype(np.int16))
    P1, P2 = 200, 800
    ref = sgm_cuda.sgm_reduce_plain(C, P1, P2, uniq, num_paths=num_paths)
    out = sgm_cuda.sgm_reduce(C.to(dev), P1, P2, uniq, cost_bound=2325, num_paths=num_paths)
    torch.cuda.synchronize()
    for name, a, b in zip(("minS", "best", "sm", "s0", "sp", "uok"), out, ref):
        assert torch.equal(a.cpu(), b), name


def test_direction_volumes_match_plain(dev):
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.integers(0, 2326, (3, 19, 29, 64)).astype(np.int16))
    Cd = C.to(dev)
    for a, b in zip(sgm_cuda.vertical(Cd, 100, 900, True, 2325), sgm_cuda.vertical_plain(C, 100, 900, True)):
        assert torch.equal(a.cpu().to(torch.int32), b)
    for rev in (False, True):
        a = sgm_cuda.horizontal(Cd, 100, 900, rev, 2325)
        assert torch.equal(a.cpu().to(torch.int32), sgm_cuda.horizontal_plain(C, 100, 900, rev))


def test_int16_bound_is_enforced(dev):
    C = torch.zeros((1, 4, 8, 32), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        sgm_cuda.vertical(C, 8, 32000, True, 100)


def test_pipeline_cuda_matches_cpu(dev):
    H, W, B = 96, 200, 2
    left, right = scene(H=H, W=W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    mx = xx + 0.3 * np.sin(yy / 11.0)
    my = yy + 0.2 * np.cos(xx / 13.0)
    maps = (mx, my, mx - 0.1, my)
    Q = np.array([[1, 0, 0, -W / 2], [0, 1, 0, -H / 2], [0, 0, 0, 500.0], [0, 0, 10.0, 0]], np.float32)
    p = StereoSGBMParams(num_disparities=64, uniqueness_ratio=10, disp12_max_diff=1,
                         speckle_window_size=20, speckle_range=2)
    lb, rb = np.stack([left] * B), np.stack([right] * B)
    d_gpu, p_gpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p)
    d_cpu, p_cpu = batched_stereo_pipeline(lb, rb, maps, Q, params=p, device="cpu")
    assert d_gpu.device.type == "cuda"
    assert torch.equal(d_gpu.cpu(), d_cpu)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-6, atol=0, equal_nan=True)
