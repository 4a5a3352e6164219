"""The speckle filter's union-find formulation against the JAX package.

The CUDA speckle kernel (``stereo_vision_tpu_torch/csrc/speckle.cu``)
computes the round algorithm of ``postprocess.speckle_filter`` as
connected components: a valid pixel is removed exactly when its component
C has |C| <= S and every pixel of C lies within R same-blob steps of m_C,
C's pixel of least flat index y * W + x (R = S - 1, or the diameter cap).
Here a numpy union-find plus a breadth-first walk from m_C over the
(R + 1) x (2R + 1) window below it (every pixel of C has an index >= m_C's)
implements that rule, and is held equal, exactly, to JAX's
``speckle_filter`` (its XLA form) on seeded random maps and on shapes made
to break it. This is the evidence that the kernel's algorithm is the
reference's; the kernel itself is held to the port's plain form on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_vision_tpu.stereo.postprocess import speckle_filter as jax_speckle
from stereo_vision_tpu_torch.synth.scenes import speckle_patterns


def _components(d, valid, max_diff):
    """Union-find over the same-blob edges of one (H, W) frame, each link
    from the larger root to the smaller: the root (least flat index) of
    every pixel, and the right and down edge masks."""
    H, W = d.shape
    right = valid[:, :-1] & valid[:, 1:] & (np.abs(d[:, 1:] - d[:, :-1]) <= np.float32(max_diff))
    down = valid[:-1] & valid[1:] & (np.abs(d[1:] - d[:-1]) <= np.float32(max_diff))
    parent = np.arange(H * W)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for a, b in [(y * W + x, y * W + x + 1) for y, x in zip(*np.nonzero(right))] + \
                [(y * W + x, (y + 1) * W + x) for y, x in zip(*np.nonzero(down))]:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(H * W)]).reshape(H, W), right, down


def _within(root, count, R, right, down, H, W):
    """Whether a walk from pixel ``root`` over same-blob edges reaches all
    ``count`` pixels of its component in R steps, inside the window of rows
    [y_r, y_r + R] and columns [x_r - R, x_r + R]."""
    yr, xr = divmod(root, W)
    seen, frontier = {(yr, xr)}, deque([(yr, xr, 0)])
    while frontier:
        y, x, k = frontier.popleft()
        if k == R:
            continue
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            yy, xx = y + dy, x + dx
            if not (yr <= yy <= min(yr + R, H - 1) and max(xr - R, 0) <= xx <= min(xr + R, W - 1)):
                continue
            edge = (down[min(y, yy), x] if dy else right[y, min(x, xx)])
            if edge and (yy, xx) not in seen:
                seen.add((yy, xx))
                frontier.append((yy, xx, k + 1))
    return len(seen) == count


def speckle_components(disp, max_diff, S, invalid, cap=None):
    """valid and |C| <= S and every pixel of C within R steps of m_C ->
    invalid, frame by frame over (P, H, W) float32 maps."""
    R = max(S - 1 if cap is None else min(S - 1, cap), 1)
    out = disp.copy()
    for f in range(disp.shape[0]):
        d = disp[f]
        H, W = d.shape
        valid = d > np.float32(invalid)
        roots, right, down = _components(d, valid, max_diff)
        counts = np.bincount(roots[valid], minlength=H * W)
        keep_root = {}
        for r in np.unique(roots[valid]):
            c = counts[r]
            keep_root[r] = c > S or (c >= R + 2 and not _within(r, c, R, right, down, H, W))
        remove = valid & ~np.vectorize(lambda r: keep_root.get(r, True))(roots)
        out[f][remove] = invalid
    return out


def _random_maps(seed, kind):
    rng = np.random.default_rng(seed)
    shape = (2, 36, 72)
    if kind == "levels":  # neighbouring levels join (1.5 <= 2), levels two apart do not
        d = rng.integers(0, 6, shape).astype(np.float32) * 1.5
        d[rng.random(shape) < 0.3] = -1.0
    else:  # only equal values join: blobs of every size and shape
        d = rng.integers(0, 3, shape).astype(np.float32) * 4
        d[rng.random(shape) < 0.15] = -1.0
    return d


@pytest.mark.parametrize("kind", ["levels", "equal"])
@pytest.mark.parametrize("S", [5, 20, 100])
@pytest.mark.parametrize("cap", [None, 2, 4, 8])
def test_components_match_jax_on_random_maps(kind, S, cap):
    disp = _random_maps(S + (cap or 0), kind)
    ref = np.asarray(jax_speckle(jnp.asarray(disp), 2.0, S, -1.0, max_diameter=cap))
    np.testing.assert_array_equal(speckle_components(disp, 2.0, S, -1.0, cap), ref)
    assert (ref != disp).any()


@pytest.mark.parametrize("S,cap", [(20, None), (20, 2), (20, 4), (20, 8), (19, 18), (100, 4), (5, None)])
def test_components_match_jax_on_adversarial_shapes(S, cap):
    disp = speckle_patterns()
    ref = np.asarray(jax_speckle(jnp.asarray(disp), 1.0, S, -1.0, max_diameter=cap))
    np.testing.assert_array_equal(speckle_components(disp, 1.0, S, -1.0, cap), ref)
    assert (ref[6] == -1).all() and (ref[5] == 12).all()  # singletons go, the whole frame stays
    # The snake (19 px, diameter 18) goes only where R >= 18; the 2-px blob always.
    assert (ref[0, 1, 1] == -1) == (S >= 19 and (cap is None or cap >= 18))
    assert ref[0, 6, 2] == -1
