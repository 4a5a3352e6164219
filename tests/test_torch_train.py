"""The port's training path (BatchNorm's training form, flax's
initialisation, ``detection_loss``, the AdamW schedule, the ball trainer,
the way back to the reference's trees and files) against the JAX package,
on the CPU.

The JAX YOLOv8n is built from ``jax.eval_shape`` of its ``init`` and the
in-repo npz, and runs at 64x64 on a batch of two: a letterboxed image (its
bottom rows the inference-time gray 114, where SPPF's max-pools meet equal
activations) and a full one, each with one valid and one invalid GT box.
Both sides take the same arrays. Tolerances:

- BatchNorm's training form: the output within 2e-5 of its largest value,
  its gradients within 1e-4 of theirs (a constant channel, at the
  variance's clamp, amplifies the rounding of its statistics by
  rsqrt(eps) ~ 32: 2.7e-5 measured), both running statistics within rtol
  1e-6;
- ``detection_loss`` on given maps within rtol 1e-5, its gradient within
  1e-5 of the largest; through the network in ``train()`` mode: the loss
  within rtol 1e-5 (1.0e-6 measured), every parameter's gradient within
  2e-3 of that leaf's largest gradient (float32 sums over a batch in
  another order; 2.1e-4 measured), the moved running statistics within
  1e-4 of their leaf's largest;
- the schedule within rtol 1e-6 of optax's; AdamW against
  ``optax.adamw`` on identical gradients within 2 float32 ulps (rtol
  2.4e-7; the decay applied as p (1 - lr wd) against p - lr wd p) over 6
  steps, the first step (lr 0) moving no parameter;
- the saved files: ``save_tree``'s npz read by the JAX package's
  ``load_tree`` bit for bit, ``save_numpy_tree``'s keys equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from stereo_vision_tpu.models import checkpoint as jckpt
from stereo_vision_tpu.models import layers as jlayers
from stereo_vision_tpu.models import pretrained as jp
from stereo_vision_tpu.models import yolov8 as jyolo
from stereo_vision_tpu_torch.models import checkpoint, convert, layers, pretrained, yolov8
from stereo_vision_tpu_torch.synth import scenes

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax_layout(path, t: torch.Tensor) -> np.ndarray:
    a = t.detach()
    if path[-1] == "kernel":
        a = a.permute(2, 3, 1, 0) if a.ndim == 4 else a.T
    return a.numpy()


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _close_by_leaf(model, ref_tree, collection: str, get, rel: float, what: str):
    """Each of ``model``'s leaves of ``collection`` (``get(key)``) within
    ``rel`` of its largest reference value."""
    n = 0
    for path, key in convert.reference_leaves(model):
        if path[0] != collection:
            continue
        ref = _at(ref_tree, path[1:])
        mine = _flax_layout(path, get(key))
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert np.abs(mine - ref).max() <= rel * scale, (what, path, np.abs(mine - ref).max(), scale)
        n += 1
    return n


@pytest.fixture(scope="module")
def ball():
    """The JAX YOLOv8n on the in-repo weights, a 64x64 batch with gray
    padding, and JAX's loss, gradients and moved statistics in training
    mode."""
    model = jp._ball_model()
    like = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    variables = jp.load_tree(jp.BALL_WEIGHTS, like)
    rng = np.random.default_rng(7)
    wide = scenes.textured_background(rng, 96, 128)
    scenes.draw_ball(wide, 40.0, 50.0, 14.0)
    square = scenes.textured_background(rng, 64, 64)
    scenes.draw_ball(square, 30.0, 28.0, 9.0)
    x0, s = pretrained.letterbox(wide[None], (64, 64), CPU)  # bottom 16 rows gray 114
    x1, _ = pretrained.letterbox(square[None], (64, 64), CPU)
    x = torch.cat([x0, x1]).numpy()
    assert s == 0.5 and (x[0, 48:] == np.float32(114 / 255)).all()
    boxes = np.array([[[13, 18, 27, 32], [0, 0, 0, 0]], [[21, 19, 39, 37], [2, 2, 9, 9]]], np.float32)
    classes = np.zeros((2, 2), np.int32)
    valid = np.array([[True, False], [True, False]])

    def objective(params):
        raw, upd = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                               train=True, mutable=["batch_stats"])
        return jyolo.detection_loss(raw, boxes, classes, valid, (64, 64), 1), upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(variables["params"])
    return dict(model=model, like=like, variables=_np_tree(variables), x=x, boxes=boxes, classes=classes,
                valid=valid, loss=float(loss), grads=_np_tree(grads), batch_stats=_np_tree(new_bs))


def _port_ball(ball) -> yolov8.YOLOv8:
    m = pretrained._ball_model()
    m.load_state_dict(convert.variables_from_reference(ball["variables"]))
    return m


def test_batchnorm_training_form_matches_flax():
    """Output, gradients and both moved statistics against flax's
    BatchNorm(use_running_average=False) (momentum 0.97, eps 1e-3) with
    mutable batch_stats; one channel constant (variance 0, at the clamp)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (3, 5, 6, 8)).astype(np.float32)
    x[..., 2] = 1.5
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(0, 0.1, 8).astype(np.float32)
    mean, var = rng.normal(0, 0.2, 8).astype(np.float32), rng.uniform(0.5, 2.0, 8).astype(np.float32)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)

    def f(x, params):
        y, upd = bn.apply({"params": params, "batch_stats": {"mean": mean, "var": var}}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (y, st)), (gx, gp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        x, {"scale": scale, "bias": bias})
    port = layers.BatchNorm(8).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = port(xt)
    (out * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    for mine, ref, rel in ((out.permute(0, 2, 3, 1), y, 2e-5), (xt.grad.permute(0, 2, 3, 1), gx, 1e-4),
                           (port.weight.grad, gp["scale"], 1e-4), (port.bias.grad, gp["bias"], 1e-4)):
        ref = np.asarray(ref)
        assert np.abs(mine.detach().numpy() - ref).max() <= rel * np.abs(ref).max()
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(st["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(st["var"]), rtol=1e-6, atol=1e-7)
    port.eval()  # the inference form reads the moved statistics
    ref = fnn.BatchNorm(use_running_average=True, epsilon=1e-3).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": st}, x)
    np.testing.assert_allclose(port(xt).detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_init_flax_style_matches_flax_statistics():
    """flax's defaults: lecun_normal kernels (|w| <= 2 std, variance 1 /
    fan_in), zero biases, BatchNorm 1 / 0, from a torch.Generator
    (reproducible, not JAX's draw)."""
    ref = jlayers.ConvBnSiLU(64, 3).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 48)))
    port = layers.init_flax_style(layers.ConvBnSiLU(48, 64, 3), torch.Generator().manual_seed(0))
    w, rw = port.Conv_0.weight.detach().numpy(), np.asarray(ref["params"]["Conv_0"]["kernel"])
    assert w.shape == rw.transpose(3, 2, 0, 1).shape
    std = (1 / (48 * 9)) ** 0.5 / 0.87962566103423978
    for a in (w, rw):
        assert np.abs(a).max() <= 2 * std and abs(a.var() * 48 * 9 - 1) < 0.05
    bn = port.BatchNorm_0
    for t, v in ((bn.weight, 1), (bn.bias, 0), (bn.running_mean, 0), (bn.running_var, 1)):
        assert torch.equal(t, torch.full_like(t, float(v)))
    again = layers.init_flax_style(layers.ConvBnSiLU(48, 64, 3), torch.Generator().manual_seed(0))
    assert torch.equal(again.Conv_0.weight, port.Conv_0.weight)
    head = layers.init_flax_style(pretrained._ball_model(), torch.Generator().manual_seed(1))
    assert not head.Conv_1.bias.any() and head.Conv_1.weight.abs().max() > 0


def test_variables_to_reference_round_trip_and_npz(ball):
    port = convert.load_tree(pretrained.BALL_WEIGHTS, pretrained._ball_model())
    tree = convert.variables_to_reference(port)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    ref = jax.tree_util.tree_flatten_with_path(ball["variables"])[0]
    assert [p for p, _ in leaves] == [p for p, _ in ref] and len(leaves) == 297
    for (_, a), (_, b) in zip(leaves, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    back = convert.variables_from_reference(tree)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("case", ["batch", "no_valid_gt"])
def test_detection_loss_on_maps_matches_jax(case):
    """The loss and its gradient on the raw maps, given maps (no network):
    a batch of three with one, two and no valid GT boxes, a box of zero
    width; or no valid GT at all (every anchor negative)."""
    rng = np.random.default_rng(3)
    raw = [rng.normal(0, 2, (3, h, h, 65)).astype(np.float32) for h in (8, 4, 2)]
    boxes = np.array([[[8, 8, 40, 36], [0, 0, 0, 0]], [[20, 4, 60, 30], [30, 30, 30, 50]],
                      [[1, 1, 9, 9], [5, 5, 20, 20]]], np.float32)
    valid = np.array([[True, False], [True, True], [False, False]])
    if case == "no_valid_gt":
        valid[:] = False
    classes = np.zeros((3, 2), np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda r: jyolo.detection_loss(r, boxes, classes, valid, (64, 64), 1)))([jnp.asarray(r) for r in raw])
    rt = [torch.from_numpy(r).requires_grad_(True) for r in raw]
    mine = yolov8.detection_loss(rt, *(torch.from_numpy(a) for a in (boxes, classes, valid)), (64, 64), 1)
    mine.backward()
    np.testing.assert_allclose(mine.item(), float(loss), rtol=1e-5)
    for r, g in zip(rt, grads):
        g = np.asarray(g)
        assert np.abs(r.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_detection_loss_gradients_through_network_match_jax(ball):
    """The loss, every parameter's gradient and the moved running statistics
    of the YOLOv8n in train() mode on the padded batch."""
    port = _port_ball(ball).train()
    with layers.fp32_forward():
        raw = port(torch.from_numpy(ball["x"]))
        loss = yolov8.detection_loss(raw, *(torch.from_numpy(ball[k]) for k in ("boxes", "classes", "valid")),
                                     (64, 64), 1)
        loss.backward()
    np.testing.assert_allclose(loss.item(), ball["loss"], rtol=1e-5)
    params = dict(port.named_parameters())
    n = _close_by_leaf(port, ball["grads"], "params", lambda k: params[k].grad, 2e-3, "grad")
    assert n == len(jax.tree_util.tree_leaves(ball["grads"])) == len(params)
    state = port.state_dict()
    n = _close_by_leaf(port, ball["batch_stats"], "batch_stats", state.__getitem__, 1e-4, "stats")
    assert n == len(jax.tree_util.tree_leaves(ball["batch_stats"])) == len(list(port.buffers()))


def test_warmup_cosine_schedule_matches_optax():
    for steps in (1, 2, 40, 800, 3000):
        warm = min(50, max(steps // 10, 1))
        total = max(steps, warm + 1)
        ref = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warm, total)
        for c in sorted({0, 1, warm - 1, warm, warm + 1, total // 2, total - 1, total, total + 3}):
            if c >= 0:
                np.testing.assert_allclose(pretrained.warmup_cosine_lr(c, warm, total, 2e-3), float(ref(c)),
                                           rtol=1e-6, atol=1e-12)


def test_adamw_schedule_matches_optax_on_identical_gradients():
    """Six steps of the port's AdamW + LambdaLR against optax.adamw under the
    warmup-cosine schedule, the same gradients fed to both; the first step
    runs at lr 0 and moves nothing, Adam's moments still do."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32), "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    steps = 40  # warmup 4
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 2e-3, 4, steps), weight_decay=1e-4)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = pretrained.adamw_warmup_cosine(list(tparams.values()), steps)
    for i in range(6):
        g = {k: rng.normal(0, 1e-2 * (i + 1), v.shape).astype(np.float32) for k, v in p0.items()}
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in tparams.items():
            if i == 0:
                assert torch.equal(p.detach(), torch.from_numpy(p0[k]))
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=2.4e-7, atol=1e-9)
    assert opt.param_groups[0]["lr"] == pytest.approx(float(optax.warmup_cosine_decay_schedule(
        0.0, 2e-3, 4, steps)(6)), rel=1e-6)


def test_train_ball_detector_writes_what_jax_reads(ball, tmp_path):
    """Two steps of the ball trainer on the CPU (batch 2): its npz loads
    through the JAX package's ``load_tree`` bit for bit, and
    ``save_numpy_tree`` / ``save_variables`` agree with the reference."""
    before = layers.init_flax_style(pretrained._ball_model(), torch.Generator().manual_seed(0)).state_dict()
    res = pretrained.train_ball_detector(steps=2, batch=2, out_path=tmp_path / "ball.npz", device=CPU, log_every=1)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all() and res["final_loss"] == res["losses"][-1]
    model = res["model"]
    assert not model.training
    state = model.state_dict()
    moved = [k for k in state if not torch.equal(state[k], before[k])]
    assert any(k.endswith("running_var") for k in moved) and any(k.endswith("Conv_0.weight") for k in moved)
    tree = convert.variables_to_reference(model)
    loaded = jp.load_tree(tmp_path / "ball.npz", ball["like"])
    flat, ref = jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(tree)
    assert len(flat) == len(ref) == 297
    for a, b in zip(flat, ref):
        assert np.array_equal(np.asarray(a), b)
    checkpoint.save_numpy_tree(tmp_path / "port.npz", model)
    jckpt.save_numpy_tree(tmp_path / "jax.npz", loaded)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) and "['params']['Conv_0']['kernel']" in a.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    checkpoint.save_variables(tmp_path / "ckpt" / "ball.pt", model)
    other = checkpoint.load_variables(tmp_path / "ckpt" / "ball.pt", pretrained._ball_model())
    for k, v in other.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert sorted(checkpoint.load_variables(tmp_path / "ckpt" / "ball.pt")) == sorted(state)


def test_trainers_need_the_card_and_write_outside_the_jax_package():
    """No fall-back to the CPU without a card, and the default out_path is
    the port's own git-ignored directory."""
    assert pretrained.TRAINED_DIR.parent.name == "models"
    assert pretrained.TRAINED_DIR.parents[1].name == "stereo_vision_tpu_torch"
    assert pretrained.WEIGHTS_DIR.parents[1].name == "stereo_vision_tpu"
    if not torch.cuda.is_available():
        for train in (pretrained.train_ball_detector, pretrained.train_pose_net):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                train(steps=1)
