"""The mesh's training step, data parallel for a model that reads batch
statistics: each data device runs its own replica of the model on its
share, and at every batch norm the shares' statistics meet; on the CPU.

Cases: ROADMAP C.9's repro net (``Linear(4, 8)`` -> ``BatchNorm1d(8)`` ->
``Linear(8, 1)``, batch 8) with and without its batch norm, and YOLOv8n
in ``train()`` mode (flax's initialisation drawn from a seed, a 64x64
batch of four rendered ball scenes, ``detection_loss``). Tolerances:

- each step calls each data device's replica once, on its own rows of
  the batch (equal to the host batch's slice), on a thread of its own; the
  net without a batch norm through the module form equal to the plain
  callable's step bit for bit;
- YOLOv8n in float64 on two data devices: the loss and every gradient
  within rtol 1e-5 / atol 1e-6 of the one-device step's and of JAX's
  ``make_train_step`` on two CPU devices in float64 (its gradient read off
  one SGD step at lr 1 as p0 - p1); the batch statistics unmoved;
- YOLOv8n in float32, the dtype the trainers run: the loss within rtol
  1e-5 of the one-device step's; the gradients no farther from the float64
  one-device step than twice the float32 one-device step is, or than 1 (in
  units of 1e-6 + 1e-5 |g|: 57.7 on two devices, 28.9 on four, against
  41.4 on one, measured; the float64 steps are 5e-8 such units apart, and
  JAX's 3e-7 from the port's). The one-device float32 step is itself ~41
  units from the float64 one: below float32's noise in this network, any
  other order of the batch's sums (the per-share weight gradients, the
  statistics' partial sums) moves the gradients that far;
- 16 shares of 2 rows on a machine of fewer cores, the interpreter
  switching threads every microsecond, in float64: three steps equal the
  one-device step's within rtol 1e-5 / atol 1e-6;
- a plain callable that reads batch statistics on two data devices raises
  ``ValueError`` naming the module form; a share that raises, or that
  meets fewer batch norms than the others, ends the step with its error
  within 10 s (no hang), and the step runs again after it.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from stereo_vision_tpu.models import pretrained as jp
from stereo_vision_tpu.models import train as jtrain
from stereo_vision_tpu.models import yolov8 as jyolo
from stereo_vision_tpu.parallel.mesh import create_mesh as jcreate_mesh
from stereo_vision_tpu_torch import models
from stereo_vision_tpu_torch.models import convert, layers, yolov8
from stereo_vision_tpu_torch.parallel.mesh import create_mesh, host_cpu_mesh
from stereo_vision_tpu_torch.synth import scenes

CPU = "cpu"
HW = (64, 64)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mse(out, t):
    return ((out[:, 0] - t) ** 2).mean()


def _repro(batch_norm: bool = True):
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1d(8), nn.Linear(8, 1)).train()
    x = torch.randn(8, 4) * torch.arange(1, 9)[:, None]
    return (net if batch_norm else nn.Sequential(net[0], net[2])), x, torch.randn(8)


def _variables(net):
    return {"params": dict(net.named_parameters()), "batch_stats": dict(net.named_buffers())}


def _grads(state) -> dict:
    return {k: p.grad.detach().clone() for k, p in state.params.items()}


def _units(a: dict, ref: dict) -> float:
    """The largest distance of ``a``'s gradients from ``ref``'s, in units of
    1e-6 + 1e-5 |ref| (rtol 1e-5 / atol 1e-6: <= 1 passes)."""
    return max(float(((a[k].double() - r.double()).abs() / (1e-6 + 1e-5 * r.double().abs())).max())
               for k, r in ref.items())


@pytest.mark.parametrize("batch_norm", [True, False])
def test_each_data_device_runs_its_replica_once_a_step_on_its_share(batch_norm):
    net, x, y = _repro(batch_norm)
    init, step = models.make_train_step(host_cpu_mesh(2), net, _mse, lambda p: torch.optim.SGD(p, lr=0.1))
    assert len(step.replicas) == 2 and all(r is not net for r in step.replicas)
    calls = []
    for i, r in enumerate(step.replicas):
        r.register_forward_pre_hook(
            lambda m, a, i=i: calls.append((i, a[0].detach().clone(), threading.current_thread().name)))
    state = init(_variables(net))
    losses = []
    for k in range(2):
        state, loss = step(state, x, y)
        losses.append(loss.item())
        assert sorted(c[0] for c in calls) == [0, 1], calls  # each replica once a step
        for i, rows, _ in calls:
            assert torch.equal(rows, x[4 * i:4 * (i + 1)])
        assert len({c[2] for c in calls}) == 2 and threading.current_thread().name not in {c[2] for c in calls}
        calls.clear()
    if not batch_norm:  # the plain callable's step, as before: each share in this thread
        net, x, y = _repro(batch_norm)
        init, plain = models.make_train_step(
            host_cpu_mesh(2), lambda v, a: torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,)),
            _mse, lambda p: torch.optim.SGD(p, lr=0.1))
        ref = init(_variables(net))
        for k in range(2):
            ref, loss = plain(ref, x, y)
            assert loss.item() == losses[k]
        for k, p in ref.params.items():
            assert torch.equal(p, state.params[k]), k


def test_replicas_own_tensors_are_never_read():
    """Every replica's parameters and buffers overwritten with NaN: the step
    reads the state's variables only."""
    net, x, y = _repro()
    init, step = models.make_train_step(host_cpu_mesh(2), net, _mse, lambda p: torch.optim.SGD(p, lr=0.1))
    with torch.no_grad():
        for r in step.replicas:
            for t in list(r.parameters()) + [b for b in r.buffers() if b.is_floating_point()]:
                t.fill_(float("nan"))
    state, loss = step(init(_variables(net)), x, y)
    one_init, one = models.make_train_step(create_mesh(1, 1, devices=[CPU]), net, _mse,
                                           lambda p: torch.optim.SGD(p, lr=0.1))
    _, ref = one(one_init(_variables(net)), x, y)
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-5)
    assert all(torch.isfinite(p).all() for p in state.params.values())


def test_more_shares_than_cores_under_a_short_switch_interval():
    """16 shares of 2 rows (more threads than the machine's cores), three
    batch norms a forward pass, the interpreter switching threads every
    microsecond: three steps in float64 equal the one-device step's
    within rtol 1e-5 / atol 1e-6 (a post lost or read from another meeting
    would move them far)."""
    torch.manual_seed(2)
    net = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1d(8), nn.Linear(8, 8), nn.BatchNorm1d(8), nn.Tanh(),
                        nn.Linear(8, 8), nn.BatchNorm1d(8), nn.Linear(8, 1)).double().train()
    x, y = torch.randn(32, 4, dtype=torch.float64) * 3 + 1, torch.randn(32, dtype=torch.float64)

    def run(mesh):
        init, step = models.make_train_step(mesh, net, _mse, lambda p: torch.optim.SGD(p, lr=0.1))
        state, losses = init(_variables(net)), []
        for _ in range(3):
            state, loss = step(state, x, y)
            losses.append(loss.item())
        return losses, _grads(state)

    one_losses, one = run(create_mesh(1, 1, devices=[CPU]))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        losses, grads = run(host_cpu_mesh(16))
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5, atol=1e-6)
    assert _units(grads, one) <= 1.0


@pytest.fixture(scope="module")
def yolo():
    """YOLOv8n from flax's initialisation, a 64x64 batch of four ball
    scenes with their boxes, and each step's loss and gradients: the port
    on 1, 2 and 4 data devices in float32 and float64, JAX's step on two
    CPU devices in float64."""
    net = layers.init_flax_style(yolov8.YOLOv8(num_classes=1, variant="n"), torch.Generator().manual_seed(6)).train()
    x, boxes, classes, valid = scenes.ball_training_batch(np.random.default_rng(8), 4, *HW)
    tree = convert.variables_to_reference(net)

    def port(mesh, dtype):
        m = yolov8.YOLOv8(num_classes=1, variant="n")
        m.load_state_dict(net.state_dict())
        m.train().to(dtype)
        c, v = torch.from_numpy(classes), torch.from_numpy(valid)
        init, step = models.make_train_step(mesh, m, lambda out, b: yolov8.detection_loss(out, b, c, v, HW, 1),
                                            lambda p: torch.optim.SGD(p, lr=0.0))
        state = init(_variables(m))
        before = {k: b.clone() for k, b in state.batch_stats.items()}
        state, loss = step(state, torch.from_numpy(x).to(dtype), torch.from_numpy(boxes).to(dtype))
        assert all(torch.equal(b, before[k]) for k, b in state.batch_stats.items())  # unmoved
        return loss.item(), _grads(state)

    out = {(n, dtype): port(create_mesh(1, 1, devices=[CPU]) if n == 1 else host_cpu_mesh(n), dtype)
           for n, dtype in ((1, torch.float64), (2, torch.float64), (1, torch.float32), (2, torch.float32),
                            (4, torch.float32))}

    jm = jp._ball_model()
    init, step = jtrain.make_train_step(
        jcreate_mesh(2, 1, devices=jax.devices("cpu")[:2]),
        lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"])[0],
        lambda raw, b: jyolo.detection_loss(raw, b, classes, valid, HW, 1), optax.sgd(1.0))
    tree64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    state, loss = step(init(tree64), jnp.asarray(x, jnp.float64), jnp.asarray(boxes, jnp.float64))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), tree64["params"],
                                   jax.device_get(state.params))
    return dict(net=net, port=out, jax_loss=float(loss), jax_grads=grads)


def test_yolov8n_in_training_on_two_data_devices_float64_matches_one_device_and_jax(yolo):
    (loss1, g1), (loss2, g2) = yolo["port"][1, torch.float64], yolo["port"][2, torch.float64]
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss2, yolo["jax_loss"], rtol=1e-5, atol=1e-6)
    assert _units(g2, g1) <= 1.0
    n = 0
    for path, key in convert.reference_leaves(yolo["net"]):
        if path[0] != "params":
            continue
        ref = yolo["jax_grads"]
        for p in path[1:]:
            ref = ref[p]
        mine = g2[key]
        mine = (mine.permute(2, 3, 1, 0) if mine.ndim == 4 else mine.T if mine.ndim == 2 else mine).numpy()
        np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-6, err_msg=key)
        n += 1
    assert n == len(g2)


def test_yolov8n_in_training_float32_is_as_accurate_on_several_data_devices(yolo):
    loss1, g1 = yolo["port"][1, torch.float32]
    exact = yolo["port"][1, torch.float64][1]
    one = _units(g1, exact)
    for n in (2, 4):
        loss, g = yolo["port"][n, torch.float32]
        np.testing.assert_allclose(loss, loss1, rtol=1e-5)
        assert _units(g, exact) <= max(2 * one, 1.0), (n, _units(g, exact), one)


class _ConvNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = layers.ConvBnSiLU(3, 4)

    def forward(self, x):
        return self.block(x).mean(dim=(2, 3))


@pytest.mark.parametrize("layer", ["torch BatchNorm1d", "layers.BatchNorm"])
def test_plain_callable_reading_batch_statistics_on_two_data_devices_raises(layer):
    if layer == "torch BatchNorm1d":
        net, x, y = _repro()
    else:
        torch.manual_seed(1)
        net, x, y = _ConvNet().train(), torch.randn(4, 3, 6, 6), torch.randn(4)

    def build(n):
        return models.make_train_step(
            host_cpu_mesh(n), lambda v, a: torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,)),
            _mse, lambda p: torch.optim.SGD(p, lr=0.1))

    init, step = build(2)
    with pytest.raises(ValueError, match="nn.Module"):
        step(init(_variables(net)), x, y)
    init, step = build(1)  # on one data device a plain callable runs the plain step
    _, loss = step(init(_variables(net)), x, y)
    assert torch.isfinite(loss)


class _Faulty(nn.Module):
    """Linear -> BatchNorm1d -> BatchNorm1d -> Linear; a share whose rows
    carry the marker raises after the first batch norm, or skips the
    second."""

    def __init__(self, fault: str):
        super().__init__()
        self.fault = fault
        self.lin0, self.lin1 = nn.Linear(4, 8), nn.Linear(8, 1)
        self.bn0, self.bn1 = nn.BatchNorm1d(8), nn.BatchNorm1d(8)

    def forward(self, x):
        marked = bool((x[:, 0] > 1e3).any())
        y = self.bn0(self.lin0(x))
        if marked and self.fault == "raises":
            raise RuntimeError("share failed")
        return self.lin1(y if marked else self.bn1(y))


@pytest.mark.parametrize("fault", ["raises", "skips a batch norm"])
def test_a_failing_share_ends_the_step(fault):
    torch.manual_seed(0)
    net = _Faulty(fault).train()
    x, y = torch.randn(8, 4), torch.randn(8)
    x[4:, 0] = 1e4  # the second share's rows
    init, step = models.make_train_step(host_cpu_mesh(2), net, _mse, lambda p: torch.optim.SGD(p, lr=0.1))
    state = init(_variables(net))
    raised = []

    def run():
        try:
            step(state, x, y)
        except Exception as e:  # noqa: BLE001 - checked below
            raised.append(e)

    t0 = time.perf_counter()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(10.0)
    assert not t.is_alive(), "the step hung"
    assert time.perf_counter() - t0 < 10.0
    want = (RuntimeError, "share failed") if fault == "raises" else (ValueError, "different numbers")
    assert len(raised) == 1 and isinstance(raised[0], want[0]) and want[1] in str(raised[0]), raised
    x[4:, 0] = 0.0  # no share is stuck: the same step runs on a batch without the marker
    _, loss = step(state, x, y)
    assert torch.isfinite(loss)
