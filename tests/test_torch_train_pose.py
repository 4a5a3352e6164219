"""The port's pose losses, the pose net's training step and the mesh's
training step against the JAX package, on the CPU.

A narrow PoseNet (width 8) at 64x64: the port's model initialised as flax
does (``layers.init_flax_style``), its BatchNorm leaves then moved off 1 /
0 by seeded numpy, and carried to JAX (``convert.variables_to_reference``);
a batch of two stick figures drawn by the port, one letterboxed (its
bottom rows gray 114). Tolerances:

- ``pose_loss`` / ``heatmap_loss`` / ``pose_loss_full`` on given arrays
  within rtol 1e-6, their gradients within 5e-6 of the largest (6.6e-7
  measured);
- through the network in ``train()`` mode: the loss within rtol 1e-5,
  every parameter's gradient within 1e-2 of its leaf's largest (1.9e-3
  measured: float32 noise of this narrow net, the port and JAX are 1.3e-3
  and 1.9e-3 from a float64 run of the port), or 1e-5 of the network's
  largest where a leaf's gradient is 0 in exact arithmetic (the heatmap's
  bias, which the spatial softmax cannot see, ~1e-9 on both sides); the
  moved running statistics within 1e-4 of their leaf's largest (2e-5
  measured);
- two steps of ``_make_bn_train_step`` (AdamW, the warmup-cosine schedule
  of 40 steps: lr 0, then 5e-4): the losses within rtol 1e-5, the
  parameters after step 1 bit for bit unmoved, after step 2 within 4 lr
  (Adam's step divides each gradient by its own root mean square, at most
  ~1.4 lr a side at step 2, so a gradient near 0 that takes the other sign
  on one side lands up to ~2.8 lr away; 2.0 lr measured), the running
  statistics within 1e-4 of their leaf's largest; ``_make_bn_train_scan``
  equal to the same steps one by one;
- ``make_train_step`` / ``shard_variables`` on a 1x1 mesh: the spec of
  every leaf equal to JAX's by path, each step's loss within rtol 1e-6 of
  the eval forward on the parameters it started from, the step counted
  twice;
- on a 2x2 mesh (PoseNet w32 at 64x64, batch 4, in eval mode, Adam 1e-3):
  the specs equal JAX's by path, the split kernel's shards its output rows,
  ``put_batch``'s shards JAX's indices; two steps' losses within rtol 1e-6
  of the 1x1 step's (equal measured) and within rtol 1e-5 of JAX's
  ``make_train_step`` on the 4x2 ``cpu_mesh`` (6e-8 measured); the
  parameters within 1e-4 of the largest of the 1x1 step's (6.4e-5
  measured: the split kernel's gradient is summed over the two data
  devices in another order, and Adam's first steps move a parameter whose
  gradient is near 0 by up to ~lr whatever its size) and within 4 lr of
  JAX's (as the step test above);
- with a batch norm in training form (ROADMAP C.9): torch's ``Linear(4, 8)``
  -> ``BatchNorm1d(8)`` -> ``Linear(8, 1)`` (MSE, SGD 0.1) on 1, 2 and 4 CPU
  devices: the 1x1 step's loss and gradients bit for bit those of the plain
  forward and backward, the 2x1 and 4x1 steps' losses and gradients within
  rtol 1e-5 / atol 1e-6 of the 1x1 step's (equal measured), two steps' losses
  and parameters within rtol 1e-5 / atol 1e-6 of JAX's ``make_train_step``
  on as many devices (flax ``BatchNorm(use_running_average=False)`` on the
  same tree), the batch statistics unmoved; the narrow PoseNet in
  ``train()`` mode on 2x2 (SGD at lr 0, so the gradients stay to be read):
  loss and gradients within rtol 1e-5 / atol 1e-6 of the 1x1 step's and
  held to JAX's training-mode loss and gradients as the network test above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from torch import nn

from stereo_vision_tpu.models import pretrained as jp
from stereo_vision_tpu.models import train as jtrain
from stereo_vision_tpu.models.pose import PoseNet as JPoseNet
from stereo_vision_tpu.models.pose import heatmap_loss as jheatmap_loss
from stereo_vision_tpu.models.pose import pose_loss as jpose_loss
from stereo_vision_tpu.models.pose import pose_loss_full as jpose_loss_full
from stereo_vision_tpu.parallel.mesh import create_mesh as jcreate_mesh
from stereo_vision_tpu_torch import models
from stereo_vision_tpu_torch.models import convert, layers, pose, pretrained
from stereo_vision_tpu_torch.parallel.mesh import ShardedTensor, create_mesh, host_cpu_mesh
from stereo_vision_tpu_torch.synth import scenes

CPU = "cpu"
STEPS = 40  # the schedule's length in the step test: warmup 4, lr 0 then 5e-4


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


def _port(tree) -> pose.PoseNet:
    m = pose.PoseNet(width=8)
    m.load_state_dict(convert.variables_from_reference(tree))
    return m


@pytest.fixture(scope="module")
def posenet():
    """The narrow pose net's variables, a padded batch with its landmark
    truth, and JAX's loss, gradients and moved statistics in training
    mode."""
    m = layers.init_flax_style(pose.PoseNet(width=8), torch.Generator().manual_seed(3))
    tree = convert.variables_to_reference(m)
    rng = np.random.default_rng(11)
    for node in jax.tree_util.tree_leaves(tree["batch_stats"], is_leaf=lambda n: isinstance(n, dict) and "var" in n):
        node["mean"] = rng.normal(0, 0.3, node["mean"].shape).astype(np.float32)
        node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(np.float32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        if path[-1].key in ("scale", "bias"):
            leaf[...] = rng.normal(1.0 if path[-1].key == "scale" else 0.0, 0.2, leaf.shape)
    f = 1.1 * 128
    P = np.array([[f, 0, 64], [0, f, 48], [0, 0, 1.0]]) @ np.hstack([np.eye(3), np.zeros((3, 1))])
    uv = scenes._project(P, scenes.body33_from_key13(scenes.random_pose13(rng)))
    wide = scenes.stick_figure_frame(96, 128, uv, rng=rng)
    x0, s = pretrained.letterbox(wide[None], (64, 64), CPU)  # bottom 16 rows gray 114
    im, gt = scenes.pose_training_batch(rng, 1, 64, 64)
    x = np.concatenate([x0.numpy(), im])
    gt = np.concatenate([np.zeros((1, 33, 4), np.float32), gt])
    gt[0, :, 0], gt[0, :, 1] = uv[:, 0] * s / 64, uv[:, 1] * s / 64
    gt[0, :, 3] = rng.random(33) < 0.8
    jm = JPoseNet(width=8)

    def objective(params):
        (lm, heat), upd = jm.apply({"params": params, "batch_stats": tree["batch_stats"]}, jnp.asarray(x),
                                   train=True, return_heatmap=True, mutable=["batch_stats"])
        return jpose_loss_full(lm, heat, gt), upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(tree["params"])
    return dict(jm=jm, tree=tree, x=x, gt=gt, loss=float(loss), grads=_np_tree(grads), batch_stats=_np_tree(new_bs))


@pytest.mark.parametrize("fn", ["pose_loss", "heatmap_loss", "pose_loss_full"])
def test_pose_losses_match_jax(fn):
    """Values and gradients on given landmarks and heatmaps: visibility 0 /
    1 in the truth, landmarks off the frame, predicted visibilities at the
    clip's bounds."""
    rng = np.random.default_rng(2)
    pred = rng.uniform(-0.2, 1.2, (3, 33, 4)).astype(np.float32)
    pred[0, :4, 3] = [0.0, 1.0, 1e-7, 0.5]
    gt = rng.uniform(-0.1, 1.1, (3, 33, 4)).astype(np.float32)
    gt[..., 3] = rng.random((3, 33)) < 0.7
    heat = rng.normal(0, 3, (3, 16, 16, 33)).astype(np.float32)
    jfn = {"pose_loss": lambda p, h: jpose_loss(p, gt), "heatmap_loss": lambda p, h: jheatmap_loss(h, gt),
           "pose_loss_full": lambda p, h: jpose_loss_full(p, h, gt)}[fn]
    tfn = {"pose_loss": lambda p, h: pose.pose_loss(p, g), "heatmap_loss": lambda p, h: pose.heatmap_loss(h, g),
           "pose_loss_full": lambda p, h: pose.pose_loss_full(p, h, g)}[fn]
    loss, grads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(pred, heat)
    g = torch.from_numpy(gt)
    tp, th = torch.from_numpy(pred).requires_grad_(True), torch.from_numpy(heat).requires_grad_(True)
    mine = tfn(tp, th)
    mine.backward()
    np.testing.assert_allclose(mine.item(), float(loss), rtol=1e-6)
    for t, ref in zip((tp, th), grads):
        ref = np.asarray(ref)
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(ref)
        assert np.abs(got - ref).max() <= 5e-6 * max(np.abs(ref).max(), 1e-30)


def test_pose_loss_gradients_through_network_match_jax(posenet):
    port = _port(posenet["tree"]).train()
    with layers.fp32_forward():
        lm, heat = port(torch.from_numpy(posenet["x"]), return_heatmap=True)
        loss = pose.pose_loss_full(lm, heat, torch.from_numpy(posenet["gt"]))
        loss.backward()
    np.testing.assert_allclose(loss.item(), posenet["loss"], rtol=1e-5)
    params = dict(port.named_parameters())
    floor = 1e-5 * max(np.abs(g).max() for g in jax.tree_util.tree_leaves(posenet["grads"]))
    n = 0
    for path, key in convert.reference_leaves(port):
        if path[0] == "params":
            ref = _at(posenet["grads"], path[1:])
            err = np.abs(_flax_layout(path, params[key].grad) - ref).max()
            assert err <= max(1e-2 * np.abs(ref).max(), floor), (path, err)
            n += 1
        else:
            ref = _at(posenet["batch_stats"], path[1:])
            assert np.abs(_flax_layout(path, port.state_dict()[key]) - ref).max() <= 1e-4 * np.abs(ref).max(), path
    assert n == len(params)


def test_bn_train_step_two_steps_match_jax(posenet):
    """Two steps of each side's ``_make_bn_train_step`` from one tree and
    batch, the trainer's objective (landmarks and heatmap) and optimizer."""
    jm, tree = posenet["jm"], posenet["tree"]
    warm = min(50, max(STEPS // 10, 1))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 2e-3, warm, STEPS), weight_decay=1e-4)
    jstep = jp._make_bn_train_step(jm, lambda out, gt: jpose_loss_full(out[0], out[1], gt), tx,
                                   apply_kwargs={"return_heatmap": True})
    params, bstats, opt_state = tree["params"], tree["batch_stats"], tx.init(tree["params"])
    port = _port(tree)
    step = pretrained._make_bn_train_step(port, lambda out, gt: pose.pose_loss_full(out[0], out[1], gt),
                                          pretrained.adamw_warmup_cosine(port.parameters(), STEPS),
                                          apply_kwargs={"return_heatmap": True})
    x, gt = torch.from_numpy(posenet["x"]), torch.from_numpy(posenet["gt"])
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for i in range(2):
        params, bstats, opt_state, jloss = jstep(params, bstats, opt_state, jnp.asarray(posenet["x"]),
                                                 jnp.asarray(posenet["gt"]))
        loss = step(x, gt)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        if i == 0:
            for name, p in port.named_parameters():
                assert torch.equal(p.detach(), before[name]), name
    lr = pretrained.warmup_cosine_lr(1, warm, STEPS, 2e-3)
    state = port.state_dict()
    for path, key in convert.reference_leaves(port):
        ref = _at(params if path[0] == "params" else bstats, path[1:])
        mine = _flax_layout(path, state[key])
        if path[0] == "params":
            assert np.abs(mine - ref).max() <= 4 * lr, (path, np.abs(mine - ref).max())
        else:
            assert np.abs(mine - ref).max() <= 1e-4 * np.abs(ref).max(), path


def test_bn_train_scan_equals_its_steps(posenet):
    """``_make_bn_train_scan`` over K = 2 uint8 batches equals two steps of
    ``_make_bn_train_step`` on the same batches divided by 255, bit for bit."""
    imgs = np.round(np.stack([posenet["x"], posenet["x"][::-1]]) * 255).astype(np.uint8)
    gts = np.stack([posenet["gt"], posenet["gt"][::-1]])
    a, b = _port(posenet["tree"]), _port(posenet["tree"])
    kw = {"apply_kwargs": {"return_heatmap": True}}
    obj = lambda out, gt: pose.pose_loss_full(out[0], out[1], gt)  # noqa: E731
    losses = pretrained._make_bn_train_scan(a, obj, pretrained.adamw_warmup_cosine(a.parameters(), STEPS), **kw)(
        torch.from_numpy(imgs), torch.from_numpy(gts))
    step = pretrained._make_bn_train_step(b, obj, pretrained.adamw_warmup_cosine(b.parameters(), STEPS), **kw)
    one = torch.stack([step(torch.from_numpy(im).to(torch.float32) / 255.0, torch.from_numpy(g))
                       for im, g in zip(imgs, gts)])
    assert losses.shape == (2,) and torch.equal(losses, one)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def test_make_train_step_and_shard_variables_on_one_device(posenet):
    """The reference's sharded training step on a 1x1 mesh: the spec tree
    by path equal to JAX's (the wide Dense kernels on ``space``); two steps
    of Adam with the network in eval mode, each loss that of the state it
    started from, the step counted, the batch statistics and the caller's
    model unmoved; the same calls on a 1x2 mesh."""
    jm, tree = posenet["jm"], posenet["tree"]
    jmesh = jcreate_mesh(1, 1, devices=jax.devices("cpu")[:1])
    mesh = create_mesh(1, 1, devices=[CPU])
    port = _port(tree).eval()
    paths = {key: path[1:] for path, key in convert.reference_leaves(port) if path[0] == "params"}
    for tp in (64, 128):
        _, jsh = jtrain.shard_variables(jmesh, tree["params"], tp_min_features=tp)
        jspecs = {tuple(k.key for k in p): tuple(s.spec) for p, s in jax.tree_util.tree_flatten_with_path(
            jsh, is_leaf=lambda n: hasattr(n, "spec"))[0]}
        placed, specs = models.shard_variables(mesh, dict(port.named_parameters()), tp_min_features=tp)
        assert {paths[k]: v for k, v in specs.items()} == jspecs
        assert any(v == (None, "space") for v in specs.values()) == (tp == 64)
        assert all(p.requires_grad and p.data_ptr() != port.get_parameter(k).data_ptr() for k, p in placed.items())

    init, step = models.make_train_step(
        mesh, lambda v, x: torch.func.functional_call(port, {**v["params"], **v["batch_stats"]}, (x,)),
        lambda out, gt: pose.pose_loss(out, gt), lambda p: torch.optim.Adam(p, lr=1e-3))
    state = init({"params": dict(port.named_parameters()), "batch_stats": dict(port.named_buffers())})
    assert isinstance(state, models.TrainState) and int(state.step) == 0
    x, gt = torch.from_numpy(posenet["x"]), torch.from_numpy(posenet["gt"])
    losses = []
    for _ in range(2):
        state, loss = step(state, posenet["x"], posenet["gt"])
        with torch.no_grad():  # the loss of the state the step started from
            ref = pose.pose_loss(torch.func.functional_call(port, {**state.params, **state.batch_stats}, (x,)), gt)
        losses.append((loss.item(), ref.item()))
    assert int(state.step) == 2 and losses[1][0] < losses[0][0]
    with torch.no_grad():
        np.testing.assert_allclose(losses[0][0], pose.pose_loss(port(x), gt).item(), rtol=1e-6)
    np.testing.assert_allclose(losses[1][0], losses[0][1], rtol=1e-6)
    assert not torch.equal(state.params["Conv_0.weight"], port.Conv_0.weight)  # the model's own are untouched
    for k, v in state.batch_stats.items():
        assert torch.equal(v, port.get_buffer(k)), k  # the step does not move batch_stats
    assert models.put_batch(mesh, posenet["x"]).device == torch.device(CPU)
    two = create_mesh(1, 2, devices=[CPU, CPU])  # the same three calls run on two devices
    put = models.put_batch(two, posenet["x"])
    assert isinstance(put, ShardedTensor) and np.array_equal(put.numpy(), posenet["x"])
    assert models.shard_variables(two, {}) == ({}, {})
    assert all(callable(f) for f in models.make_train_step(two, None, None, None))


def test_make_train_step_on_a_2x2_mesh_matches_one_device_and_jax(cpu_mesh):
    """Data parallel over two data devices, the wide Dense kernel split over
    two space devices, against the 1x1 step and JAX's global step."""
    rng = np.random.default_rng(5)
    ref = layers.init_flax_style(pose.PoseNet(width=32), torch.Generator().manual_seed(4))
    tree = convert.variables_to_reference(ref)
    x, gt = scenes.pose_training_batch(rng, 4, 64, 64)
    m22 = host_cpu_mesh(4, n_space=2)
    jm22 = jcreate_mesh(2, 2, devices=jax.devices("cpu")[:4])
    paths = {key: path[1:] for path, key in convert.reference_leaves(ref) if path[0] == "params"}
    _, jsh = jtrain.shard_variables(jm22, tree["params"])
    jspecs = {tuple(k.key for k in p): tuple(s.spec) for p, s in jax.tree_util.tree_flatten_with_path(
        jsh, is_leaf=lambda n: hasattr(n, "spec"))[0]}
    placed, specs = models.shard_variables(m22, dict(ref.named_parameters()))
    assert {paths[k]: v for k, v in specs.items()} == jspecs
    split = [k for k, v in specs.items() if v == (None, "space")]
    assert split == ["Dense_1.weight"]
    w = ref.get_parameter("Dense_1.weight").detach()
    shards = placed["Dense_1.weight"].shards
    assert sorted(shards) == [(0, 0), (0, 1)] and all(t.requires_grad for t in shards.values())
    assert torch.equal(shards[(0, 0)], w[:128]) and torch.equal(shards[(0, 1)], w[128:])
    jput = jtrain.put_batch(jm22, x)
    put = models.put_batch(m22, x)
    for pos in np.ndindex(2, 2):
        index = jput.sharding.devices_indices_map(x.shape)[jm22.devices[pos]]
        assert put.sharding.devices_indices_map(x.shape)[pos] == index
        assert np.array_equal(put.shards[pos].numpy(), x[index])

    def port_steps(mesh):
        net = pose.PoseNet(width=32)
        net.load_state_dict(ref.state_dict())
        net.eval()
        init, step = models.make_train_step(
            mesh, lambda v, a: torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,)),
            lambda out, g: pose.pose_loss(out, g), lambda p: torch.optim.Adam(p, lr=1e-3))
        state = init({"params": dict(net.named_parameters()), "batch_stats": dict(net.named_buffers())})
        losses = []
        for inputs in (x, put):  # a host batch, then put_batch's shards (the same frames)
            state, loss = step(state, inputs if mesh is m22 else x, gt)
            losses.append(loss.item())
        whole = {k: (v.gather("cpu") if isinstance(v, ShardedTensor) else v).detach() for k, v in state.params.items()}
        return losses, whole, state

    one_losses, one, _ = port_steps(create_mesh(1, 1, devices=[CPU]))
    losses, params, state = port_steps(m22)
    assert int(state.step) == 2 and isinstance(state.params["Dense_1.weight"], ShardedTensor)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-6)
    top = max(float(v.abs().max()) for v in one.values())
    assert max(float((params[k] - v).abs().max()) for k, v in one.items()) <= 1e-4 * top

    jmodel = JPoseNet(width=32)
    jinit, jstep = jtrain.make_train_step(cpu_mesh, lambda v, a: jmodel.apply(v, a),
                                          lambda out, g: jpose_loss(out, g), optax.adam(1e-3))
    jstate = jinit(tree)
    jlosses = []
    for _ in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(gt))
        jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for path, key in convert.reference_leaves(ref):
        if path[0] == "params":
            mine = _flax_layout(path, params[key])
            assert np.abs(mine - _at(jstate.params, path[1:])).max() <= 4e-3, path


def _repro_net():
    """ROADMAP C.9's repro: the net in training form, its batch and targets."""
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1d(8), nn.Linear(8, 1)).train()
    x = torch.randn(8, 4) * torch.arange(1, 9)[:, None]
    return net, x, torch.randn(8)


def _repro_steps(n: int):
    """Two SGD steps of the repro on ``host_cpu_mesh(n)``: the losses, the
    first step's gradients and the parameters after each step."""
    net, x, y = _repro_net()
    init, step = models.make_train_step(
        host_cpu_mesh(n), lambda v, a: torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,)),
        lambda out, t: ((out[:, 0] - t) ** 2).mean(), lambda p: torch.optim.SGD(p, lr=0.1))
    state = init({"params": dict(net.named_parameters()), "batch_stats": dict(net.named_buffers())})
    before = {k: v.clone() for k, v in state.batch_stats.items()}
    losses, grads, params = [], None, []
    for _ in range(2):
        state, loss = step(state, x, y)
        losses.append(loss.item())
        grads = grads or {k: p.grad.clone() for k, p in state.params.items()}
        params.append({k: p.detach().clone() for k, p in state.params.items()})
    for k, v in state.batch_stats.items():
        assert torch.equal(v, before[k]), k  # running statistics and num_batches_tracked unmoved
    return losses, grads, params


def test_make_train_step_batch_norm_in_training_one_device_is_the_plain_step():
    net, x, y = _repro_net()
    loss = ((net(x)[:, 0] - y) ** 2).mean()
    loss.backward()
    losses, grads, _ = _repro_steps(1)
    assert losses[0] == loss.item()
    for k, p in net.named_parameters():
        assert torch.equal(grads[k], p.grad), k


@pytest.mark.parametrize("n", [2, 4])
def test_make_train_step_batch_norm_in_training_takes_the_whole_batch(n):
    one_losses, one_grads, one_params = _repro_steps(1)
    losses, grads, params = _repro_steps(n)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5, atol=1e-6)
    for k, g in one_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, a):
            a = fnn.Dense(8)(a)
            return fnn.Dense(1)(fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)(a))

    net, x, y = _repro_net()
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    tree = {"params": {"Dense_0": {"kernel": sd["0.weight"].T, "bias": sd["0.bias"]},
                       "BatchNorm_0": {"scale": sd["1.weight"], "bias": sd["1.bias"]},
                       "Dense_1": {"kernel": sd["2.weight"].T, "bias": sd["2.bias"]}},
            "batch_stats": {"BatchNorm_0": {"mean": sd["1.running_mean"], "var": sd["1.running_var"]}}}
    jnet = Net()
    jinit, jstep = jtrain.make_train_step(
        jcreate_mesh(n, 1, devices=jax.devices("cpu")[:n]),
        lambda v, a: jnet.apply(v, a, mutable=["batch_stats"])[0],
        lambda out, t: jnp.mean((out[:, 0] - t) ** 2), optax.sgd(0.1))
    jstate = jinit(tree)
    names = {"0.weight": ("Dense_0", "kernel"), "0.bias": ("Dense_0", "bias"), "1.weight": ("BatchNorm_0", "scale"),
             "1.bias": ("BatchNorm_0", "bias"), "2.weight": ("Dense_1", "kernel"), "2.bias": ("Dense_1", "bias")}
    for i in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
        np.testing.assert_allclose(losses[i], float(jloss), rtol=1e-5, atol=1e-6)
        for k, path in names.items():
            ref = _at(jstate.params, path)
            mine = params[i][k].numpy()
            np.testing.assert_allclose(mine.T if mine.ndim == 2 else mine, ref, rtol=1e-5, atol=1e-6, err_msg=k)


def test_make_train_step_pose_net_in_training_on_a_2x2_mesh(posenet):
    def grads(mesh):
        net = _port(posenet["tree"]).train()
        init, step = models.make_train_step(
            mesh, lambda v, a: torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,),
                                                          {"return_heatmap": True}),
            lambda out, g: pose.pose_loss_full(out[0], out[1], g), lambda p: torch.optim.SGD(p, lr=0.0))
        state = init({"params": dict(net.named_parameters()), "batch_stats": dict(net.named_buffers())})
        before = {k: v.clone() for k, v in state.batch_stats.items()}
        state, loss = step(state, posenet["x"], posenet["gt"])
        assert all(torch.equal(v, before[k]) for k, v in state.batch_stats.items())
        return loss.item(), {k: p.grad for k, p in state.params.items()}, net

    one_loss, one, _ = grads(create_mesh(1, 1, devices=[CPU]))
    loss, mine, net = grads(host_cpu_mesh(4, n_space=2))
    np.testing.assert_allclose(loss, one_loss, rtol=1e-5, atol=1e-6)
    for k, g in one.items():
        np.testing.assert_allclose(mine[k].numpy(), g.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(loss, posenet["loss"], rtol=1e-5)
    floor = 1e-5 * max(np.abs(g).max() for g in jax.tree_util.tree_leaves(posenet["grads"]))
    for path, key in convert.reference_leaves(net):
        if path[0] == "params":
            ref = _at(posenet["grads"], path[1:])
            err = np.abs(_flax_layout(path, mine[key]) - ref).max()
            assert err <= max(1e-2 * np.abs(ref).max(), floor), (path, err)


@pytest.mark.parametrize("batch_norm", [True, False])
def test_make_train_step_probes_for_batch_statistics_once(batch_norm):
    """On two data devices a net with a batch norm in training form is
    probed in its first step only (the probe stops at the batch norm, and
    that step and the next run the whole batch on one device: 3 calls of
    ``apply_fn``); a net without one runs each share each step (4 calls)."""
    net, x, y = _repro_net()
    if not batch_norm:
        net = nn.Sequential(net[0], net[2])
    calls = []

    def apply_fn(v, a):
        calls.append(a.shape[0])
        return torch.func.functional_call(net, {**v["params"], **v["batch_stats"]}, (a,))

    init, step = models.make_train_step(host_cpu_mesh(2), apply_fn, lambda out, t: ((out[:, 0] - t) ** 2).mean(),
                                        lambda p: torch.optim.SGD(p, lr=0.1))
    state = init({"params": dict(net.named_parameters()), "batch_stats": dict(net.named_buffers())})
    for _ in range(2):
        state, _ = step(state, x, y)
    assert calls == ([4, 8, 8] if batch_norm else [4, 4, 4, 4])
