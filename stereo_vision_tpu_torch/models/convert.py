"""Weights across: the JAX package's variable trees and ultralytics YOLOv8
checkpoints into the port's models.

- :func:`variables_from_reference`: a flax variable tree (``{"params":
  ..., "batch_stats": ...}`` as nested dicts of arrays) -> the state dict of
  the port's model whose module names are the flax names. Conv kernels go
  HWIO -> OIHW, Dense kernels are transposed, BatchNorm's scale / bias /
  mean / var become weight / bias / running_mean / running_var.
- :func:`variables_to_reference`: the way back, a port model -> the
  reference's variable tree in flax's layouts (OIHW -> HWIO, Linear
  weights transposed, running statistics under ``batch_stats``).
- :func:`load_tree`: an npz written by the JAX package's
  ``pretrained.save_tree`` (arrays ``arr_0..`` in ``jax.tree_util``'s
  flatten order) into a port model, without JAX: the leaves are the
  model's flax paths sorted as JAX sorts dict keys at every level
  (``batch_stats`` before ``params``, ``ConvBnSiLU_10`` before
  ``ConvBnSiLU_2``).
- :func:`convert_ultralytics_state_dict` / :func:`load_ultralytics_checkpoint`:
  an ultralytics YOLOv8 detection ``state_dict`` (public v8 layout:
  ``model.0..9`` backbone, ``model.10..21`` neck, ``model.22`` the Detect
  head with its box tower ``cv2.{s}`` and class tower ``cv3.{s}``; its DFL
  weights are fixed and not needed) into the port's ``YOLOv8``, key by
  key.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from stereo_vision_tpu_torch.models.layers import BatchNorm
from stereo_vision_tpu_torch.models.yolov8 import repeats

# flax leaf name -> the port's parameter or buffer name.
_ATTR = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean", "var": "running_var"}
# The flax leaves of each leaf module kind: (collection, leaf name).
_LEAVES = {
    nn.Conv2d: (("params", "kernel"), ("params", "bias")),
    nn.Linear: (("params", "kernel"), ("params", "bias")),
    BatchNorm: (("params", "scale"), ("params", "bias"), ("batch_stats", "mean"), ("batch_stats", "var")),
}


def reference_leaves(model: nn.Module) -> list[tuple[tuple[str, ...], str]]:
    """The model's (flax path, state-dict key) pairs in ``jax.tree_util``'s
    flatten order of the reference's variable tree."""
    out = []
    for name, mod in model.named_modules():
        for col, leaf in _LEAVES.get(type(mod), ()):
            if getattr(mod, _ATTR[leaf], None) is not None:
                out.append(((col, *name.split("."), leaf), f"{name}.{_ATTR[leaf]}"))
    return sorted(out)


def _to_port(leaf: str, a) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a))
    if leaf == "kernel":
        t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.T  # HWIO -> OIHW; (in, out) -> (out, in)
    return t.contiguous()


def _to_reference(leaf: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu()
    if leaf == "kernel":
        a = a.permute(2, 3, 1, 0) if a.ndim == 4 else a.T  # OIHW -> HWIO; (out, in) -> (in, out)
    return np.ascontiguousarray(a.numpy())


def reference_arrays(model: nn.Module) -> list[tuple[tuple[str, ...], np.ndarray]]:
    """The model's (flax path, numpy array in flax's layout) pairs in
    ``jax.tree_util``'s flatten order of the reference's variable tree."""
    state = model.state_dict()
    return [(path, _to_reference(path[-1], state[key])) for path, key in reference_leaves(model)]


def variables_to_reference(model: nn.Module) -> dict[str, Any]:
    """The reference's variable tree of ``model`` (``{"batch_stats": ...,
    "params": ...}``, nested dicts of numpy arrays in flax's layouts), the
    inverse of :func:`variables_from_reference`."""
    tree: dict[str, Any] = {}
    for path, a in reference_arrays(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def variables_from_reference(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The state dict of the port model with the reference's module names,
    from its variable tree (leaves as numpy arrays or anything
    ``np.asarray`` takes); ``model.load_state_dict`` checks names and
    shapes."""
    out = {}
    stack = [((), tree[col]) for col in ("batch_stats", "params") if col in tree]
    while stack:
        path, node = stack.pop()
        for k, v in node.items():
            if isinstance(v, Mapping):
                stack.append((path + (k,), v))
            else:
                out[".".join(path + (_ATTR[k],))] = _to_port(k, v)
    return out


def load_tree(path: str | Path, model: nn.Module) -> nn.Module:
    """Load an npz saved by the reference's ``save_tree`` into ``model``
    (in place, returned), checking the leaf count and every shape."""
    leaves = reference_leaves(model)
    state = model.state_dict()
    with np.load(path) as z:
        arrs = [z[f"arr_{i}"] for i in range(len(z.files))]
    if len(arrs) != len(leaves):
        raise ValueError(f"{path}: {len(arrs)} arrays vs {len(leaves)} leaves — "
                         "weights do not match this model architecture")
    sd = {}
    for a, (p, key) in zip(arrs, leaves):
        t = _to_port(p[-1], a)
        if tuple(t.shape) != tuple(state[key].shape):
            raise ValueError(f"{path}: shape mismatch {a.shape} vs {tuple(state[key].shape)} at {'/'.join(p)}")
        sd[key] = t
    model.load_state_dict(sd)
    return model


def _ultralytics_convs(variant: str) -> tuple[list[tuple[str, str]], list[tuple[str, str]]]:
    """(port module, ultralytics prefix) of every conv + bn and of every
    plain conv of the ultralytics v8 detection layout."""
    n1, n2 = repeats(variant)
    conv_bn = [("ConvBnSiLU_0", "model.0"), ("ConvBnSiLU_1", "model.1")]

    def c2f(name: str, idx: int, n: int) -> None:
        conv_bn.append((f"{name}.ConvBnSiLU_0", f"model.{idx}.cv1"))
        for m in range(n):
            conv_bn.append((f"{name}.Bottleneck_{m}.ConvBnSiLU_0", f"model.{idx}.m.{m}.cv1"))
            conv_bn.append((f"{name}.Bottleneck_{m}.ConvBnSiLU_1", f"model.{idx}.m.{m}.cv2"))
        conv_bn.append((f"{name}.ConvBnSiLU_1", f"model.{idx}.cv2"))

    c2f("C2f_0", 2, n1)
    conv_bn.append(("ConvBnSiLU_2", "model.3"))
    c2f("C2f_1", 4, n2)
    conv_bn.append(("ConvBnSiLU_3", "model.5"))
    c2f("C2f_2", 6, n2)
    conv_bn.append(("ConvBnSiLU_4", "model.7"))
    c2f("C2f_3", 8, n1)
    conv_bn += [("SPPF_0.ConvBnSiLU_0", "model.9.cv1"), ("SPPF_0.ConvBnSiLU_1", "model.9.cv2")]
    c2f("C2f_4", 12, n1)  # P5 up + P4
    c2f("C2f_5", 15, n1)  # P4 up + P3 -> o3
    conv_bn.append(("ConvBnSiLU_5", "model.16"))
    c2f("C2f_6", 18, n1)  # -> o4
    conv_bn.append(("ConvBnSiLU_6", "model.19"))
    c2f("C2f_7", 21, n1)  # -> o5
    plain = []
    for s in range(3):  # the head: flax names continue in call order
        k = 7 + 4 * s
        conv_bn += [(f"ConvBnSiLU_{k}", f"model.22.cv2.{s}.0"), (f"ConvBnSiLU_{k + 1}", f"model.22.cv2.{s}.1"),
                    (f"ConvBnSiLU_{k + 2}", f"model.22.cv3.{s}.0"), (f"ConvBnSiLU_{k + 3}", f"model.22.cv3.{s}.1")]
        plain += [(f"Conv_{2 * s}", f"model.22.cv2.{s}.2"), (f"Conv_{2 * s + 1}", f"model.22.cv3.{s}.2")]
    return conv_bn, plain


def convert_ultralytics_state_dict(state_dict: Mapping[str, Any], variant: str = "m") -> dict[str, torch.Tensor]:
    """An ultralytics YOLOv8 detection ``state_dict`` (keys ``model.N...``,
    tensors or arrays) -> the state dict of the port's ``YOLOv8`` of that
    variant and the checkpoint's class count (both lay convolutions out
    OIHW)."""
    def get(key: str) -> torch.Tensor:
        v = state_dict[key]
        return (v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).float()

    conv_bn, plain = _ultralytics_convs(variant)
    out = {}
    for port, ul in conv_bn:
        out[f"{port}.Conv_0.weight"] = get(f"{ul}.conv.weight")
        for attr in ("weight", "bias", "running_mean", "running_var"):
            out[f"{port}.BatchNorm_0.{attr}"] = get(f"{ul}.bn.{attr}")
    for port, ul in plain:
        out[f"{port}.weight"] = get(f"{ul}.weight")
        if f"{ul}.bias" in state_dict:
            out[f"{port}.bias"] = get(f"{ul}.bias")
    return out


def load_ultralytics_checkpoint(path: str, variant: str = "m") -> dict[str, torch.Tensor]:
    """Load a .pt checkpoint (ultralytics save format) and convert it; the
    file is unpickled, so load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    sd = model.state_dict() if hasattr(model, "state_dict") else model
    return convert_ultralytics_state_dict(sd, variant)
