"""Carry the reference package's parameters over into the port's ``Model``.

The reference's ``init_params`` returns a nested dict; with
``scan_layers=True`` the per-layer parameters are stacked on a leading L
axis under ``"layers"``, otherwise ``"layers"`` is a list of per-layer
dicts.  Given that tree with numpy leaves (``jax.tree.map(np.asarray, ...)``),
``params_from_jax`` builds the port's model on a device.  Key paths map one
to one onto ``state_dict`` keys (``layers.<i>.<path>``), and every parameter
keeps its dtype: the norms, ``dt_bias``, ``a_log``, ``d_skip`` and
``router`` in f32, the rest in ``cfg.dtype``.

``param_leaves`` views the port's model in the reference's leaf naming (the
optimizer's tree), and ``train_state_from_jax`` carries a whole reference
``TrainState`` over: parameters, optimizer moments and step.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple, Union

import numpy as np
import torch

from .config import ArchConfig
from .layers import F32_PARAMS, param_dtype
from .model import Model


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def flatten_jax_params(cfg: ArchConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """``state_dict``-style keys -> numpy arrays, the stacked layer axis
    split into one entry per layer."""
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in _leaves({k: v for k, v in tree.items() if k != "layers"}):
        flat[key] = np.asarray(leaf)
    layers = tree["layers"]
    if isinstance(layers, Mapping):       # stacked: leading L axis
        for key, leaf in _leaves(layers):
            arr = np.asarray(leaf)
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"layers.{key}: leading axis {arr.shape[0]} "
                                 f"!= n_layers {cfg.n_layers}")
            for i in range(cfg.n_layers):
                flat[f"layers.{i}.{key}"] = arr[i]
    else:
        for key, leaf in _leaves(list(layers), "layers."):
            flat[key] = np.asarray(leaf)
    return flat


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: widen exactly
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a writable copy


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, tree: Mapping, device=None) -> Model:
    """The port's ``Model`` holding the reference's parameters ``tree``."""
    flat = flatten_jax_params(cfg, tree)
    model = Model(cfg, device)
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unexpected {unexpected}")
    for key, arr in flat.items():
        want = torch.float32 if key.rsplit(".", 1)[-1] in F32_PARAMS else param_dtype(cfg)
        src = _to_tensor(arr)
        if src.dtype != want:
            raise ValueError(f"{key} is {src.dtype} in the reference tree, "
                             f"expected {want}")
        if tuple(src.shape) != tuple(state[key].shape):
            raise ValueError(f"{key} has shape {tuple(src.shape)}, expected "
                             f"{tuple(state[key].shape)}")
        state[key].copy_(src)
    return model


def param_leaves(cfg: ArchConfig, model: Model
                 ) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
    """The model's parameters under the reference's leaf names: with
    ``scan_layers`` the layers' tensors of one parameter form one leaf,
    ``layers.<path>``, a list in layer order (the reference stacks them on
    a leading L axis); otherwise each is its own leaf, ``layers.<i>.<path>``.
    The tensors are the model's own, not copies."""
    out: Dict[str, Any] = {}
    for key, p in model.named_parameters():
        if cfg.scan_layers and key.startswith("layers."):
            out.setdefault("layers." + key.split(".", 2)[2], []).append(p)
        else:
            out[key] = p
    return out


@torch.no_grad()
def train_state_from_jax(cfg: ArchConfig, state: Any, device=None):
    """The port's ``TrainState`` holding the reference's ``TrainState``
    ``state`` (numpy leaves): the parameters (grads on, as
    ``train.init_train_state`` sets them), the AdamW ``m``/``v`` or
    Adafactor ``row``/``col`` in their stacked leaf shapes and dtypes, and
    the step counts.  ``rng`` is a fresh generator on ``device``."""
    from ..train.optimizer import AdafactorState, AdamWState
    from ..train.train_step import TrainState

    model = params_from_jax(cfg, state.params, device)
    for p in model.parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
    names = list(param_leaves(cfg, model))

    def tree(t):
        flat = dict(_leaves(t))
        if set(flat) != set(names):
            raise ValueError(f"optimizer tree keys {sorted(flat)} differ from "
                             f"the parameter leaves {sorted(names)}")
        return {k: _to_tensor(np.asarray(flat[k])).to(device) for k in names}

    opt = state.opt
    if cfg.optimizer == "adamw":
        new_opt = AdamWState(int(opt.step), tree(opt.m), tree(opt.v))
    else:
        new_opt = AdafactorState(int(opt.step), tree(opt.row), tree(opt.col))
    gen = torch.Generator(device=device or "cpu").manual_seed(0)
    return TrainState(model, new_opt, int(state.step), gen)
