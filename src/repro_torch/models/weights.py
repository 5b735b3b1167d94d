"""Carry the reference package's parameters over into the port's ``Model``.

The reference's ``init_params`` returns a nested dict; with
``scan_layers=True`` the per-layer parameters are stacked on a leading L
axis under ``"layers"``, otherwise ``"layers"`` is a list of per-layer
dicts.  Given that tree with numpy leaves (``jax.tree.map(np.asarray, ...)``),
``params_from_jax`` builds the port's model on a device.  Key paths map one
to one onto ``state_dict`` keys (``layers.<i>.<path>``), and every parameter
keeps its dtype: the norms, ``dt_bias``, ``a_log``, ``d_skip`` and
``router`` in f32, the rest in ``cfg.dtype``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

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
