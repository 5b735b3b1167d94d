"""Optimizers: AdamW and Adafactor, and the learning-rate schedule.

A port of the reference package's ``train/optimizer.py`` (no optax there,
none here).  A parameter tree is a dict from leaf name to a tensor, or to
a list of tensors that together form one leaf stacked on a leading axis:
the model's per-layer tensors of one parameter, which the reference keeps
stacked under ``scan_layers``.  Optimizer state is stored per leaf in the
leaf's stacked shape, so Adafactor's factored moments and its update
clipping see the leaf the reference sees.

Arithmetic is float32 throughout, as in the reference: the step count and
the schedule are float32 tensors (``torch.pow(b1, t)`` on a float32 ``t``),
never Python doubles.  Updates write the parameters and the moments in
place and return them.

Optimizer states inherit the parameter shardings (ZeRO-3 style): the
``*_specs`` functions derive the state's logical-axis tree from the
parameters', and the updates run unchanged on DTensor leaves.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Tuple, Union

import torch

Leaf = Union[torch.Tensor, List[torch.Tensor]]
Params = Dict[str, Leaf]

F32 = torch.float32


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class AdafactorState(NamedTuple):
    step: int
    # per leaf: for matrices, (row, col) factored second moments; for vectors
    # an unfactored accumulator (stored in `row`, col is a (1,) placeholder).
    row: Dict[str, torch.Tensor]
    col: Dict[str, torch.Tensor]


def _leaf_shape(leaf: Leaf) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return (len(leaf),) + tuple(leaf[0].shape)


def _device(leaf: Leaf) -> torch.device:
    return (leaf if isinstance(leaf, torch.Tensor) else leaf[0]).device


def _stacked(leaf: Leaf, dtype=F32) -> torch.Tensor:
    """The leaf as one tensor in ``dtype`` (a copy)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.to(dtype, copy=True)
    return torch.stack([t.to(dtype) for t in leaf])


@torch.no_grad()
def _write(leaf: Leaf, value: torch.Tensor) -> None:
    """Copy ``value`` (the leaf's stacked shape) into the leaf's tensors."""
    if isinstance(leaf, torch.Tensor):
        leaf.copy_(value)
    else:
        for i, t in enumerate(leaf):
            t.copy_(value[i])


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params: Params, moment_dtype=F32) -> AdamWState:
    zeros = {k: torch.zeros(_leaf_shape(p), dtype=moment_dtype,
                            device=_device(p)) for k, p in params.items()}
    return AdamWState(0, zeros, {k: torch.zeros_like(z)
                                 for k, z in zeros.items()})


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState, *,
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 ) -> Tuple[Params, AdamWState]:
    step = state.step + 1
    for k, p in params.items():
        dev = _device(p)
        t = _scalar(step, dev)
        c1 = 1.0 - torch.pow(_scalar(b1, dev), t)
        c2 = 1.0 - torch.pow(_scalar(b2, dev), t)
        lr_d = lr.to(dev)
        parts = [p] if isinstance(p, torch.Tensor) else p
        gparts = [grads[k]] if isinstance(p, torch.Tensor) else grads[k]
        m, v = state.m[k], state.v[k]
        for i, (pi, gi) in enumerate(zip(parts, gparts)):
            mi, vi = (m, v) if isinstance(p, torch.Tensor) else (m[i], v[i])
            gf = gi.to(F32)
            m2 = b1 * mi.to(F32) + (1 - b1) * gf
            v2 = b2 * vi.to(F32) + (1 - b2) * gf * gf
            mh = m2 / c1
            vh = v2 / c2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pi.to(F32)
            pi.copy_(pi.to(F32) - lr_d * delta)
            mi.copy_(m2)
            vi.copy_(v2)
    return params, AdamWState(step, state.m, state.v)


def adamw_specs(param_specs: Dict[str, tuple]) -> AdamWState:
    """State spec tree matching adamw_init structure."""
    return AdamWState(step=(), m=param_specs, v=param_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------
def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: Params) -> AdafactorState:
    row, col = {}, {}
    for k, p in params.items():
        shape, dev = _leaf_shape(p), _device(p)
        if _factored(shape):
            row[k] = torch.zeros(shape[:-1], dtype=F32, device=dev)
            col[k] = torch.zeros(shape[:-2] + shape[-1:], dtype=F32, device=dev)
        else:
            row[k] = torch.zeros(shape, dtype=F32, device=dev)
            col[k] = torch.zeros((1,), dtype=F32, device=dev)
    return AdafactorState(0, row, col)


@torch.no_grad()
def adafactor_update(params: Params, grads: Params, state: AdafactorState, *,
                     lr: torch.Tensor, decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0, weight_decay: float = 0.0,
                     ) -> Tuple[Params, AdafactorState]:
    step = state.step + 1
    for k, p in params.items():
        dev = _device(p)
        beta = 1.0 - torch.pow(_scalar(step, dev), -decay)  # t^-0.8 schedule
        lr_d = lr.to(dev)
        r, c = state.row[k], state.col[k]
        gf = _stacked(grads[k])
        g2 = gf * gf + eps
        if _factored(gf.shape):
            r2 = beta * r + (1 - beta) * g2.mean(dim=-1)
            c2 = beta * c + (1 - beta) * g2.mean(dim=-2)
            rmean = r2.mean(dim=-1, keepdim=True)
            vhat = (r2 / torch.clamp(rmean, min=eps))[..., None] * c2[..., None, :]
            u = gf / torch.sqrt(torch.clamp(vhat, min=eps))
        else:
            r2 = beta * r + (1 - beta) * g2
            c2 = c
            u = gf / torch.sqrt(torch.clamp(r2, min=eps))
        # update clipping (RMS(u) <= clip_threshold)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        pf = _stacked(p)
        p2 = pf - lr_d * u
        if weight_decay:
            p2 = p2 - lr_d * weight_decay * pf
        _write(p, p2)
        r.copy_(r2)
        c.copy_(c2)
    return params, AdafactorState(step, state.row, state.col)


def adafactor_specs(param_specs: Dict[str, tuple],
                    param_shapes: Dict[str, Tuple[int, ...]]) -> AdafactorState:
    """Spec tree: row drops the last logical axis, col drops the
    second-last (the factored moments take the parameter's axes)."""
    row, col = {}, {}
    for k, names in param_specs.items():
        if _factored(param_shapes[k]):
            row[k] = tuple(names[:-1])
            col[k] = tuple(names[:-2]) + (names[-1],)
        else:
            row[k] = tuple(names)
            col[k] = (None,)
    return AdafactorState(step=(), row=row, col=col)


# ---------------------------------------------------------------------------
# uniform front-end
# ---------------------------------------------------------------------------
def make_optimizer(name: str, **defaults):
    """Returns (init_fn, update_fn, specs_fn(param_specs, param_shapes))."""
    if name == "adamw":
        return (adamw_init, functools.partial(adamw_update, **defaults),
                lambda specs, shapes: adamw_specs(specs))
    if name == "adafactor":
        return (adafactor_init, functools.partial(adafactor_update, **defaults),
                adafactor_specs)
    raise ValueError(name)


def lr_schedule(step, *, peak: float = 3e-4, warmup: int = 100,
                total: int = 10_000, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup + cosine decay, a float32 scalar tensor (on the CPU)."""
    t = torch.as_tensor(step).to(F32)
    warm = t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return peak * torch.where(t < warmup, warm, cos)
