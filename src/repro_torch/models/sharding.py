"""Logical-axis sharding rules on ``DeviceMesh`` + DTensor.

A port of the reference package's ``models/sharding.py``.  The reference
pairs jit with NamedSharding and with_sharding_constraint; here a sharded
tensor is a DTensor and a constraint is a ``redistribute``.  ``spec``
resolves a tensor's logical axis names to one DTensor placement per mesh
dimension: ``Shard(i)`` where tensor dim ``i`` maps to that mesh axis, else
``Replicate()``; a tuple axis such as ``("pod", "data")`` shards one tensor
dim over several mesh dims, major to minor in mesh order.

GSPMD pads a dim its mesh axes do not divide; at the argument boundary
the reference replicates such a dim instead (``divisible_spec``):
granite's 49 155 vocab or 24 heads and hymba's 25 heads on a 16-way model
axis.  DTensor would shard it unevenly, and then refuses most views of the
uneven dim, so the port applies ``divisible_spec`` everywhere: to every
tensor it places (``attach``, ``shard_params``, ``place``) and to every
``constrain``.  A rank's shard is always exact.  ``reshape`` is a view that
first replicates a sharded dim the new shape cannot keep sharded (24 heads
of 64 split from a 1 536-wide projection sharded 16 ways): GSPMD would pad
there, DTensor gathers.

Logical axes:
  batch    -> ("pod", "data")   activations' batch dim
  seq      -> None (or "model" under sequence-parallel contexts)
  embed    -> None              residual stream
  heads/kv_heads/ff/vocab/experts -> "model"   tensor parallel
  fsdp     -> "data"            ZeRO-3 parameter sharding dim
  groups   -> ("pod", "data")   MoE token groups

Without an active mesh (``use_mesh``) and on plain tensors every function
here is a no-op, so unsharded code runs exactly as before.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

Axis = Union[str, Tuple[str, ...], None]
Placements = Tuple[Placement, ...]

DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "groups": ("pod", "data"),
    "seq": None,
    "res_seq": None,            # residual-stream seq dim; "model" under seq-parallel
    "kv_seq": None,             # decode KV-cache seq dim; "model" for serve cells
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "capacity": None,
    "state": None,
    "conv": None,
    "layers": None,
    "fsdp": "data",
    "replicated": None,
}

_tls = threading.local()


def _state():
    if not hasattr(_tls, "mesh"):
        _tls.mesh = None
        _tls.rules = dict(DEFAULT_RULES)
    return _tls


def set_mesh(mesh: Optional[DeviceMesh], rules: Optional[Dict[str, Axis]] = None):
    st = _state()
    st.mesh = mesh
    st.rules = dict(DEFAULT_RULES)
    if rules:
        st.rules.update(rules)


def current_mesh() -> Optional[DeviceMesh]:
    return _state().mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh], rules: Optional[Dict[str, Axis]] = None):
    st = _state()
    prev = (st.mesh, st.rules)
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        st.mesh, st.rules = prev


@contextlib.contextmanager
def replicate_plain():
    """Inside, a plain tensor that meets a DTensor in an op counts as
    replicated (positions, masks, zeros the model makes).  Unlike torch's
    ``implicit_replication``, which it wraps, it nests: an inner exit does
    not end an outer one."""
    st = _state()
    if getattr(st, "replicating", False):
        yield
        return
    st.replicating = True
    try:
        with implicit_replication():
            yield
    finally:
        st.replicating = False


def _resolve(name: Optional[str], mesh: DeviceMesh) -> Axis:
    if name is None:
        return None
    ax = _state().rules.get(name, None)
    if ax is None:
        return None
    names = mesh.mesh_dim_names
    if isinstance(ax, str):
        return ax if ax in names else None
    present = tuple(a for a in ax if a in names)
    return present if present else None


def _axes(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def resolve(*names: Optional[str]) -> Tuple[Axis, ...]:
    """Logical names -> mesh axis per tensor dim (the reference's
    PartitionSpec entries) under the current mesh and rules; () without a
    mesh."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(_resolve(n, mesh) for n in names)


def placements(axes: Sequence[Axis], mesh: DeviceMesh) -> Placements:
    """Mesh axis per tensor dim -> one placement per mesh dim."""
    out: List[Placement] = [Replicate()] * mesh.ndim
    for i, ax in enumerate(axes):
        for a in _axes(ax):
            j = mesh.mesh_dim_names.index(a)
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two tensor dims "
                                 f"in {tuple(axes)}")
            out[j] = Shard(i)
    return tuple(out)


def spec(*names: Optional[str]) -> Placements:
    """Logical axis names -> DTensor placements under the current
    mesh/rules; () (replicated) without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return placements(resolve(*names), mesh)


def divisible(pl: Sequence[Placement], shape, mesh: DeviceMesh) -> Placements:
    """``pl`` with every ``Shard(i)`` replicated where dim ``i``'s size is
    not divisible by the product of the mesh dims that shard it, or is 1,
    and on every mesh dim of one rank, where a shard is the whole tensor:
    DTensor's views cannot keep a size-1 dim sharded, and older DTensors
    refuse some views of shards even on one rank."""
    ranks: Dict[int, int] = {}
    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            ranks[p.dim] = ranks.get(p.dim, 1) * mesh.size(j)
    bad = {i for i, r in ranks.items() if shape[i] <= 1 or shape[i] % r}
    return tuple(Replicate() if isinstance(p, Shard) and (
        p.dim in bad or mesh.size(j) == 1) else p for j, p in enumerate(pl))


def divisible_spec(shape, names, mesh: DeviceMesh) -> Placements:
    """Resolve logical names to placements, replicating any dim whose size
    is not divisible by its mesh-axis product (the argument-boundary rule:
    a rank's shard is then exact)."""
    axes = [_resolve(n, mesh) for n in tuple(names)[:len(shape)]]
    return divisible(placements(axes, mesh), shape, mesh)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and one placement per mesh dim: where a tensor lives (the
    reference's ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    placements: Placements


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements ``names`` give under the
    active mesh (``divisible_spec`` of its shape); a no-op on a plain
    tensor or without a mesh."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          divisible_spec(tuple(x.shape), names, mesh))


def _groups(src: Sequence[int], dst: Sequence[int]):
    """Pairs of dim lists (src dims, dst dims) whose sizes multiply to the
    same number: the blocks a reshape merges and splits."""
    out, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        si, di = [], []
        a = b = 1
        if i < len(src):
            a, i = src[i], i + 1
            si.append(i - 1)
        if j < len(dst):
            b, j = dst[j], j + 1
            di.append(j - 1)
        while a != b:
            if a < b:
                a, i = a * src[i], i + 1
                si.append(i - 1)
            else:
                b, j = b * dst[j], j + 1
                di.append(j - 1)
        out.append((si, di))
    return out


def _view(x: DTensor, shape: Tuple[int, ...]) -> DTensor:
    mesh = x.device_mesh
    src = tuple(x.shape)
    ranks = {}
    for j, p in enumerate(x.placements):
        if isinstance(p, Shard):
            ranks[p.dim] = ranks.get(p.dim, 1) * mesh.size(j)
    keep = set()
    for si, di in _groups(src, shape):
        for i in si:
            if i not in ranks:
                continue
            same = len(si) == 1 and len(di) == 1
            first = (i == si[0] and di and shape[di[0]] > 1
                     and shape[di[0]] % ranks[i] == 0)
            if same or first:
                keep.add(i)
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim not in keep
               else p for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """``_view`` whose gradient goes back through ``_view`` too: the
    gradient may arrive on placements the backward view cannot keep."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return _view(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _view(g, ctx.src), None


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``; a DTensor first replicates each sharded dim
    that the new shape cannot keep sharded (a DTensor view keeps a shard
    only on a dim it leaves alone, or on the first dim of a block it
    merges or splits, which the shard's ranks must divide), and its
    gradient is reshaped back the same way."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = tuple(torch.empty(tuple(x.shape), device="meta").reshape(shape).shape)
    if x.requires_grad and torch.is_grad_enabled():
        return _Reshape.apply(x, shape)
    return _view(x, shape)


def is_spec_leaf(t) -> bool:
    """Spec leaves are PLAIN tuples of logical names (or empty = replicated).
    NamedTuples (TrainState etc.) are containers, not leaves."""
    return type(t) is tuple and all(n is None or isinstance(n, str) for n in t)


def _zip(tree: Any, spec_tree: Any, fn, module_fn=None) -> Any:
    """``fn(leaf, names)`` over a tree (dict, list, tuple, NamedTuple) and
    its spec tree; a None spec leaves its subtree as it is, and an
    ``nn.Module`` goes to ``module_fn(module, specs)``."""
    if spec_tree is None:
        return tree
    if module_fn is not None and isinstance(tree, nn.Module):
        return module_fn(tree, spec_tree)
    if is_spec_leaf(spec_tree):
        return fn(tree, spec_tree)
    if isinstance(tree, dict):
        return {k: _zip(v, spec_tree[k], fn, module_fn) for k, v in tree.items()}
    if len(tree) != len(spec_tree):
        raise ValueError(f"tree of {len(tree)} vs spec tree of "
                         f"{len(spec_tree)}")
    parts = (_zip(v, s, fn, module_fn) for v, s in zip(tree, spec_tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*parts)
    return type(tree)(parts)


def _map_specs(spec_tree: Any, fn) -> Any:
    if is_spec_leaf(spec_tree):
        return fn(spec_tree)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: _map_specs(v, fn) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(_map_specs(v, fn) for v in spec_tree))
    return type(spec_tree)(_map_specs(v, fn) for v in spec_tree)


def tree_shardings(spec_tree):
    """Map a tree of logical-name tuples to ``NamedSharding``s on the
    current mesh (None without one)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return _map_specs(spec_tree, lambda names: NamedSharding(mesh, spec(*names)))


def constrain_tree(tree, spec_tree):
    """``constrain`` over a tree with a logical-spec tree (e.g. pin a
    gradient accumulator to the parameter shardings so that microbatch
    gradients reduce-scatter instead of all-reducing)."""
    if current_mesh() is None:
        return tree
    return _zip(tree, spec_tree, lambda x, names: constrain(x, *names))


def distribute(t: torch.Tensor, mesh: DeviceMesh,
               pl: Sequence[Placement]) -> DTensor:
    """``t`` (every rank's full copy, or a ``meta`` tensor) as a DTensor
    on ``divisible(pl)``: a meta tensor gives a meta DTensor (nothing
    allocated, no collective); real data is distributed from rank 0's
    copy."""
    pl = divisible(pl, tuple(t.shape), mesh)
    if t.device.type != "meta":
        return distribute_tensor(t.detach(), mesh, pl)
    shape = list(t.shape)
    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(j)
    local_t = torch.empty(shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local_t, mesh, pl, run_check=False,
                              shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def place(t: torch.Tensor, names, mesh: DeviceMesh) -> DTensor:
    """``t`` as a DTensor under ``divisible_spec`` of its logical
    ``names`` (see ``distribute``)."""
    return distribute(t, mesh, divisible_spec(tuple(t.shape), names, mesh))


def set_param(module: nn.Module, key: str, value: torch.Tensor) -> None:
    """Replace the parameter ``key`` (a ``named_parameters`` name) with
    ``value``, keeping its ``requires_grad``."""
    owner_path, _, leaf = key.rpartition(".")
    owner = module.get_submodule(owner_path) if owner_path else module
    old = getattr(owner, leaf)
    setattr(owner, leaf, nn.Parameter(value, requires_grad=old.requires_grad))


def attach(shape_tree, spec_tree):
    """Zip a tree of tensors (``meta`` ones in the dry-run) with a
    logical-spec tree -> the same tree with every tensor placed on the
    current mesh by ``place`` (the dry-run's argument maker).  An
    ``nn.Module`` takes a dict of specs keyed by its parameter names and is
    changed in place; leaves that are not tensors (a step count, a
    generator) need the replicated spec () and stay as they are.  Without
    a mesh the tree comes back unchanged."""
    mesh = current_mesh()
    if mesh is None:
        return shape_tree

    def leaf(x, names):
        if isinstance(x, torch.Tensor):
            return place(x, names, mesh)
        if names:
            raise TypeError(f"spec {names} for a {type(x).__name__} leaf")
        return x

    def module(m: nn.Module, specs: Dict[str, tuple]) -> nn.Module:
        missing = sorted(set(dict(m.named_parameters())) - set(specs))
        if missing:
            raise ValueError(f"no spec for parameters {missing}")
        for key, p in list(m.named_parameters()):
            set_param(m, key, place(p.data, specs[key], mesh))
        return m

    return _zip(shape_tree, spec_tree, leaf, module)


def full(x):
    """A DTensor gathered whole on every rank of its mesh (a collective);
    anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
