"""Per-device flops, memory bytes and collective bytes of a torch step.

The counterpart of the reference package's ``launch/hlo_analyzer.py``,
which parses a partitioned, optimized HLO module.  A torch step has no
HLO: ``analyze(fn, *args)`` runs ``fn`` once under two
``TorchDispatchMode``s.  The upper one sees every op the program issues,
DTensor ops at their global shapes; the lower one hands DTensor ops on to
DTensor's dispatch and sees the functional collectives a rank issues for
them.  The values are per device, as the reference's are:

* ``flops``: the matmul-class ops (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, fused attention) by ``torch.utils.flop_counter``'s
  formulas at the global shapes (as ``FlopCounterMode`` counts a DTensor
  op), divided by the mesh's size: the step's flops spread evenly over the
  ranks, so per device x ranks is the unsharded step's count whatever the
  mesh.  Work a rank repeats on replicated data (heads or experts its axis
  does not divide) is not in it; the reference counts ``dot`` and
  ``convolution`` per device.
* ``hbm_bytes``: every op's tensor operands and results once each, a
  DTensor's as rank 0's shard, views and collectives left out.  An unfused
  count: an upper bound on the bytes a rank moves, not the reference's
  fusion-boundary count, and not comparable with it.
* collectives: every functional collective a rank issues
  (``_c10d_functional.*``), by kind, with its operand bytes, as the
  reference sums collective operands (an all-gather's shard, a
  reduce-scatter's or all-reduce's whole input).

The ops DTensor's sharding propagation runs on FakeTensors, on first sight
of an op, are not counted: no rank executes them.

Inputs may be ``meta`` tensors on a fake process group (the dry-run): the
ops then run on shapes only and the collectives move nothing.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: functional-collective op name fragments -> the reference's kind names
_COLLECTIVES = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"),
                ("broadcast", "collective-permute"),
                ("permute", "collective-permute"))


@dataclass
class HloAnalysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    #: op name -> [calls, flops, bytes] (collectives: operand bytes)
    per_op: Dict[str, List[float]] = field(default_factory=dict)

    def asdict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
            "collective_counts": dict(self.collective_counts),
        }

    @classmethod
    def from_ops(cls, per_op: Dict[str, List[float]]) -> "HloAnalysis":
        """Totals from per-op counts (``per_op`` of an earlier analysis)."""
        out = cls(per_op={k: list(v) for k, v in per_op.items()})
        for name, (calls, flops, nbytes) in per_op.items():
            kind = collective_kind(name)
            if kind is None:
                out.flops += flops
                out.hbm_bytes += nbytes
                continue
            out.collective_bytes += nbytes
            out.collective_by_kind[kind] = (
                out.collective_by_kind.get(kind, 0.0) + nbytes)
            out.collective_counts[kind] = (
                out.collective_counts.get(kind, 0.0) + calls)
        return out


def collective_kind(op_name: str):
    """The reference's collective kind of a functional-collective op name
    (``_c10d_functional.all_reduce.default``), else None."""
    if not op_name.startswith(("_c10d_functional.", "c10d_functional.")):
        return None
    return next((kind for frag, kind in _COLLECTIVES if frag in op_name),
                None)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _local_bytes(t: torch.Tensor) -> int:
    """Bytes of rank 0's shard of ``t`` (all of it for a plain tensor)."""
    n = t.numel()
    if isinstance(t, DTensor):
        shape = list(t.shape)
        for j, p in enumerate(t.placements):
            if isinstance(p, Shard):
                shape[p.dim] = -(-shape[p.dim] // t.device_mesh.size(j))
        n = 1
        for d in shape:
            n *= d
    return n * t.element_size()


#: composite ops that reach a mode undecomposed under inference_mode and
#: hold matmuls: counted through what they decompose into
_COMPOSITE = {torch.ops.aten.matmul, torch.ops.aten.einsum,
              torch.ops.aten.linear}


class _Ops(TorchDispatchMode):
    """Counts the ops the program issues: DTensor ops at their global
    shapes (flops divided by the mesh size, bytes of the local shards) and
    plain ops as they are.  The local ops DTensor runs for them pass below
    this mode (it is off while it handles an op)."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _COMPOSITE:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = str(func)
        outs = _tensors(out)
        if not outs or name.startswith(("_c10d_functional.",
                                        "c10d_functional.")):
            return out          # queries; collectives are _Collectives'
        ins = _tensors((args, kwargs))
        rec = self.ops[name]
        rec[0] += 1
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            mesh = next((t.device_mesh for t in ins if isinstance(t, DTensor)),
                        None)
            rec[1] += flops / mesh.size() if mesh is not None else flops
        if not func.is_view:
            rec[2] += sum(map(_local_bytes, ins)) + sum(map(_local_bytes, outs))
        return out


class _Collectives(TorchDispatchMode):
    """Below ``_Ops``: hands DTensor ops to DTensor (``NotImplemented``),
    so that the collectives it issues for them come back here, and counts
    every functional collective a rank issues."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0, 0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if any(type(t) not in (torch.Tensor, torch.nn.Parameter)
               for t in _tensors(out)):
            return out          # FakeTensors: sharding propagation
        name = str(func)
        if collective_kind(name) is not None:
            ins = _tensors((args, kwargs))
            rec = self.ops[name]
            rec[0] += 1
            rec[2] += _local_bytes(ins[0]) if ins else 0
        return out


def analyze(fn, *args, **kwargs) -> HloAnalysis:
    """Runs ``fn(*args, **kwargs)`` once and returns what one rank did:
    flops, memory bytes and collective bytes by kind (see the module
    docstring)."""
    coll, ops = _Collectives(), _Ops()
    with coll, ops:
        fn(*args, **kwargs)
    counts = dict(ops.ops)
    counts.update(coll.ops)
    return HloAnalysis.from_ops({k: v for k, v in counts.items() if v[0]})
