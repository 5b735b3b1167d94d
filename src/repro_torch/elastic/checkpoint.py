"""Fault-tolerant checkpointing.

* Atomic: checkpoints are written to ``step_N.tmp`` and renamed only when
  complete — a preemption mid-write never corrupts the latest checkpoint.
* Async: a background thread serializes host copies so the training loop
  resumes immediately (the device→host copy is the only synchronous part).
* Emergency: ``save_on_warning`` is designed to be registered as a market-
  simulator ``vm_interrupted`` listener (or a real SIGTERM handler); it
  performs a synchronous save inside the spot warning window (2 min on AWS,
  30 s on GCP — the paper's "warning time" parameter).
* Carries arbitrary metadata (data-iterator cursor, mesh shape) so restart
  resumes exactly-once data consumption and can elastically re-mesh.

A port of the reference package's ``elastic/checkpoint.py``, same layout and
protocol (``arrays.npz`` with ``leaf_i``, ``meta.json`` with ``step``,
``n_leaves`` and ``written_at``).  A state's leaves, in order: an
``nn.Module``'s ``state_dict`` tensors, a dict's values, a tuple's or
list's items, tensors, Python numbers, and a ``torch.Generator``'s state.  ``save`` copies every leaf to the host before
it returns (the training step updates the parameters in place); numpy has
no bfloat16, so bf16 leaves are widened to float32, which is exact, and
``restore`` casts back to the template's dtype.  ``restore`` loads into the
template's tensors in place, on their devices.

Across ranks (a default process group): a DTensor leaf is saved whole
(``full_tensor()``, a collective its mesh's ranks all make), only rank 0
writes, and a blocking save ends at a barrier that every rank of the group
meets, holding state or not.  ``restore(template, shardings=)`` reads on
every rank it is called on and distributes each leaf onto its
``NamedSharding`` (the argument-boundary rule of ``sharding.divisible``
applied to the saved shape).
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..models.sharding import NamedSharding, distribute, set_param

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree: Any) -> List[Any]:
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flatten(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _flatten(v)]
    if tree is None:
        return []
    return [tree]


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dt, copy=True).numpy()
    return np.array(leaf, copy=True)


@torch.no_grad()
def _unflatten(template: Any, host: List[np.ndarray]) -> Any:
    """``template`` with its leaves loaded from ``host`` (consumed in
    order); tensors are loaded in place."""
    if isinstance(template, nn.Module):
        for t in template.state_dict().values():
            t.copy_(torch.from_numpy(host.pop(0)))
        return template
    if isinstance(template, dict):
        return {k: _unflatten(v, host) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(v, host) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, host) for v in template)
    if template is None:
        return None
    arr = host.pop(0)
    if isinstance(template, torch.Generator):
        template.set_state(torch.from_numpy(arr))
        return template
    if isinstance(template, torch.Tensor):
        template.copy_(torch.from_numpy(arr))
        return template
    return type(template)(arr.item())


def _flatten_shardings(shardings: Any, template: Any) -> List[Any]:
    """One ``NamedSharding`` or None per leaf of ``template``; a module's
    shardings are a dict keyed by parameter name (its buffers: None)."""
    if isinstance(template, nn.Module):
        params = dict(template.named_parameters())
        return [shardings.get(k) if k in params else None
                for k in template.state_dict()]
    if shardings is None or isinstance(shardings, NamedSharding):
        return [shardings] * len(_flatten(template))
    if isinstance(template, dict):
        return [s for k, v in template.items()
                for s in _flatten_shardings(shardings[k], v)]
    if isinstance(template, (tuple, list)):
        return [s for v, sh in zip(template, shardings)
                for s in _flatten_shardings(sh, v)]
    return [shardings]


@torch.no_grad()
def _place(template: Any, host: List[np.ndarray], shard: List[Any]) -> Any:
    """``template`` with its leaves built from ``host`` onto ``shard``'s
    placements (consumed in order); a leaf without a sharding loads in
    place as ``_unflatten`` does."""
    if isinstance(template, nn.Module):
        for key, t in list(template.state_dict().items()):
            arr, sh = host.pop(0), shard.pop(0)
            if sh is None:
                t.copy_(torch.from_numpy(arr))
                continue
            set_param(template, key, distribute(
                torch.from_numpy(arr).to(sh.mesh.device_type, t.dtype),
                sh.mesh, sh.placements))
        return template
    if isinstance(template, dict):
        return {k: _place(v, host, shard) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_place(v, host, shard) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_place(v, host, shard) for v in template)
    if template is None:
        return None
    sh = shard.pop(0)
    if sh is None or not isinstance(template, torch.Tensor):
        return _unflatten(template, host)
    return distribute(
        torch.from_numpy(host.pop(0)).to(sh.mesh.device_type, template.dtype),
        sh.mesh, sh.placements)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------ save
    def save(self, state: Any, step: int, meta: Optional[Dict] = None,
             block: bool = False) -> None:
        """Snapshot to host, then write (async unless block=True).  A
        blocking save first waits for the queued ones, so two writes of one
        step never race and a newer save is never overwritten by an older.

        Across ranks, every rank that holds ``state`` calls it (whole
        DTensors are gathered), rank 0 writes, and a blocking save ends at
        a barrier of the default group: a rank without state calls it with
        ``state=None``."""
        if self._error:
            raise RuntimeError("async checkpoint worker failed") \
                from self._error
        host_leaves = [_to_host(leaf) for leaf in _flatten(state)]
        if _rank() == 0:
            payload = (host_leaves, step, dict(meta or {}))
            if self.async_save and not block:
                self._q.put(payload)
            else:
                if self.async_save:
                    self.wait()
                self._write(*payload)
        if block and dist.is_initialized():
            dist.barrier()

    def save_on_warning(self, state: Any, step: int,
                        meta: Optional[Dict] = None) -> None:
        """Synchronous emergency save (called inside the warning window)."""
        self.save(state, step, dict(meta or {}, emergency=True), block=True)

    def wait(self) -> None:
        """Block until all queued async saves hit disk."""
        self._q.join()
        if self._error:
            raise RuntimeError("async checkpoint worker failed") \
                from self._error

    def _drain(self) -> None:
        while True:
            payload = self._q.get()
            try:
                self._write(*payload)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, host_leaves: List[np.ndarray], step: int,
               meta: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        meta = dict(meta, step=step, n_leaves=len(host_leaves),
                    written_at=time.time())
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: Optional[int] = None) -> Dict:
        """The metadata of a checkpoint (the latest unless ``step``)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into ``template``'s structure (the latest step unless
        ``step``): its tensors are loaded in place, cast to their dtypes.
        With ``shardings`` (a matching tree of ``NamedSharding``s, a module
        taking a dict keyed by parameter name; None for leaves that are not
        tensors), each tensor leaf becomes a DTensor on its sharding
        instead, cast to the template's dtype; the rescale path loads onto
        a different mesh this way.  Every rank of the shardings' meshes
        calls it."""
        meta = self.read_meta(step)
        d = os.path.join(self.dir, f"step_{meta['step']}")
        n = len(_flatten(template))
        if meta["n_leaves"] != n:
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, template {n} — "
                f"architecture/optimizer mismatch")
        with np.load(os.path.join(d, "arrays.npz")) as npz:
            host = [npz[f"leaf_{i}"] for i in range(n)]
        if shardings is None:
            return _unflatten(template, host), meta
        return _place(template, host,
                      _flatten_shardings(shardings, template)), meta
