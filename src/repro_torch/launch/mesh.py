"""Meshes and process groups.

A port of the reference package's ``launch/mesh.py``.  ``make_production_mesh``
is a FUNCTION, not a module constant, so importing this module never touches
``torch.distributed``.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, which the caller starts first:

* ``init_group`` for real ranks: gloo on the CPU, NCCL on the card;
* ``fake_group`` for the dry-run: a process group of any world size that
  moves no data, in this one process (paired with ``meta`` tensors, it
  traces a step over 256 or 512 ranks without allocating a byte);
* ``spawn`` starts ``world`` ranks, each in a process of its own, joined
  through a ``file://`` store.

JAX gets these from its runtime: ``jax.devices()`` is every device of every
host.  Here a rank is a process and a mesh's ``device_type`` is the device
its ranks compute on.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: backend of real ranks per device type
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """Single pod: (16, 16) data x model = 256 ranks.
    Multi-pod: (2, 16, 16) pod x data x model = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over ranks ``0..prod(shape)-1`` of the default
    group (e.g. (4, 2) under ``fake_group(8)``).  Every rank of the group
    must call it, in the same order: it creates a subgroup per mesh axis."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a mesh "
                           "of CPU ranks")
    n = 1
    for s in shape:
        n *= s
    have = available_devices(device)
    if n > have:
        raise ValueError(f"need {n} devices, have {have}")
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(device, ranks, mesh_dim_names=axes)


def available_devices(device: str = "cuda") -> int:
    """The world size of the default group, else the device count of
    ``device``'s type (1 for the CPU)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------
def init_group(backend: str, rank: int, world: int,
               init_method: Optional[str] = None) -> None:
    """Starts the default group for this rank.  Without ``init_method`` a
    one-rank group needs no rendezvous: its store lives in this process."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if init_method is None:
        if world != 1:
            raise ValueError("a group of more than one rank needs an "
                             "init_method every rank shares")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def ensure_group(device: str = "cuda") -> bool:
    """Starts a one-rank default group (this process alone, the backend
    of ``device``'s type) unless a group is running; returns whether it
    started one, which the caller then ends with ``destroy_group``."""
    if dist.is_initialized():
        return False
    init_group(BACKENDS[torch.device(device).type], 0, 1)
    return True


def destroy_group() -> None:
    """Ends the default group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world: int):
    """A default group of ``world`` ranks in this process that moves no
    data (this process is rank 0): collectives on it return at once, so a
    step traced over it with ``meta`` tensors counts what every rank would
    do.  Ends the group on exit."""
    # torch's fake backend lives in its testing package; nothing else in
    # the port imports a private torch module
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already running; "
                           "the dry-run needs one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_method: str, args: tuple) -> None:
    if backend == "gloo":     # ranks share the host's cores, as torchrun's do
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_group(backend, rank, world, init_method)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "nccl", args: tuple = (),
          timeout: float = 600.0) -> None:
    """Runs ``fn(rank, world, *args)`` in ``world`` processes, each the
    rank of a ``backend`` group (gloo on the CPU, NCCL on cards), and waits
    for all of them.  ``fn`` must be importable (a module-level function).
    Raises if a rank fails; kills every rank and raises ``TimeoutError``
    after ``timeout`` seconds."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as d:
        init_method = f"file://{os.path.join(d, 'store')}"
        ctx = torch.multiprocessing.spawn(
            _rank_main, args=(fn, world, backend, init_method, args),
            nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
