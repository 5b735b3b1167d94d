"""Public entry points for the port's kernels.

Each op picks its path from the device of the tensors it is given: CPU
tensors take the plain PyTorch version, CUDA tensors the hand-written
kernel, which either launches or raises.  Nothing falls back from one to
the other.  ``meta`` tensors (the dry-run's) raise: the dry-run runs the
model's plain functions (``impl="xla"``).

``attention`` and ``selective_scan`` also take DTensors whose op is local
under their placements: on every mesh dim of more than one rank, all
inputs replicated, or split along the batch, or (attention) along the
heads with the query and key/value heads divided alike, or (scan) along
the channels.  The op then runs on each rank's local shard (the kernel or
the plain version, by the shard's device) and its result is wrapped back
with the placements the inputs imply.  Any other placement raises and
names it: nothing is gathered behind the caller's back.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from . import flash_attention as _fa
from . import hlem_score as _hlem
from . import ssm_scan as _ssm


def hlem_score(free: torch.Tensor, mask: torch.Tensor,
               spot_frac: torch.Tensor, alpha: float) -> torch.Tensor:
    """HLEM-VMP host scores (paper Eqs. 3-11) for one VM: (n,) float64."""
    if free.device.type == "cpu":
        return _hlem.hlem_score_ref(free, mask, spot_frac, alpha)
    return _hlem.hlem_score(free, mask, spot_frac, alpha)


def hlem_score_batch(free: torch.Tensor, masks: torch.Tensor,
                     spot_frac: torch.Tensor,
                     alphas: torch.Tensor) -> torch.Tensor:
    """HLEM-VMP host scores for B VMs against shared host state: (B, n)
    float64."""
    if free.device.type == "cpu":
        return _hlem.hlem_score_batch_ref(free, masks, spot_frac, alphas)
    return _hlem.hlem_score_batch(free, masks, spot_frac, alphas)


def hlem_upload(bufs: "_hlem.UploadBuffers", lo: int, hi: int, rows: int,
                d: int, o_src: int, o_ids: int, k: int,
                planes=None) -> None:
    """A scoring call's upload, at byte offsets into ``bufs`` (a device
    and a host byte buffer of one layout): for k > 0 the k rows of the
    pool's ``planes`` (numpy (2, rows, d) f64) whose i32 ids are at
    ``host[o_ids]`` gathered into ``host[o_src]``; ``host[lo:hi]`` copied to
    ``dev[lo:hi]``; the rows written into the mirror's planes, f64
    (2, rows, d) at ``dev[0]`` (on the card ``hlem_score.upload``)."""
    if bufs.cuda:
        return _hlem.upload(bufs, lo, hi, rows, d, o_src, o_ids, k, planes)
    host, dev = bufs.host, bufs.dev
    if k:
        h = host.numpy()
        _hlem.mirror_gather_ref(
            h[o_src:o_ids].view(np.float64).reshape(2, k, d), planes,
            h[o_ids:o_ids + 4 * k].view(np.int32))
    dev[lo:hi].copy_(host[lo:hi])
    if k:
        _hlem.mirror_scatter_ref(
            dev[:16 * rows * d].view(torch.float64).view(2, rows, d),
            dev[o_src:o_ids].view(torch.float64).view(2, k, d),
            dev[o_ids:o_ids + 4 * k].view(torch.int32))


def _no_meta(t: torch.Tensor, op: str) -> None:
    if t.device.type == "meta":
        raise ValueError(f"{op} got a meta tensor: the kernels run on data; "
                         "trace with the model's impl='xla'")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention with GQA broadcast, end-aligned positions:
    q (B,H,Tq,dh), k/v (B,Hkv,Tk,dh) -> (B,H,Tq,dh) in q's dtype."""
    if isinstance(q, DTensor):
        pl = _local_placements("attention", (q, k, v), {
            # per input, the placements under which the op is local
            "batch": (Shard(0), Shard(0), Shard(0)),
            "heads": (Shard(1), Shard(1), Shard(1)),
        }, divides={"heads": (q.shape[1], k.shape[1])})
        out = attention(q.to_local(), k.to_local(), v.to_local(),
                        causal=causal, window=window)
        return _wrap(out, q, pl[0])
    _no_meta(q, "attention")
    if q.device.type == "cpu":
        return _fa.mha_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def selective_scan(x, dt, a, b, c, d, h0=None):
    """Mamba-1 selective scan: (y (B,T,Dm) in x's dtype, hT (B,Dm,N) f32)."""
    if isinstance(x, DTensor):
        args = (x, dt, a, b, c, d) + ((h0,) if h0 is not None else ())
        r = Replicate()
        pl = _local_placements("selective_scan", args, {
            # x, dt, a, b, c, d[, h0]
            "batch": (Shard(0), Shard(0), r, Shard(0), Shard(0), r, Shard(0)),
            "channels": (Shard(2), Shard(2), Shard(0), r, r, Shard(0),
                         Shard(1)),
        })
        y, h_t = selective_scan(*(t.to_local() for t in args[:6]),
                                h0.to_local() if h0 is not None else None)
        h_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
                else r for p in pl[0]]
        return _wrap(y, x, pl[0]), _wrap(h_t, x, h_pl,
                                         (x.shape[0], x.shape[2], a.shape[1]))
    _no_meta(x, "selective_scan")
    if x.device.type == "cpu":
        return _ssm.ssm_scan_ref(x, dt, a, b, c, d, h0)
    return _ssm.ssm_scan(x, dt, a, b, c, d, h0)


def _local_placements(op: str, args: Sequence[torch.Tensor],
                      splits: dict, divides: Optional[dict] = None):
    """Per input, its placements, after checking that the op is local
    under them: on each mesh dim of more than one rank, every input is
    replicated or every input is split as one entry of ``splits`` gives
    (and, for ``divides[name]``, those sizes divide by the dim's ranks)."""
    mesh = args[0].device_mesh
    if not all(isinstance(t, DTensor) and t.device_mesh == mesh for t in args):
        raise ValueError(f"{op}: every input must be a DTensor on one mesh")
    got = [t.placements for t in args]
    for j in range(mesh.ndim):
        if mesh.size(j) == 1:
            continue
        at = tuple(p[j] for p in got)
        if all(p == Replicate() for p in at):
            continue
        name = next((n for n, want in splits.items()
                     if at == tuple(want[:len(at)])), None)
        if name is None or any(
                s % mesh.size(j) for s in (divides or {}).get(name, ())):
            raise ValueError(
                f"{op}: placements {at} on mesh dim "
                f"{mesh.mesh_dim_names[j]!r} ({mesh.size(j)} ranks) are not "
                f"local to the op; redistribute the inputs first")
    return got


def _wrap(local: torch.Tensor, like: DTensor,
          placements: Sequence[Placement], shape=None) -> DTensor:
    """``local`` as a DTensor on ``like``'s mesh; ``shape`` the global
    shape (default: ``like``'s, with ``local``'s dtype)."""
    shape = torch.Size(shape or like.shape)
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())
