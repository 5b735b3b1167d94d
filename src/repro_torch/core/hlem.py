"""HLEM-VMP host scoring (paper §VI, Eqs. 1–11).

Two implementations of the same math:

* ``hlem_scores_np``    — pure-numpy float64 oracle (readable, used as test
  reference, and the numpy backend's hot path),
* ``hlem_scores_torch`` — the same float64 math on a torch device through
  ``repro_torch.kernels.ops``: the hand-written CUDA kernel on the GPU, its
  plain PyTorch version on the CPU.  It scores the full fleet (masked)
  where the oracle scores the compressed candidate rows; both pick the
  lowest index among equal scores.

All take a *masked* formulation: every host is scored, infeasible hosts carry
``mask=False`` and receive ``-inf`` (``-3.4e38`` on the torch path) so
downstream argmax ignores them.  This is the fixed-shape equivalent of the
paper's explicit candidate-list construction.

Phases (paper §VI-A):
  1. host filtering   — feasibility + RsDiff threshold (Eqs. 1–2), done by the
                        policy layer (see allocation.py), expressed as ``mask``;
  2. load evaluation  — min-max standardize free capacity per dimension (Eq. 3),
                        proportions (Eq. 4), entropy e_d (Eqs. 5–6), variation
                        g_d = 1 - e_d (Eq. 7), weights w_d (Eq. 8);
  3. selection        — host score HS_i = sum_d w_d * C~_i^d (Eq. 9), argmax.

Adjusted variant (§VI-C): spot load SL_i = sum_d w_d * spot_used/total (Eq. 10)
scales the score AHS_i = HS_i * (1 + alpha * SL_i) (Eq. 11).  A *negative*
``alpha`` penalizes spot-heavy hosts, which is the behavior the paper's text
describes ("distribute spot instances more evenly"); the magnitude is tunable.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import ops

_EPS = 1e-12


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------
def hlem_weights_np(free: np.ndarray, mask: np.ndarray):
    """Entropy-derived resource weights over the masked candidate set.

    Returns (standardized capacity C~ (n,D), weights w (D,)).
    """
    free = np.asarray(free, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    n_cand = int(mask.sum())
    d = free.shape[1]
    if n_cand == 0:
        return np.zeros_like(free), np.full(d, 1.0 / d)

    sel = free[mask]  # (m, D)
    lo, hi = sel.min(axis=0), sel.max(axis=0)
    span = hi - lo
    # Eq. 3 — min-max standardization; degenerate dimension -> all equal (1.0)
    c_std = np.where(span > _EPS, (sel - lo) / np.where(span > _EPS, span, 1.0), 1.0)
    # Eq. 4 — proportions over candidates
    col = c_std.sum(axis=0)
    p = np.where(col > _EPS, c_std / np.where(col > _EPS, col, 1.0), 1.0 / n_cand)
    # Eqs. 5–6 — entropy with k = 1/ln(n); n == 1 degenerates to zero entropy
    if n_cand > 1:
        k = 1.0 / np.log(n_cand)
        plogp = np.where(p > _EPS, p * np.log(np.maximum(p, _EPS)), 0.0)
        e = -k * plogp.sum(axis=0)
    else:
        e = np.zeros(d)
    # Eqs. 7–8 — variation factors and weights
    g = 1.0 - e
    gsum = g.sum()
    w = g / gsum if gsum > _EPS else np.full(d, 1.0 / d)

    c_full = np.zeros_like(free)
    c_full[mask] = c_std
    return c_full, w


def hlem_scores_np(
    free: np.ndarray,
    mask: np.ndarray,
    spot_frac: np.ndarray | None = None,
    alpha: float = 0.0,
) -> np.ndarray:
    """Full HLEM-VMP host scores; -inf where mask is False.

    ``spot_frac`` is spot_used/total per (host, dim); with ``alpha != 0`` this
    computes the adjusted score AHS (Eq. 11).
    """
    mask = np.asarray(mask, dtype=bool)
    c_std, w = hlem_weights_np(free, mask)
    hs = c_std @ w  # Eq. 9
    if spot_frac is not None and alpha != 0.0:
        sl = np.asarray(spot_frac, dtype=np.float64) @ w  # Eq. 10
        hs = hs * (1.0 + alpha * sl)  # Eq. 11
    return np.where(mask, hs, -np.inf)


def hlem_select_np(free, mask, spot_frac=None, alpha=0.0) -> int:
    """argmax host id, or -1 if no candidate."""
    if not np.any(mask):
        return -1
    return int(np.argmax(hlem_scores_np(free, mask, spot_frac, alpha)))


def hlem_pick_np(
    free: np.ndarray,
    mask: np.ndarray,
    spot_frac: np.ndarray,
    alpha: float = 0.0,
) -> int:
    """Fused single-VM selection: ``argmax(hlem_scores_np(...))`` without
    materializing full-fleet score arrays.

    Decision-identical to scoring + argmax: the standardization/entropy math
    (Eqs. 3-9) runs on the *compressed* candidate rows — exactly the arrays
    ``hlem_scores_np`` reduces over — and the compressed argmax maps back
    through ``flatnonzero`` (order-preserving, so ties break to the same
    host).  This is the allocation hot path's scorer; ``hlem_scores_np``
    remains the readable oracle."""
    idx = np.flatnonzero(mask)
    return hlem_pick_candidates_np(free, idx, spot_frac, alpha)


class _PickWorkspace:
    """Preallocated scratch for the fused pick — the hot path allocates
    nothing per call (arrays grow monotonically with the fleet)."""

    def __init__(self):
        self.cap = 0

    def ensure(self, m: int, d: int) -> None:
        if m <= self.cap:
            return
        cap = max(m, max(self.cap * 2, 64))
        self.sel = np.empty((cap, d))
        self.tmp = np.empty((cap, d))
        self.tmp2 = np.empty((cap, d))
        self.boolbuf = np.empty((cap, d), dtype=bool)
        self.hs = np.empty(cap)
        self.cap = cap


_WS = _PickWorkspace()


def hlem_pick_candidates_np(
    free: np.ndarray,
    idx: np.ndarray,
    spot_frac: np.ndarray,
    alpha: float = 0.0,
) -> int:
    """:func:`hlem_pick_np` over an explicit candidate-id array (the policy
    layer already holds ``flatnonzero`` of its masks).

    Runs the oracle's exact operation sequence on compressed candidate rows
    with preallocated workspace buffers — values (and therefore the argmax
    decision, ties included) match scoring + argmax bit for bit."""
    m = idx.size
    if m == 0:
        return -1
    if m == 1:
        return int(idx[0])  # degenerate candidate set: any weighting agrees
    free = np.asarray(free, dtype=np.float64)
    d = free.shape[1]
    _WS.ensure(m, d)
    sel = np.take(free, idx, axis=0, out=_WS.sel[:m])
    lo, hi = sel.min(axis=0), sel.max(axis=0)
    span = hi - lo
    nondegen = span > _EPS
    c_std = _WS.tmp[:m]
    np.subtract(sel, lo, out=c_std)
    if nondegen.all():
        np.divide(c_std, span, out=c_std)
    else:
        if alpha == 0.0 and not nondegen.any():
            # all dims degenerate: HS identical for every candidate and the
            # adjustment is off, so the argmax tie-breaks to the first
            return int(idx[0])
        np.divide(c_std, np.where(nondegen, span, 1.0), out=c_std)
        np.copyto(c_std, 1.0, where=~nondegen)
    # each column sums to >= 1 (its max candidate standardizes to 1.0, or the
    # degenerate all-ones case sums to m), so the col > eps guard of the
    # oracle never fires and plain division is value-identical
    col = c_std.sum(axis=0)
    # p reuses the gather buffer (sel is not read past this point); the
    # entropy chain below computes where(p > eps, p*log(max(p, eps)), 0)
    # elementwise-identically with zero allocation
    p = np.divide(c_std, col, out=_WS.sel[:m])
    small = np.less_equal(p, _EPS, out=_WS.boolbuf[:m])
    plogp = np.maximum(p, _EPS, out=_WS.tmp2[:m])
    np.log(plogp, out=plogp)
    np.multiply(p, plogp, out=plogp)
    np.copyto(plogp, 0.0, where=small)
    k = 1.0 / math.log(m)
    e = -k * plogp.sum(axis=0)
    g = 1.0 - e
    gsum = g.sum()
    w = g / gsum if gsum > _EPS else np.full(d, 1.0 / d)
    hs = np.dot(c_std, w, out=_WS.hs[:m])
    if alpha != 0.0:
        sl = np.take(np.asarray(spot_frac, dtype=np.float64), idx, axis=0) @ w
        hs = hs * (1.0 + alpha * sl)
    return int(idx[np.argmax(hs)])


#: fleet-size crossover for the batched numpy scorer: above this many hosts
#: the (B, n, D) broadcast core loses to a compressed per-row pass (its
#: masked intermediates thrash cache, while the per-row path reduces over the
#: compressed candidate set) — measured ~1.4-1.9x per-row advantage at
#: n >= 1000 for B in 4..32, batch advantage up to 2.2x at n <= 300.
BATCH_NP_N_CUTOVER = 512


def hlem_scores_batch_np(
    free: np.ndarray,          # (n, D) shared host state
    masks: np.ndarray,         # (B, n) per-VM candidate masks
    spot_frac: np.ndarray,     # (n, D)
    alphas: np.ndarray | float = 0.0,   # (B,) or scalar per-VM adjustment
    n_cutover: int | None = None,       # override BATCH_NP_N_CUTOVER (tests)
) -> np.ndarray:               # (B, n) scores, -inf outside each row's mask
    """Score B pending VMs against the same host state in one pass.

    Row b equals ``hlem_scores_np(free, masks[b], spot_frac, alphas[b])`` up
    to summation order (each row's entropy weights are derived from its own
    candidate set, Eqs. 3-9; Eq. 11 applied with the row's alpha).  This is
    the oracle for the batched Pallas kernel and the engine of the batched
    resubmission path.

    Large fleets (``n > BATCH_NP_N_CUTOVER``) route through the compressed
    per-row oracle instead of the broadcast core (same masked semantics, ulp-
    level summation-order differences — exactly the tolerance the broadcast
    core already carries vs the oracle).
    """
    free = np.asarray(free, dtype=np.float64)
    masks = np.asarray(masks, dtype=bool)
    spot_frac = np.asarray(spot_frac, dtype=np.float64)
    b, n = masks.shape
    d = free.shape[1]
    alphas = np.broadcast_to(np.asarray(alphas, dtype=np.float64), (b,))
    cut = BATCH_NP_N_CUTOVER if n_cutover is None else n_cutover
    if n > cut:
        out = np.empty((b, n))
        for i in range(b):
            out[i] = hlem_scores_np(free, masks[i], spot_frac,
                                    float(alphas[i]))
        return out
    maskf = masks[..., None].astype(np.float64)        # (B, n, 1)
    m = masks.sum(axis=1).astype(np.float64)           # (B,) candidate counts

    # Eq. 3 — per-row min-max standardization over each candidate set
    lo = np.where(masks[..., None], free[None], np.inf).min(axis=1)   # (B, D)
    hi = np.where(masks[..., None], free[None], -np.inf).max(axis=1)
    span = hi - lo
    degen = span <= _EPS
    c = np.where(degen[:, None, :], 1.0,
                 (free[None] - lo[:, None]) / np.where(degen, 1.0, span)[:, None])
    c = c * maskf
    # Eq. 4 — proportions over each row's candidates
    col = c.sum(axis=1)                                # (B, D)
    p = np.where(col[:, None] > _EPS,
                 c / np.where(col > _EPS, col, 1.0)[:, None],
                 maskf / np.maximum(m, 1.0)[:, None, None])
    p = p * maskf
    # Eqs. 5-6 — entropy with k = 1/ln(m); m <= 1 degenerates to zero entropy
    k = np.where(m > 1.0, 1.0 / np.log(np.maximum(m, 2.0)), 0.0)
    plogp = np.where(p > _EPS, p * np.log(np.maximum(p, _EPS)), 0.0)
    e = -k[:, None] * plogp.sum(axis=1)                # (B, D)
    # Eqs. 7-8 — variation factors and weights
    g = 1.0 - e
    gsum = g.sum(axis=1)
    w = np.where(gsum[:, None] > _EPS,
                 g / np.where(gsum > _EPS, gsum, 1.0)[:, None], 1.0 / d)
    # Eqs. 9-11
    hs = np.einsum("bnd,bd->bn", c, w)
    sl = np.einsum("nd,bd->bn", spot_frac, w)
    hs = hs * (1.0 + alphas[:, None] * sl)
    return np.where(masks, hs, -np.inf)


# ---------------------------------------------------------------------------
# torch (float64 on a device, mask-based, through kernels.ops)
# ---------------------------------------------------------------------------
def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


class _DeviceWorkspace:
    """Pinned host staging and device buffers for the torch scorers.

    The policy layer's host state is numpy float64; each scoring call
    copies it into one pinned buffer and moves it to the device in ONE
    host-to-device copy.  Layout (byte offsets, 16-aligned for the kernel's
    16-byte copies): free (n, D) f64 | spot_frac (n, D) f64 | alphas (B,)
    f64 | masks (B, n) u8.  Buffers grow with the fleet and the batch and
    are never shrunk, so the hot path allocates nothing."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cap = 0
        self.nbytes = 0     # bytes staged by the last call
        self.copied: Optional[torch.cuda.Event] = None

    def _ensure(self, nbytes: int) -> None:
        if nbytes <= self.cap:
            return
        cap = max(nbytes, self.cap * 2, 1 << 16)
        if self.copied is not None:
            self.copied.synchronize()   # the old pinned buffer may be in flight
        self.host = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
        self.host_np = self.host.numpy()
        self.dev = torch.empty(cap, dtype=torch.uint8, device=self.device)
        self.cap = cap

    def stage(self, free, masks, spot_frac, alphas):
        n, d = free.shape
        b = masks.shape[0]
        nf = n * d * 8
        o_spot = _align16(nf)
        o_alpha = o_spot + _align16(nf)
        o_mask = o_alpha + _align16(b * 8)
        total = self.nbytes = o_mask + b * n
        self._ensure(total)
        if self.copied is not None:
            # the previous call's copy may still read the pinned buffer
            self.copied.synchronize()
        h = self.host_np
        np.copyto(h[:nf].view(np.float64).reshape(n, d), free)
        np.copyto(h[o_spot:o_spot + nf].view(np.float64).reshape(n, d),
                  spot_frac)
        if alphas is not None:
            np.copyto(h[o_alpha:o_alpha + b * 8].view(np.float64), alphas)
        np.copyto(h[o_mask:total].reshape(b, n), masks)
        self.dev[:total].copy_(self.host[:total], non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(self.device))
        v = self.dev
        return (v[:nf].view(torch.float64).view(n, d),
                v[o_mask:total].view(b, n),
                v[o_spot:o_spot + nf].view(torch.float64).view(n, d),
                None if alphas is None
                else v[o_alpha:o_alpha + b * 8].view(torch.float64))


_DEVICE_WS: Dict[torch.device, _DeviceWorkspace] = {}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit CUDA index; raises
    when a CUDA device is asked for and none is present (the torch path
    never drops to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch version")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def stage_to_device(device, free, masks, spot_frac, alphas=None):
    """Host state (numpy) -> float64 ``free`` (n, D), (B, n) ``masks``,
    float64 ``spot_frac`` (n, D) and, if given, float64 (B,) ``alphas`` on
    ``device``.

    On a CUDA device the returned tensors are views of a reused workspace:
    valid until the next call, so consume (or clone) them first."""
    device = resolve_device(device)
    if device.type == "cpu":
        return (torch.from_numpy(np.asarray(free, dtype=np.float64)),
                torch.from_numpy(np.asarray(masks, dtype=bool)),
                torch.from_numpy(np.asarray(spot_frac, dtype=np.float64)),
                None if alphas is None
                else torch.from_numpy(np.asarray(alphas, dtype=np.float64)))
    ws = _DEVICE_WS.get(device)
    if ws is None:
        ws = _DEVICE_WS[device] = _DeviceWorkspace(device)
    return ws.stage(free, masks, spot_frac, alphas)


def hlem_scores_torch(
    free: np.ndarray,          # (n, D) host state
    mask: np.ndarray,          # (n,) bool
    spot_frac: np.ndarray,     # (n, D)
    alpha: float,
    device="cuda",
) -> torch.Tensor:             # (n,) float64 on ``device``
    """The math of ``hlem_scores_np`` in float64 on ``device``; -3.4e38
    where the mask is False."""
    free_d, masks_d, spot_d, _ = stage_to_device(
        device, free, np.asarray(mask, dtype=bool)[None], spot_frac)
    return ops.hlem_score(free_d, masks_d[0], spot_d, float(alpha))


def hlem_select_torch(free, mask, spot_frac, alpha, device="cuda") -> int:
    """argmax host id of ``hlem_scores_torch``, or -1 if no candidate."""
    mask = np.asarray(mask, dtype=bool)
    if not mask.any():
        return -1
    return int(torch.argmax(
        hlem_scores_torch(free, mask, spot_frac, alpha, device)))


# Batched variants: score B pending VM demands against the same host state in
# one call (used when flushing the resubmission queue) — a beyond-CloudSim
# vectorization enabled by the masked formulation.
def hlem_scores_batch_torch(
    free: np.ndarray,        # (n, D) shared host state
    masks: np.ndarray,       # (B, n) per-VM feasibility masks
    spot_frac: np.ndarray,   # (n, D)
    alphas,                  # (B,) per-VM adjustment, or one scalar for all
    device="cuda",
) -> torch.Tensor:           # (B, n) scores, -3.4e38 outside each row's mask
    masks = np.asarray(masks, dtype=bool)
    alphas = np.full(masks.shape[0], alphas, dtype=np.float64)
    free_d, masks_d, spot_d, alphas_d = stage_to_device(
        device, free, masks, spot_frac, alphas)
    return ops.hlem_score_batch(free_d, masks_d, spot_d, alphas_d)


def hlem_select_batch_torch(
    free: np.ndarray,        # (n, D)
    masks: np.ndarray,       # (B, n) per-VM feasibility masks
    spot_frac: np.ndarray,   # (n, D)
    alpha,                   # (B,) or one scalar for all rows
    device="cuda",
) -> np.ndarray:             # (B,) selected host per VM, -1 for an empty row
    masks = np.asarray(masks, dtype=bool)
    idx = torch.argmax(
        hlem_scores_batch_torch(free, masks, spot_frac, alpha, device), dim=1)
    return np.where(masks.any(axis=1), idx.cpu().numpy(), -1)


# Traced twins of the two selections, chosen by the policy once per call when
# its tracer is enabled (the untraced path runs the functions above as they
# are): the same calls, split into ``policy/stage`` (``stage_to_device``: the
# wait on the previous copy, the copy into pinned memory, the enqueued H2D and
# the views), ``policy/launch`` (``kernels.ops`` to the kernel's launch) and
# ``policy/select`` (the argmax and the host's read of the pick: the D2H and
# the wait for the kernel), with counters ``hlem/calls`` (scoring calls: one
# kernel launch each on the card) and ``hlem/staged_bytes`` (the
# workspace's bytes on the card; on the CPU the arrays handed over).
def _staged_bytes(device: torch.device, *tensors) -> int:
    if device.type == "cpu":
        return sum(t.nbytes for t in tensors if t is not None)
    return _DEVICE_WS[device].nbytes


def hlem_select_torch_traced(tracer, args, free, mask, spot_frac, alpha,
                             device="cuda") -> int:
    """:func:`hlem_select_torch` in the tracer's spans (``args`` their
    args) and counters."""
    mask = np.asarray(mask, dtype=bool)
    if not mask.any():
        return -1
    tr = tracer
    device = resolve_device(device)
    tr.begin("policy", "policy/stage")
    free_d, masks_d, spot_d, _ = stage_to_device(device, free, mask[None],
                                                 spot_frac)
    tr.end(tr.sim_t, args)
    tr.begin("policy", "policy/launch")
    scores = ops.hlem_score(free_d, masks_d[0], spot_d, float(alpha))
    tr.end(tr.sim_t, args)
    tr.begin("policy", "policy/select")
    hid = int(torch.argmax(scores))
    tr.end(tr.sim_t, args)
    inc = tr.counters.inc
    inc("hlem/calls")
    inc("hlem/staged_bytes", _staged_bytes(device, free_d, masks_d, spot_d))
    return hid


def hlem_select_batch_torch_traced(tracer, args, free, masks, spot_frac,
                                   alpha, device="cuda") -> np.ndarray:
    """:func:`hlem_select_batch_torch` in the tracer's spans (``args``
    their args) and counters."""
    tr = tracer
    device = resolve_device(device)
    tr.begin("policy", "policy/stage")
    masks = np.asarray(masks, dtype=bool)
    alphas = np.full(masks.shape[0], alpha, dtype=np.float64)
    free_d, masks_d, spot_d, alphas_d = stage_to_device(
        device, free, masks, spot_frac, alphas)
    tr.end(tr.sim_t, args)
    tr.begin("policy", "policy/launch")
    scores = ops.hlem_score_batch(free_d, masks_d, spot_d, alphas_d)
    tr.end(tr.sim_t, args)
    tr.begin("policy", "policy/select")
    out = np.where(masks.any(axis=1),
                   torch.argmax(scores, dim=1).cpu().numpy(), -1)
    tr.end(tr.sim_t, args)
    inc = tr.counters.inc
    inc("hlem/calls")
    inc("hlem/staged_bytes",
        _staged_bytes(device, free_d, masks_d, spot_d, alphas_d))
    return out


# ---------------------------------------------------------------------------
# Filtering math shared by the policy layer
# ---------------------------------------------------------------------------
def rsdiff_np(
    demand_cpu: float,
    used_cpu: np.ndarray,
    total_cpu: np.ndarray,
    rc: float = 0.95,
) -> np.ndarray:
    """Eq. 1 — RsDiff = R_j(t) - U_i(t) * Rc, in CPU-fraction units.

    R_j is the VM's CPU request relative to the host's CPU capacity; U_i is the
    host's current CPU utilization. Hosts already loaded with similar workloads
    (high utilization relative to the request) are filtered out (Eq. 2).
    """
    tot = np.maximum(total_cpu, _EPS)
    r_j = demand_cpu / tot
    u_i = used_cpu / tot
    return r_j - u_i * rc
