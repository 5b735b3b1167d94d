"""HLEM-VMP host scoring kernel for Hopper (paper Eqs. 3-11) and its plain
PyTorch version, both in float64 as the reference's default scorer.

The kernel is ``csrc/hlem_score.cu`` (CUDA C++, ``sm_90a``), the port of the
Pallas TPU kernel ``repro.kernels.hlem_score`` (``hlem_score_pallas`` and
``hlem_score_pallas_batch``).  One kernel serves both entries: the batch
wrapper launches one thread-block cluster per batch row, and the single-VM
wrapper is the batch of one.  The cluster's size depends on n alone
(``cluster_size``).  The note at the top of the source says what bounds it
and how its design answers that.

The wrappers take CUDA tensors only and raise on anything else; choosing
between the kernel and the plain version by device is ``ops``' job.
``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.

The same library carries each scoring call's upload (``upload``): the
gather of a pool's changed rows into the call's pinned host bytes, one copy
of those bytes to the card, and the launch of a small kernel
(``fleet_mirror_scatter``) that writes the rows into the pool's device
mirror (``core/hlem.py``) and tells the host that the copy is done.
``SCATTERS`` counts its launches; ``mirror_gather_ref`` and
``mirror_scatter_ref`` are the plain versions of the two halves.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_EPS = 1e-12
_BIG = 3.4e38
MAX_DIMS = 8

#: number of kernel launches since the last reset (set it to 0 to reset)
LAUNCHES = 0
#: number of the upload scatter's launches (one an upload) since the last
#: reset
SCATTERS = 0

_LIB = None


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------
def _split(a):
    """a = hi + lo exactly, hi with at most 26 significant bits (Veltkamp)."""
    c = 134217729.0 * a
    hi = c - (c - a)
    return hi, a - hi


def _dot2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k x[..., k] * w[k] by Ogita, Rump and Oishi's Dot2, k = 0..D-1:
    the running sum p, and the rounding errors of every product (Dekker's
    two-product; the kernel takes it from one fused multiply-add, the same
    bits) and every sum (Knuth's two-sum) in s, added to p once at the end."""
    prod = x * w
    xh, xl = _split(x)
    wh, wl = _split(w)
    err = xl * wl - (((prod - xh * wh) - xl * wh) - xh * wl)
    p = s = torch.zeros(x.shape[:-1], dtype=torch.float64, device=x.device)
    for k in range(x.shape[-1]):
        h = prod[..., k]
        t = p + h
        z = t - p
        s = s + (((p - (t - z)) + (h - z)) + err[..., k])
        p = t
    return p + s


def hlem_score_ref(free: torch.Tensor, mask: torch.Tensor,
                   spot_frac: torch.Tensor, alpha) -> torch.Tensor:
    """(n,D) free capacity + (n,) candidate mask -> (n,) float64 scores,
    -3.4e38 where masked.  Float64 math, as the JAX package's default
    (numpy) scorer."""
    free = free.to(torch.float64)
    mask = mask.to(torch.bool)
    maskf = mask.to(torch.float64)[:, None]
    m = maskf.sum()

    lo = torch.where(mask[:, None], free, torch.inf).amin(dim=0)
    hi = torch.where(mask[:, None], free, -torch.inf).amax(dim=0)
    span = hi - lo
    degen = span <= _EPS
    c_std = torch.where(degen[None, :], 1.0,
                        (free - lo[None, :]) / torch.where(degen, 1.0, span)[None, :])
    c_std = c_std * maskf

    col = c_std.sum(dim=0)
    p = torch.where(col[None, :] > _EPS,
                    c_std / torch.where(col > _EPS, col, 1.0)[None, :],
                    maskf / torch.clamp(m, min=1.0))
    p = p * maskf
    k = torch.where(m > 1.0, 1.0 / torch.log(torch.clamp(m, min=2.0)), 0.0)
    plogp = torch.where(p > _EPS, p * torch.log(torch.clamp(p, min=_EPS)), 0.0)
    e = -k * plogp.sum(dim=0)
    g = 1.0 - e
    gsum = g.sum()
    d = free.shape[1]
    w = torch.where(gsum > _EPS, g / torch.where(gsum > _EPS, gsum, 1.0), 1.0 / d)

    # both per-host dot products compensated (Dot2), as the kernel computes
    # them: each is its exact value rounded once, up to ~D^2 u^2 of the sum
    # of its terms' magnitudes, so hosts whose scores are equal in exact
    # arithmetic score bit-equal whatever the order of their terms (a plain
    # sum rounds b + a + a and a + b + a/2 + a/2 apart) or where they sit
    hs, sl = _dot2(torch.stack([c_std, spot_frac.to(torch.float64)]), w)
    hs = hs * (1.0 + alpha * sl)
    return torch.where(mask, hs, -_BIG)


def hlem_score_batch_ref(free: torch.Tensor, masks: torch.Tensor,
                         spot_frac: torch.Tensor,
                         alphas: torch.Tensor) -> torch.Tensor:
    """(B, n) scores: row b is ``hlem_score_ref`` on ``masks[b]`` with
    ``alphas[b]`` against the shared host state."""
    return torch.stack([hlem_score_ref(free, masks[b], spot_frac, alphas[b])
                        for b in range(masks.shape[0])])


def mirror_gather_ref(src: np.ndarray, planes: np.ndarray,
                      ids: np.ndarray) -> None:
    """The upload's host half: the rows ``ids`` (k,) of a pool's planes
    (2, rows, D) f64 into ``src`` (2, k, D), copied bits."""
    np.take(planes, ids, axis=1, out=src, mode="clip")


def mirror_scatter_ref(planes: torch.Tensor, src: torch.Tensor,
                       ids: torch.Tensor) -> None:
    """Write changed rows into a device mirror, in place: planes (2, rows,
    D) f64 (free, then spot fraction), src (2, k, D) f64 the new rows of
    each plane in the order of ids (k,) i32.  Copies bits."""
    planes[:, ids.long()] = src


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load_library("hlem_score")
        lib.hlem_score_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hlem_score_launch.restype = ctypes.c_int
        lib.hlem_score_cluster_size.argtypes = [ctypes.c_int]
        lib.hlem_score_cluster_size.restype = ctypes.c_int
        lib.hlem_mirror_upload.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.hlem_mirror_upload.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def cluster_size(n: int) -> int:
    """The number of CTAs in the cluster that scores one row of n hosts, as
    the kernel's library decides it (builds the library on first use)."""
    return _lib().hlem_score_cluster_size(n)


def _check(name: str, t: torch.Tensor, device: torch.device, dtypes,
           shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(free: torch.Tensor, masks: torch.Tensor, spot_frac: torch.Tensor,
            alphas, alpha: float) -> torch.Tensor:
    global LAUNCHES
    device = free.device
    if device.type != "cuda":
        raise ValueError(f"the hlem_score kernel takes CUDA tensors, got {device}")
    if free.dim() != 2:
        raise ValueError(f"free must be (n, D), got shape {tuple(free.shape)}")
    n, d = free.shape
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"at most {MAX_DIMS} resource dims supported, got {d}")
    if n >= 1 << 31:
        raise ValueError(f"n = {n} hosts exceeds the kernel's int host index")
    b = masks.shape[0] if masks.dim() == 2 else -1
    _check("free", free, device, (torch.float64,), (n, d))
    _check("spot_frac", spot_frac, device, (torch.float64,), (n, d))
    _check("masks", masks, device, (torch.bool, torch.uint8), (b, n))
    if alphas is not None:
        _check("alphas", alphas, device, (torch.float64,), (b,))
    out = torch.empty((b, n), dtype=torch.float64, device=device)
    if b == 0 or n == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().hlem_score_launch(
            free.data_ptr(), masks.view(torch.uint8).data_ptr(),
            spot_frac.data_ptr(),
            None if alphas is None else alphas.data_ptr(), float(alpha),
            out.data_ptr(), n, d, b, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hlem_score kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def hlem_score(free: torch.Tensor, mask: torch.Tensor, spot_frac: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """Kernel path of ``hlem_score_ref``: free (n, D) f64, mask (n,) bool or
    uint8, spot_frac (n, D) f64, all on one CUDA device; alpha a Python
    float.  Returns (n,) f64 scores, -3.4e38 at masked hosts."""
    if mask.dim() != 1:
        raise ValueError(f"mask must be (n,), got shape {tuple(mask.shape)}")
    return _launch(free, mask[None], spot_frac, None, alpha)[0]


def hlem_score_batch(free: torch.Tensor, masks: torch.Tensor,
                     spot_frac: torch.Tensor,
                     alphas: torch.Tensor) -> torch.Tensor:
    """Kernel path of ``hlem_score_batch_ref``: masks (B, n) bool or uint8,
    alphas (B,) f64 on the same CUDA device.  Returns (B, n) f64."""
    if masks.dim() != 2:
        raise ValueError(f"masks must be (B, n), got shape {tuple(masks.shape)}")
    return _launch(free, masks, spot_frac, alphas, 0.0)


class UploadBuffers:
    """The byte buffers of a scoring call's upload: ``dev`` on ``device``
    and ``host`` (pinned for a CUDA device) of one size and one layout.  On
    a card also ``done``, a pinned word to which each upload's scatter
    stores the upload's ``ticket`` once its copy has read the host bytes,
    and the raw addresses the kernel path passes, read once."""

    def __init__(self, nbytes: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.nbytes = nbytes
        self.host = torch.empty(nbytes, dtype=torch.uint8,
                                pin_memory=self.cuda)
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.ticket = 0
        if self.cuda:
            self.done = torch.zeros(1, dtype=torch.int64, pin_memory=True)
            self.done_np = self.done.numpy()
            self.addrs = (self.dev.data_ptr(), self.host.data_ptr(),
                          self.done.data_ptr(), device.index)
        self._source = self._source_addr = None

    def wait(self) -> None:
        """Until the last upload's copy has read the host bytes: at once
        when its scatter has said so (after a pick read on the host, always),
        else by a wait for the device, which also raises a fault of it."""
        if self.cuda and self.done_np[0] != self.ticket:
            torch.cuda.synchronize(self.device)

    def source_addr(self, planes: np.ndarray) -> int:
        """The address of ``planes``, a pool's rows, read once per array."""
        if planes is not self._source:
            if not (planes.dtype == np.float64 and planes.ndim == 3
                    and planes.shape[0] == 2 and planes.flags.c_contiguous):
                raise ValueError("planes must be C-contiguous f64 (2, rows, "
                                 f"d), got {planes.dtype} {planes.shape}")
            self._source = planes
            self._source_addr = planes.__array_interface__["data"][0]
        return self._source_addr


def upload(bufs: UploadBuffers, lo: int, hi: int, rows: int, d: int,
           o_src: int, o_ids: int, k: int, planes=None) -> None:
    """Kernel path of a scoring call's upload, on the current stream, at
    byte offsets into ``bufs``: for k > 0, ``mirror_gather_ref`` on the host
    of the k rows of ``planes`` (the pool's (2, rows, d) f64, C-contiguous)
    whose i32 ids are at ``host[o_ids]`` into ``host[o_src]``; then
    ``host[lo:hi]`` to ``dev[lo:hi]`` in one asynchronous copy; then one
    launch of the scatter: ``mirror_scatter_ref`` of those rows into the
    mirror's planes (2, rows, d) at ``dev[0]`` (none for k = 0), and the
    store of the upload's ticket to ``bufs.done``.  The caller writes no
    host byte of ``[lo, hi)`` before ``bufs.wait()``."""
    global SCATTERS
    if not bufs.cuda:
        raise ValueError("upload takes the buffers of a CUDA device")
    if hi > bufs.nbytes or 16 * rows * d > bufs.nbytes or (
            k and planes.shape[1:] != (rows, d)):
        raise ValueError(f"byte range [{lo}, {hi}) or planes of {rows} rows "
                         "outside the buffers")
    dev, host, done, index = bufs.addrs
    ticket = bufs.ticket + 1
    args = (dev, host, lo, hi, rows, d, o_src, o_ids, k,
            bufs.source_addr(planes) if k else None, done, ticket,
            # the raw handle, through torch's private ``torch._C`` (as is
            # ``_cuda_getDevice`` below; the card tests run this path): the
            # public ``current_stream`` builds a Stream object, ~7 us a call
            # on the card's host
            torch._C._cuda_getCurrentRawStream(index))
    if torch._C._cuda_getDevice() == index:
        err = _lib().hlem_mirror_upload(*args)
    else:
        with torch.cuda.device(index):
            err = _lib().hlem_mirror_upload(*args)
    if err != 0:
        # the copy may be enqueued before the launch failed, and no ticket
        # will say when it has read the host bytes: wait for it here
        torch.cuda.synchronize(index)
        raise RuntimeError(f"hlem upload failed with CUDA error {err}")
    bufs.ticket = ticket
    SCATTERS += 1
