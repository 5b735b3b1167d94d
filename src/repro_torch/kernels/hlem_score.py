"""HLEM-VMP host scoring kernel for Hopper (paper Eqs. 3-11) and its plain
PyTorch version.

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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_EPS = 1e-12
_BIG = 3.4e38
MAX_DIMS = 8

#: number of kernel launches since the last reset (set it to 0 to reset)
LAUNCHES = 0

_LIB = None


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------
def hlem_score_ref(free: torch.Tensor, mask: torch.Tensor,
                   spot_frac: torch.Tensor, alpha) -> torch.Tensor:
    """(n,D) free capacity + (n,) candidate mask -> (n,) float32 scores,
    -3.4e38 where masked.  Float32 math, as the JAX package's reference."""
    free = free.to(torch.float32)
    mask = mask.to(torch.bool)
    maskf = mask.to(torch.float32)[:, None]
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

    hs = c_std @ w
    sl = spot_frac.to(torch.float32) @ w
    hs = hs * (1.0 + alpha * sl)
    return torch.where(mask, hs, -_BIG)


def hlem_score_batch_ref(free: torch.Tensor, masks: torch.Tensor,
                         spot_frac: torch.Tensor,
                         alphas: torch.Tensor) -> torch.Tensor:
    """(B, n) scores: row b is ``hlem_score_ref`` on ``masks[b]`` with
    ``alphas[b]`` against the shared host state."""
    return torch.stack([hlem_score_ref(free, masks[b], spot_frac, alphas[b])
                        for b in range(masks.shape[0])])


# ---------------------------------------------------------------------------
# the kernel's wrappers
# ---------------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load_library("hlem_score")
        lib.hlem_score_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hlem_score_launch.restype = ctypes.c_int
        lib.hlem_score_cluster_size.argtypes = [ctypes.c_int]
        lib.hlem_score_cluster_size.restype = ctypes.c_int
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
    if n >= 1 << 24:
        raise ValueError(f"n = {n} hosts exceeds the kernel's float32 count")
    b = masks.shape[0] if masks.dim() == 2 else -1
    _check("free", free, device, (torch.float32,), (n, d))
    _check("spot_frac", spot_frac, device, (torch.float32,), (n, d))
    _check("masks", masks, device, (torch.bool, torch.uint8), (b, n))
    if alphas is not None:
        _check("alphas", alphas, device, (torch.float32,), (b,))
    out = torch.empty((b, n), dtype=torch.float32, device=device)
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
    """Kernel path of ``hlem_score_ref``: free (n, D) f32, mask (n,) bool or
    uint8, spot_frac (n, D) f32, all on one CUDA device; alpha a Python
    float.  Returns (n,) f32 scores, -3.4e38 at masked hosts."""
    if mask.dim() != 1:
        raise ValueError(f"mask must be (n,), got shape {tuple(mask.shape)}")
    return _launch(free, mask[None], spot_frac, None, alpha)[0]


def hlem_score_batch(free: torch.Tensor, masks: torch.Tensor,
                     spot_frac: torch.Tensor,
                     alphas: torch.Tensor) -> torch.Tensor:
    """Kernel path of ``hlem_score_batch_ref``: masks (B, n) bool or uint8,
    alphas (B,) f32 on the same CUDA device.  Returns (B, n) f32."""
    if masks.dim() != 2:
        raise ValueError(f"masks must be (B, n), got shape {tuple(masks.shape)}")
    return _launch(free, masks, spot_frac, alphas, 0.0)
