"""Mamba-1 selective scan for Hopper and its plain PyTorch version.

The kernel is ``csrc/ssm_scan.cu`` (CUDA C++, ``sm_90a``), the port of the
Pallas TPU kernel ``repro.kernels.ssm_scan.ssm_scan``.  The plain version
``ssm_scan_ref`` has the semantics of the reference package's
``kernels/ref.py`` ``ssm_scan_ref``:

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * b_t * x_t
    y_t = h_t . c_t + d * x_t

x, dt (B,T,Dm), a (Dm,N) f32, b, c (B,T,N), d (Dm,) f32, optional h0
(B,Dm,N) f32 -> y (B,T,Dm) in x's dtype and hT (B,Dm,N) f32.

``ssm_scan`` takes CUDA tensors only and raises on anything else; choosing
between the kernel and the plain version by device is ``ops``' job.
``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_STATE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: number of kernel launches since the last reset (set it to 0 to reset)
LAUNCHES = 0

_LAUNCH_FN = None


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                 h0: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan as a loop over time in f32; live memory is O(B*Dm*N)."""
    bsz, t, dm = x.shape
    n = a.shape[1]
    f32 = torch.float32
    xf, dtf, bf, cf = (z.to(f32) for z in (x, dt, b, c))
    af = a.to(f32)
    h = (torch.zeros((bsz, dm, n), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    ys = torch.empty((bsz, t, dm), dtype=f32, device=x.device)
    for i in range(t):
        dt_i = dtf[:, i, :, None]                              # (B,Dm,1)
        h = torch.exp(dt_i * af) * h + (dt_i * bf[:, i, None, :]) * xf[:, i, :, None]
        ys[:, i] = torch.einsum("bdn,bn->bd", h, cf[:, i])
    y = ys + xf * d.to(f32)
    return y.to(x.dtype), h


def _launch_fn():
    global _LAUNCH_FN
    if _LAUNCH_FN is None:
        fn = _build.load_library("ssm_scan").ssm_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH_FN = fn
    return _LAUNCH_FN


def _check(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel path of ``ssm_scan_ref``: one CUDA device; x, dt, b, c all f32
    or all bf16; a, d, h0 f32; 1 <= N <= ``MAX_STATE``.  Non-contiguous
    inputs are copied.  Returns (y (B,T,Dm) in x's dtype, hT (B,Dm,N) f32)."""
    global LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"the ssm_scan kernel takes CUDA tensors, got {device}")
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"expected x (B,T,Dm) and a (Dm,N), got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}")
    bsz, t, dm = x.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n} outside 1..{MAX_STATE}")
    if bsz == 0 or t == 0 or dm == 0:
        raise ValueError(f"empty scan: x has shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}, expected float32 or bfloat16")
    f32 = (torch.float32,)
    _check("dt", dt, device, (x.dtype,), (bsz, t, dm))
    _check("a", a, device, f32, (dm, n))
    _check("b", b, device, (x.dtype,), (bsz, t, n))
    _check("c", c, device, (x.dtype,), (bsz, t, n))
    _check("d", d, device, f32, (dm,))
    if h0 is not None:
        _check("h0", h0, device, f32, (bsz, dm, n))
        h0 = h0.contiguous()
    x, dt, a, b, c, d = (z.contiguous() for z in (x, dt, a, b, c, d))
    y = torch.empty_like(x)
    h_t = torch.empty((bsz, dm, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _launch_fn()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_t.data_ptr(), bsz, t, dm, n, _DTYPES[x.dtype],
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return y, h_t
