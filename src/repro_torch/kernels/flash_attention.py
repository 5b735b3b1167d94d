"""Flash attention for Hopper (GQA, causal, sliding window) and its plain
PyTorch version.

The kernels are in ``csrc/flash_attention.cu`` (CUDA C++, ``sm_90a``), the
port of the Pallas TPU kernel ``repro.kernels.flash_attention.flash_attention``:
bf16 inputs take the tensor-core kernel (wgmma, K/V fed by TMA), f32 inputs
an f32 FMA kernel.  The note at the top of the source says what bounds each
and how its design answers that.
The plain version ``mha_ref`` has the semantics of the reference package's
``kernels/ref.py`` ``mha_ref``: q (B,H,Tq,dh), k/v (B,Hkv,Tk,dh), query head
h reads kv head h // (H // Hkv), positions end-aligned (query i sits at
i + Tk - Tq), f32 arithmetic, output in q's dtype.

``flash_attention`` takes CUDA tensors only and raises on anything else;
choosing between the kernel and the plain version by device is ``ops``'
job.  ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128)
#: the C entry point for each input dtype
_ENTRY = {torch.float32: "flash_attention_f32_launch",
          torch.bfloat16: "flash_attention_bf16_launch"}

#: number of kernel launches since the last reset (set it to 0 to reset)
LAUNCHES = 0

_LAUNCH_FNS = {}


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention with a GQA head-group broadcast, in f32.  A row that
    sees no key (only possible when Tq > Tk) is NaN, as in the reference."""
    b, h, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    group = h // hkv
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    logits = torch.matmul(q.to(torch.float32), kf.transpose(-1, -2)) * scale
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    ok = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    logits = logits.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, vf).to(q.dtype)


def _launch_fn(dtype: torch.dtype):
    fn = _LAUNCH_FNS.get(dtype)
    if fn is None:
        fn = getattr(_build.load_library("flash_attention"), _ENTRY[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH_FNS[dtype] = fn
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (TMA reads the bf16 inputs)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Kernel path of ``mha_ref``: q (B,H,Tq,dh), k/v (B,Hkv,Tk,dh), one
    CUDA device, all f32 or all bf16, dh in ``HEAD_DIMS``, H % Hkv == 0 and
    1 <= Tq <= Tk.  Non-contiguous or misaligned inputs are copied.
    Returns (B,H,Tq,dh) in q's dtype."""
    global LAUNCHES
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, "
                         f"got {device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,Tq,dh) and k, v (B,Hkv,Tk,dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, dh = q.shape
    _, hkv, tk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} kv heads")
    if not 1 <= tq <= tk:
        raise ValueError(f"the kernel needs 1 <= Tq <= Tk, got Tq={tq}, Tk={tk}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != device or v.device != device:
        raise ValueError("q, k and v must be on one device")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    with torch.cuda.device(device):
        err = _launch_fn(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, tq, tk, dh, dh ** -0.5, int(causal),
            0 if window is None else int(window),
            torch.cuda.current_stream(device).cuda_stream)
    if err >= 1000:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"with CUresult {err - 1000}")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
