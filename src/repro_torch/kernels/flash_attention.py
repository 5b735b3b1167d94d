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

``mha_chunked_ref`` is the reference's ``mha_chunked_ref``: the same
function as an online softmax over key chunks, whose live memory is
O(Tq * chunk); the model's ``impl="xla"`` path (training) takes it.

``flash_attention`` takes CUDA tensors only and raises on anything else,
and on inputs that need a gradient (the kernel has no backward);
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


def mha_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    chunk: int = 1024) -> torch.Tensor:
    """``mha_ref`` as an online softmax over key chunks of ``chunk`` in f32
    (the last chunk padded); for ``Tk <= chunk``, ``mha_ref`` itself.
    Differentiable: training keeps its memory at O(Tq * chunk) a layer."""
    b, h, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    if tk <= chunk:
        return mha_ref(q, k, v, causal=causal, window=window, scale=scale)
    group = h // hkv
    n_chunks = -(-tk // chunk)
    pad = n_chunks * chunk - tk
    kp, vp = k, v
    if pad:
        kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
        vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.to(torch.float32)
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    m = torch.full((b, h, tq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, dh), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kc = kp[:, :, sl].to(torch.float32).repeat_interleave(group, dim=1)
        vc = vp[:, :, sl].to(torch.float32).repeat_interleave(group, dim=1)
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        ok = kpos < tk
        if causal:
            ok = ok & (kpos <= qpos)
        if window is not None:
            ok = ok & (kpos > qpos - window)
        s = s.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(ok, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vc)
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.to(q.dtype)


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
    _build.refuse_grad("flash_attention", q, k, v)
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
