"""Public entry points for the port's kernels.

Each op picks its path from the device of the tensors it is given: CPU
tensors take the plain PyTorch version, CUDA tensors the hand-written
kernel, which either launches or raises.  Nothing falls back from one to
the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from . import hlem_score as _hlem
from . import ssm_scan as _ssm


def hlem_score(free: torch.Tensor, mask: torch.Tensor,
               spot_frac: torch.Tensor, alpha: float) -> torch.Tensor:
    """HLEM-VMP host scores (paper Eqs. 3-11) for one VM: (n,) float32."""
    if free.device.type == "cpu":
        return _hlem.hlem_score_ref(free, mask, spot_frac, alpha)
    return _hlem.hlem_score(free, mask, spot_frac, alpha)


def hlem_score_batch(free: torch.Tensor, masks: torch.Tensor,
                     spot_frac: torch.Tensor,
                     alphas: torch.Tensor) -> torch.Tensor:
    """HLEM-VMP host scores for B VMs against shared host state: (B, n)."""
    if free.device.type == "cpu":
        return _hlem.hlem_score_batch_ref(free, masks, spot_frac, alphas)
    return _hlem.hlem_score_batch(free, masks, spot_frac, alphas)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention with GQA broadcast, end-aligned positions:
    q (B,H,Tq,dh), k/v (B,Hkv,Tk,dh) -> (B,H,Tq,dh) in q's dtype."""
    if q.device.type == "cpu":
        return _fa.mha_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def selective_scan(x, dt, a, b, c, d, h0=None):
    """Mamba-1 selective scan: (y (B,T,Dm) in x's dtype, hT (B,Dm,N) f32)."""
    if x.device.type == "cpu":
        return _ssm.ssm_scan_ref(x, dt, a, b, c, d, h0)
    return _ssm.ssm_scan(x, dt, a, b, c, d, h0)
