"""Public entry points for the port's kernels.

Each op picks its path from the device of the tensors it is given: CPU
tensors take the plain PyTorch version, CUDA tensors the hand-written
kernel, which either launches or raises.  Nothing falls back from one to
the other.
"""
from __future__ import annotations

import torch

from . import hlem_score as _hlem


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
