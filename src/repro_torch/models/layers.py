"""Model building blocks: RMSNorm, RoPE, GQA attention (prefill + decode),
the MLP, the Mamba-1 block and the Hymba parallel attention + SSM block.

Ports of the reference package's ``models/layers.py``, as ``nn.Module``s
whose parameter names equal the reference's parameter dict keys (``wq``,
``in_proj``, ``a_log``, ``norm_a``, ...), so a reference tree path maps one
to one onto a ``state_dict`` key.  Weights keep the reference's layout:
activations multiply on the left (``x @ wq`` with ``wq`` (d, H*hd)).
Modules are built empty (``torch.empty``); ``model.init_params`` or
``weights.params_from_jax`` fill them.

Prefill attention goes through ``ops.attention`` and every scan through
``ops.selective_scan``: the plain versions for CPU tensors, the CUDA kernels
for CUDA tensors.  Decode attention is plain tensor code, as in the
reference.  Decode updates the KV cache in place.  The MoE block is not
ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ArchConfig

#: parameters that stay float32 whatever ``cfg.dtype`` is
F32_PARAMS = frozenset({"ln1", "ln2", "final_ln", "norm_a", "norm_s",
                        "dt_bias", "a_log", "d_skip", "router"})


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# RMSNorm, RoPE
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, hd), positions (S,) -> rotated x (half-split layout)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]   # (S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
        dt = param_dtype(cfg)
        self.wq = empty_param((d, hq), dt, device)
        self.wk = empty_param((d, hkv), dt, device)
        self.wv = empty_param((d, hkv), dt, device)
        self.wo = empty_param((hq, d), dt, device)

    def forward(self, x: torch.Tensor, pos0: int = 0
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Full-sequence attention: x (B,S,d) -> (out (B,S,d), (k, v)),
        k and v (B,Hkv,S,hd) for the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = (x @ self.wq).reshape(b, s, h, hd).transpose(1, 2)
        k = (x @ self.wk).reshape(b, s, hkv, hd).transpose(1, 2)
        v = (x @ self.wv).reshape(b, s, hkv, hd).transpose(1, 2)
        positions = pos0 + torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        o = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
        o = o.transpose(1, 2).reshape(b, s, h * hd)
        return o @ self.wo, (k, v)

    def decode(self, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: int
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One-token decode: x (B,1,d), cache k/v (B,Hkv,T,hd) written in
        place at the new token's slot; pos is that token's position.

        With a sliding window and a cache of exactly W slots the cache is a
        ring buffer: position p sits in slot p mod W, and masking uses the
        positions reconstructed from the ring, as in the reference."""
        cfg = self.cfg
        b = x.shape[0]
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kc, vc = cache
        t_cache = kc.shape[2]
        ring = cfg.sliding_window is not None and t_cache == cfg.sliding_window

        q = (x @ self.wq).reshape(b, 1, h, hd).transpose(1, 2)
        k = (x @ self.wk).reshape(b, 1, hkv, hd).transpose(1, 2)
        v = (x @ self.wv).reshape(b, 1, hkv, hd).transpose(1, 2)
        posv = torch.arange(pos, pos + 1, device=x.device)   # no host copy
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)

        # the reference's dynamic_update_slice clamps the slot into range
        slot = pos % t_cache if ring else min(pos, t_cache - 1)
        kc[:, :, slot] = k[:, :, 0].to(kc.dtype)
        vc[:, :, slot] = v[:, :, 0].to(vc.dtype)

        # fold the query-head group into the query; logits in f32
        group = h // hkv
        qg = q.reshape(b, hkv, group, hd).to(torch.float32)
        s = torch.einsum("bkgd,bktd->bkgt", qg, kc.to(torch.float32)) * (hd ** -0.5)
        idx = torch.arange(t_cache, device=x.device)
        kpos = pos - torch.remainder(slot - idx, t_cache) if ring else idx
        ok = (kpos <= pos) & (kpos >= 0)
        if cfg.sliding_window is not None:
            ok = ok & (kpos > pos - cfg.sliding_window)
        s = s.masked_fill(~ok[None, None, None, :], -1e30)
        pr = torch.softmax(s, dim=-1).to(vc.dtype)                 # (B,Hkv,G,T)
        o = torch.einsum("bkgt,bktd->bkgd", pr.to(torch.float32),
                         vc.to(torch.float32))
        o = o.reshape(b, h, 1, hd).to(x.dtype).transpose(1, 2).reshape(b, 1, h * hd)
        return o @ self.wo, (kc, vc)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.gated = cfg.mlp == "gated_silu"
        d, f, dt = cfg.d_model, cfg.d_ff, param_dtype(cfg)
        if self.gated:
            self.w_gate = empty_param((d, f), dt, device)
            self.w_up = empty_param((d, f), dt, device)
            self.w_down = empty_param((f, d), dt, device)
        else:   # gelu
            self.w_in = empty_param((d, f), dt, device)
            self.w_out = empty_param((f, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
        # the reference's jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x @ self.w_in, approximate="tanh") @ self.w_out


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------
def _causal_conv(xz: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along seq via shifted adds, in f32.
    xz (B,S,di); w (di,W); state (B, W-1, di) prefix for chunked decode."""
    bsz, s, di = xz.shape
    width = w.shape[1]
    if state is None:
        state = torch.zeros((bsz, width - 1, di), dtype=xz.dtype, device=xz.device)
    ext = torch.cat([state, xz], dim=1)                      # (B, S+W-1, di)
    out = torch.zeros(xz.shape, dtype=torch.float32, device=xz.device)
    for i in range(width):
        out = out + ext[:, i:i + s, :].to(torch.float32) * w[:, i]
    return (out + b).to(xz.dtype)


class Mamba(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, di, ns, dr, w = (cfg.d_model, cfg.dinner, cfg.ssm_state, cfg.dtrank,
                            cfg.conv_width)
        dt, f32 = param_dtype(cfg), torch.float32
        self.in_proj = empty_param((d, 2 * di), dt, device)
        self.conv_w = empty_param((di, w), dt, device)
        self.conv_b = empty_param((di,), dt, device)
        self.x_proj = empty_param((di, dr + 2 * ns), dt, device)
        self.dt_proj = empty_param((dr, di), dt, device)
        self.dt_bias = empty_param((di,), f32, device)
        self.a_log = empty_param((di, ns), f32, device)
        self.d_skip = empty_param((di,), f32, device)
        self.out_proj = empty_param((di, d), dt, device)

    def forward(self, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x (B,S,d) -> (y (B,S,d), (ssm_state (B,di,N) f32,
        conv_state (B,W-1,di)))."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, ns, dr = cfg.dinner, cfg.ssm_state, cfg.dtrank
        h0, conv0 = state if state is not None else (None, None)

        xin, z = torch.split(x @ self.in_proj, di, dim=-1)
        xc = F.silu(_causal_conv(xin, self.conv_w, self.conv_b, conv0))
        # roll the conv state forward: the last W-1 raw inputs
        prefix = conv0 if conv0 is not None else torch.zeros(
            (b, cfg.conv_width - 1, di), dtype=x.dtype, device=x.device)
        new_conv = torch.cat([prefix, xin], dim=1)[:, s:s + cfg.conv_width - 1]

        proj = xc @ self.x_proj                                   # (B,S,dr+2N)
        dt_raw = proj[..., :dr]
        b_in = proj[..., dr:dr + ns]
        c_in = proj[..., dr + ns:]
        # bf16 @ bf16 + f32 bias promotes to f32, as in the reference
        dt = F.softplus(dt_raw @ self.dt_proj + self.dt_bias).to(xc.dtype)
        a = -torch.exp(self.a_log)                                # (di, N)

        y, h_t = ops.selective_scan(xc, dt, a, b_in, c_in, self.d_skip, h0)
        y = y * F.silu(z)
        return y @ self.out_proj, (h_t, new_conv)

    def decode(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        """Single-token decode: x (B,1,d); state (h (B,di,N), conv (B,W-1,di))."""
        return self.forward(x, state)


# ---------------------------------------------------------------------------
# Hymba: parallel attention + SSM heads in one block
# ---------------------------------------------------------------------------
class HymbaMixer(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.mamba = Mamba(cfg, device)
        self.norm_a = empty_param((cfg.d_model,), torch.float32, device)
        self.norm_s = empty_param((cfg.d_model,), torch.float32, device)

    def _combine(self, ao, so, x):
        out = 0.5 * (rmsnorm(ao, self.norm_a) + rmsnorm(so, self.norm_s))
        return out.to(x.dtype)

    def forward(self, x: torch.Tensor, state=None, pos0: int = 0):
        ao, kv = self.attn(x, pos0=pos0)
        so, new_state = self.mamba(x, state)
        return self._combine(ao, so, x), kv, new_state

    def decode(self, x: torch.Tensor, kv_cache, ssm_state, pos: int):
        ao, kv = self.attn.decode(x, kv_cache, pos)
        so, new_state = self.mamba.decode(x, ssm_state)
        return self._combine(ao, so, x), kv, new_state
