"""Model building blocks: RMSNorm, RoPE, GQA attention (prefill + decode),
the MLP, the capacity-based MoE block, the Mamba-1 block and the Hymba
parallel attention + SSM block.

Ports of the reference package's ``models/layers.py``, as ``nn.Module``s
whose parameter names equal the reference's parameter dict keys (``wq``,
``in_proj``, ``a_log``, ``norm_a``, ...), so a reference tree path maps one
to one onto a ``state_dict`` key.  Weights keep the reference's layout:
activations multiply on the left (``x @ wq`` with ``wq`` (d, H*hd)).
Modules are built empty (``torch.empty``); ``model.init_params`` or
``weights.params_from_jax`` fill them.

With ``impl="kernel"`` (the default) prefill attention goes through
``ops.attention`` and every scan through ``ops.selective_scan``: the plain
versions for CPU tensors, the CUDA kernels for CUDA tensors.  With
``impl="xla"``, the reference's training setting, they are the plain,
differentiable ``mha_chunked_ref`` and ``ssm_scan_ref`` on any device.
Decode attention and the MoE block are plain tensor code, as in the
reference.  Decode updates the KV cache in place.

Each module's ``specs(cfg)`` gives the logical axis names of its
parameters (the reference's ``init_*`` second return), and the forward
passes carry the reference's ``constrain`` calls at the same points: under
an active mesh (``sharding.use_mesh``) with DTensor parameters they
redistribute activations as the reference's sharding constraints do; on
plain tensors they do nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels import ops
from ..kernels.flash_attention import mha_chunked_ref
from ..kernels.ssm_scan import ssm_scan_ref
from .config import ArchConfig
from .sharding import constrain, reshape

#: ``impl`` values of the model's forward: the kernels (on CUDA tensors) or
#: the plain functions the reference trains with
IMPLS = ("kernel", "xla")

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

    @staticmethod
    def specs(cfg: ArchConfig) -> dict:
        return {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
                "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp")}

    def forward(self, x: torch.Tensor, pos0: int = 0, impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Full-sequence attention: x (B,S,d) -> (out (B,S,d), (k, v)),
        k and v (B,Hkv,S,hd) for the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = constrain(x @ self.wq, "batch", "seq", "heads")
        k = constrain(x @ self.wk, "batch", "seq", "kv_heads")
        v = constrain(x @ self.wv, "batch", "seq", "kv_heads")
        q = reshape(q, b, s, h, hd).transpose(1, 2)
        k = reshape(k, b, s, hkv, hd).transpose(1, 2)
        v = reshape(v, b, s, hkv, hd).transpose(1, 2)
        positions = pos0 + torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if impl == "xla":
            o = mha_chunked_ref(q, k, v, causal=True, window=cfg.sliding_window,
                                chunk=cfg.attention_chunk)
        else:
            o = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
        o = constrain(o, "batch", "heads", "seq", "head_dim")
        o = reshape(o.transpose(1, 2), b, s, h * hd)
        return constrain(o @ self.wo, "batch", "res_seq", "embed"), (k, v)

    def decode(self, x: torch.Tensor,
               cache: Tuple[torch.Tensor, torch.Tensor], pos: int
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """One-token decode: x (B,1,d), cache k/v (B,Hkv,T,hd) written in
        place at the new token's slot; pos is that token's position.

        With a sliding window and a cache of exactly W slots the cache is a
        ring buffer: position p sits in slot p mod W, and masking uses the
        positions reconstructed from the ring, as in the reference.  A
        DTensor cache (its seq dim may be sharded: ``kv_seq``) takes the
        new token through an elementwise select over the slots, which keeps
        every rank's shard local; a plain cache, one indexed write."""
        cfg = self.cfg
        b = x.shape[0]
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kc, vc = cache
        t_cache = kc.shape[2]
        ring = cfg.sliding_window is not None and t_cache == cfg.sliding_window

        q = reshape(x @ self.wq, b, 1, h, hd).transpose(1, 2)
        k = reshape(x @ self.wk, b, 1, hkv, hd).transpose(1, 2)
        v = reshape(x @ self.wv, b, 1, hkv, hd).transpose(1, 2)
        posv = torch.arange(pos, pos + 1, device=x.device)   # no host copy
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)

        # the reference's dynamic_update_slice clamps the slot into range
        slot = pos % t_cache if ring else min(pos, t_cache - 1)
        if isinstance(kc, DTensor):
            at = (torch.arange(t_cache, device=x.device) == slot)[:, None]
            kc.copy_(torch.where(at, k.to(kc.dtype), kc))
            vc.copy_(torch.where(at, v.to(vc.dtype), vc))
        else:
            kc[:, :, slot] = k[:, :, 0].to(kc.dtype)
            vc[:, :, slot] = v[:, :, 0].to(vc.dtype)
        kc = constrain(kc, "batch", "kv_heads", "kv_seq", None)
        vc = constrain(vc, "batch", "kv_heads", "kv_seq", None)

        # fold the query-head group into the query; logits in f32
        group = h // hkv
        qg = reshape(q, b, hkv, group, hd).to(torch.float32)
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
        o = reshape(reshape(o, b, h, 1, hd).to(x.dtype).transpose(1, 2),
                    b, 1, h * hd)
        return constrain(o @ self.wo, "batch", "seq", "embed"), (kc, vc)


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

    @staticmethod
    def specs(cfg: ArchConfig) -> dict:
        if cfg.mlp == "gated_silu":
            return {"w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"),
                    "w_down": ("ff", "fsdp")}
        return {"w_in": ("fsdp", "ff"), "w_out": ("ff", "fsdp")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            g = constrain(x @ self.w_gate, "batch", "seq", "ff")
            u = constrain(x @ self.w_up, "batch", "seq", "ff")
            return constrain((F.silu(g) * u) @ self.w_down,
                             "batch", "res_seq", "embed")
        # the reference's jax.nn.gelu defaults to the tanh approximation
        h = constrain(x @ self.w_in, "batch", "seq", "ff")
        return constrain(F.gelu(h, approximate="tanh") @ self.w_out,
                         "batch", "res_seq", "embed")


# ---------------------------------------------------------------------------
# MoE: top-k routing with per-expert capacity, gather/scatter dispatch
# ---------------------------------------------------------------------------
def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, equal values in ascending
    index order as ``jax.lax.top_k`` gives them (``torch.topk`` promises no
    order for ties on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def _moe_route(eidx: torch.Tensor, n_experts: int, cap: int):
    """Slot assignment for every group at once; eidx (G, g, K) expert ids.

    Token choices fill an expert's ``cap`` slots in (token, choice) order
    (stable argsort); a choice past capacity goes to the overflow bucket
    ``E*cap`` and is dropped.  Returns (slot (G, g*K) in 0..E*cap, keep
    (G, g, K) bool, table (G, E*cap) slot -> token id, the sentinel g where
    a slot is empty)."""
    n_groups, g, k = eidx.shape
    # one rank routes its own groups in full
    eidx = constrain(eidx, "groups", None, None)
    flat_e = reshape(eidx, n_groups, g * k)
    # out-of-place scatters: a sharded run places their results freely
    counts = flat_e.new_zeros((n_groups, n_experts)).scatter_add(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    order = torch.argsort(flat_e, dim=1, stable=True)
    ar = torch.arange(g * k, device=eidx.device).expand(n_groups, -1)
    rank = torch.empty_like(flat_e).scatter(1, order, ar)
    pos = rank - torch.gather(starts, 1, flat_e)
    keep = pos < cap
    overflow = n_experts * cap
    slot = torch.where(keep, flat_e * cap + pos, overflow)
    tok = torch.where(keep, ar // k, g)
    table = flat_e.new_full((n_groups, overflow + 1), g).scatter(
        1, slot, tok)[:, :overflow]
    return slot, reshape(keep, n_groups, g, k), table


class MoE(nn.Module):
    """Capacity-based top-k MoE: tokens in groups of ``moe_group_size``,
    routed in f32, gathered into (G, E, cap, d), through the experts' gated
    FFNs, and combined back.  The combine sums each token's K weighted
    expert outputs in choice order (a gather through the slot map, no
    scatter-add), so reruns on the card are bit-equal."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, param_dtype(cfg)
        self.router = empty_param((d, e), torch.float32, device)
        self.w_gate = empty_param((e, d, f), dt, device)
        self.w_up = empty_param((e, d, f), dt, device)
        self.w_down = empty_param((e, f, d), dt, device)

    @staticmethod
    def specs(cfg: ArchConfig) -> dict:
        return {"router": ("embed", "experts"),
                "w_gate": ("experts", "fsdp", "expert_ff"),
                "w_up": ("experts", "fsdp", "expert_ff"),
                "w_down": ("experts", "expert_ff", "fsdp")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d)."""
        cfg = self.cfg
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        t = b * s
        g = min(cfg.moe_group_size, t)
        n_groups = -(-t // g)
        xt = reshape(x, t, d)
        if n_groups * g != t:
            xt = F.pad(xt, (0, 0, 0, n_groups * g - t))
        xt = constrain(reshape(xt, n_groups, g, d), "groups", None, "embed")
        cap = max(1, int(g * cfg.top_k / cfg.n_experts * cfg.capacity_factor))

        probs = torch.softmax(xt.to(torch.float32) @ self.router, dim=-1)
        gate, eidx = _top_k(probs, k)                           # (G,g,K)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        slot, keep, table = _moe_route(eidx, e, cap)

        groups = torch.arange(n_groups, device=x.device)[:, None]
        x_pad = torch.cat([xt, xt.new_zeros((n_groups, 1, d))], dim=1)
        xe = reshape(x_pad[groups, table], n_groups, e, cap, d)
        xe = constrain(xe, "groups", "experts", "capacity", "embed")
        # gather the experts' ZeRO-3 (fsdp) shards before use, as GSPMD
        # does for the reference: each rank keeps only its own experts
        w_gate, w_up, w_down = (constrain(w, "experts", None, None) for w in
                                (self.w_gate, self.w_up, self.w_down))
        hg = torch.einsum("Gecd,edf->Gecf", xe, w_gate)
        hu = torch.einsum("Gecd,edf->Gecf", xe, w_up)
        ye = torch.einsum("Gecf,efd->Gecd", F.silu(hg) * hu, w_down)
        ye = constrain(ye, "groups", "experts", "capacity", "embed")

        ye_pad = torch.cat([reshape(ye, n_groups, e * cap, d),
                            ye.new_zeros((n_groups, 1, d))], dim=1)
        picked = reshape(ye_pad[groups, slot], n_groups, g, k, d)
        w = torch.where(keep, gate, 0.0).to(ye.dtype)[..., None]
        out = picked[:, :, 0] * w[:, :, 0]
        for j in range(1, k):
            out = out + picked[:, :, j] * w[:, :, j]
        out = constrain(out, "groups", None, "embed")
        out = reshape(reshape(out, n_groups * g, d)[:t], b, s, d)
        return constrain(out, "batch", "res_seq", "embed")


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

    @staticmethod
    def specs(cfg: ArchConfig) -> dict:
        return {"in_proj": ("fsdp", "ff"), "conv_w": ("ff", "conv"),
                "conv_b": ("ff",), "x_proj": ("ff", None),
                "dt_proj": (None, "ff"), "dt_bias": ("ff",),
                "a_log": ("ff", "state"), "d_skip": ("ff",),
                "out_proj": ("ff", "fsdp")}

    def forward(self, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                impl: str = "kernel"):
        """x (B,S,d) -> (y (B,S,d), (ssm_state (B,di,N) f32,
        conv_state (B,W-1,di)))."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, ns, dr = cfg.dinner, cfg.ssm_state, cfg.dtrank
        h0, conv0 = state if state is not None else (None, None)

        xz = constrain(x @ self.in_proj, "batch", "seq", "ff")
        xin, z = torch.split(xz, di, dim=-1)
        xc = F.silu(_causal_conv(xin, self.conv_w, self.conv_b, conv0))
        # roll the conv state forward: the last W-1 raw inputs
        prefix = conv0 if conv0 is not None else torch.zeros(
            (b, cfg.conv_width - 1, di), dtype=x.dtype, device=x.device)
        new_conv = torch.cat([prefix, xin], dim=1)[:, s:s + cfg.conv_width - 1]

        # x_proj contracts the sharded channels: reduce the partial sums
        # once here, not once a step inside the scan
        proj = constrain(xc @ self.x_proj, "batch", "seq", None)  # (B,S,dr+2N)
        dt_raw = proj[..., :dr]
        b_in = proj[..., dr:dr + ns]
        c_in = proj[..., dr + ns:]
        # bf16 @ bf16 + f32 bias promotes to f32, as in the reference
        dt = F.softplus(dt_raw @ self.dt_proj + self.dt_bias).to(xc.dtype)
        a = -torch.exp(self.a_log)                                # (di, N)

        scan = ssm_scan_ref if impl == "xla" else ops.selective_scan
        y, h_t = scan(xc, dt, a, b_in, c_in, self.d_skip, h0)
        y = y * F.silu(z)
        out = constrain(y @ self.out_proj, "batch", "res_seq", "embed")
        return out, (h_t, new_conv)

    def decode(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor],
               impl: str = "kernel"):
        """Single-token decode: x (B,1,d); state (h (B,di,N), conv (B,W-1,di))."""
        return self.forward(x, state, impl=impl)


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

    @staticmethod
    def specs(cfg: ArchConfig) -> dict:
        return {"attn": Attention.specs(cfg), "mamba": Mamba.specs(cfg),
                "norm_a": ("embed",), "norm_s": ("embed",)}

    def _combine(self, ao, so, x):
        out = 0.5 * (rmsnorm(ao, self.norm_a) + rmsnorm(so, self.norm_s))
        return out.to(x.dtype)

    def forward(self, x: torch.Tensor, state=None, pos0: int = 0,
                impl: str = "kernel"):
        ao, kv = self.attn(x, pos0=pos0, impl=impl)
        so, new_state = self.mamba(x, state, impl=impl)
        return self._combine(ao, so, x), kv, new_state

    def decode(self, x: torch.Tensor, kv_cache, ssm_state, pos: int,
               impl: str = "kernel"):
        ao, kv = self.attn.decode(x, kv_cache, pos)
        so, new_state = self.mamba.decode(x, ssm_state, impl=impl)
        return self._combine(ao, so, x), kv, new_state
