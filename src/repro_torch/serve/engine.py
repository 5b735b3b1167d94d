"""Serving engine: prefill -> batched decode with KV/SSM caches.

A port of the reference package's ``serve/engine.py``.  Prefill and decode
run under ``torch.inference_mode()``.  For sliding-window models the KV
cache is a ring buffer of W slots, filled and read exactly as the reference
does it (see ``make_prefill_step``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.config import ArchConfig
from ..models.layers import param_dtype
from ..models.model import DecodeState, Model, decode_step, forward


def make_prefill_step(cfg: ArchConfig, cache_len: int, impl: str = "kernel"):
    """Returns prefill(params, tokens) -> (last_logits (B,V), DecodeState).

    Builds caches sized ``cache_len`` with the prompt written at the front
    (zeros after it) or, for ring-buffer sliding-window caches, the last W
    positions in slots 0..W-1 in order.  Decode assumes position p sits in
    slot p mod W, so the two agree only when the prompt length S <= W or S
    is a multiple of W; the reference behaves the same way and the port
    keeps it.  ``impl`` as in ``models.model.forward``."""
    dt = param_dtype(cfg)
    t_cache = (cache_len if cfg.sliding_window is None
               else min(cache_len, cfg.sliding_window))

    def cache(new: torch.Tensor, s: int) -> torch.Tensor:
        if t_cache >= s:           # (L, B, Hkv, S, hd) padded to t_cache
            return F.pad(new.to(dt), (0, 0, 0, t_cache - s))
        # ring buffer: keep the last t_cache positions
        return new[:, :, :, s - t_cache:].to(dt).contiguous()

    @torch.inference_mode()
    def prefill(params: Model, tokens: torch.Tensor):
        s = tokens.shape[1]
        logits, (kv, ssm) = forward(cfg, params, tokens, return_caches=True,
                                    impl=impl)
        kv_k = kv_v = ssm_h = ssm_conv = None
        if cfg.has_attention:
            kv_k, kv_v = cache(kv[0], s), cache(kv[1], s)
        if cfg.has_ssm:
            ssm_h = ssm[0].to(torch.float32)
            ssm_conv = ssm[1].to(dt)
        return logits[:, -1, :], DecodeState(kv_k, kv_v, ssm_h, ssm_conv, s)

    return prefill


def make_serve_step(cfg: ArchConfig, impl: str = "kernel"):
    """One decode step: (params, token, state) -> (logits (B,1,V), state)."""

    @torch.inference_mode()
    def serve_step(params: Model, token: torch.Tensor, state: DecodeState):
        return decode_step(cfg, params, token, state, impl=impl)

    return serve_step


def greedy_generate(cfg: ArchConfig, params: Model, prompt: torch.Tensor,
                    n_tokens: int, cache_len: Optional[int] = None):
    """Greedy decode helper for tests and examples (text modality): the
    first token from the prefill's last logits, then ``n_tokens - 1``
    decode steps.  Returns (B, n_tokens) token ids."""
    s = prompt.shape[1]
    cache_len = cache_len or (s + n_tokens)
    prefill = make_prefill_step(cfg, cache_len)
    step = make_serve_step(cfg)
    logits, state = prefill(params, prompt)
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for _ in range(n_tokens - 1):
        lg, state = step(params, tok, state)
        tok = torch.argmax(lg[:, -1, :], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
