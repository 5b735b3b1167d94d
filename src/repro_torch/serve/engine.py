"""Serving engine: prefill -> batched decode with KV/SSM caches.

A port of the reference package's ``serve/engine.py``.  Prefill and decode
run under ``torch.inference_mode()``.  For sliding-window models the KV
cache is a ring buffer of W slots, filled and read exactly as the reference
does it (see ``make_prefill_step``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ArchConfig
from ..models.model import (
    DecodeState,
    Model,
    decode_step,
    forward,
    init_decode_state,
)


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    """Returns prefill(params, tokens) -> (last_logits (B,V), DecodeState).

    Builds caches sized ``cache_len`` with the prompt written at the front
    or, for ring-buffer sliding-window caches, the last W positions in
    slots 0..W-1 in order.  Decode assumes position p sits in slot p mod W,
    so the two agree only when the prompt length S <= W or S is a multiple
    of W; the reference behaves the same way and the port keeps it."""

    @torch.inference_mode()
    def prefill(params: Model, tokens: torch.Tensor):
        b, s = tokens.shape[0], tokens.shape[1]
        logits, (kv, ssm) = forward(cfg, params, tokens, return_caches=True)
        device = logits.device
        state = init_decode_state(cfg, b, cache_len, device=device)
        kv_k, kv_v, ssm_h, ssm_conv = (state.kv_k, state.kv_v,
                                       state.ssm_h, state.ssm_conv)
        if cfg.has_attention:
            k_new, v_new = kv                    # (L, B, Hkv, S, hd)
            t_cache = kv_k.shape[3]
            if t_cache >= s:
                kv_k[:, :, :, :s] = k_new
                kv_v[:, :, :, :s] = v_new
            else:   # ring buffer: keep the last t_cache positions
                kv_k = k_new[:, :, :, s - t_cache:].to(kv_k.dtype).contiguous()
                kv_v = v_new[:, :, :, s - t_cache:].to(kv_v.dtype).contiguous()
        if cfg.has_ssm:
            h_t, conv_t = ssm
            ssm_h = h_t.to(ssm_h.dtype)
            ssm_conv = conv_t.to(ssm_conv.dtype)
        return logits[:, -1, :], DecodeState(kv_k, kv_v, ssm_h, ssm_conv, s)

    return prefill


def make_serve_step(cfg: ArchConfig):
    """One decode step: (params, token, state) -> (logits (B,1,V), state)."""

    @torch.inference_mode()
    def serve_step(params: Model, token: torch.Tensor, state: DecodeState):
        return decode_step(cfg, params, token, state)

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
