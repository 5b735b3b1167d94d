"""Model assembly: init / forward / prefill caches / decode for all four
families (dense, moe, ssm, hybrid).

A port of the reference package's ``models/model.py``.  ``Model`` is an
``nn.Module`` holding ``embed`` (text models), ``final_ln``, ``lm_head`` and
a ``ModuleList`` of ``Block``s; its ``state_dict`` keys mirror the
reference's parameter tree (``layers.3.mixer.attn.wq`` is
``params["layers"]["mixer"]["attn"]["wq"][3]`` there).  With
``cfg.remat`` and grad enabled, each block runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint``.

Sharding: ``param_specs`` and ``decode_state_specs`` are the reference's
logical-axis trees, ``shard_params`` places a model's parameters on a mesh
as DTensors, and the forward passes carry the reference's ``constrain``
calls.  They run under ``sharding.replicate_plain``: the plain tensors they
make (positions, masks) enter DTensor ops as replicated.

Modality handling: ``text`` models embed integer tokens; ``vlm``/``audio``
backbones take precomputed (B, S, d_model) embeddings.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from .config import ArchConfig
from .layers import (IMPLS, MLP, Attention, HymbaMixer, Mamba, MoE,
                     empty_param, param_dtype, rmsnorm)
from .sharding import attach, constrain, replicate_plain, use_mesh


class Block(nn.Module):
    """One transformer / Mamba / Hymba block."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln1 = empty_param((d,), torch.float32, device)
        if cfg.family in ("dense", "moe"):
            self.attn = Attention(cfg, device)
            self.ln2 = empty_param((d,), torch.float32, device)
            if cfg.is_moe:
                self.moe = MoE(cfg, device)
            else:
                self.mlp = MLP(cfg, device)
        elif cfg.family == "ssm":
            self.mamba = Mamba(cfg, device)
        elif cfg.family == "hybrid":
            self.mixer = HymbaMixer(cfg, device)
            self.ln2 = empty_param((d,), torch.float32, device)
            self.mlp = MLP(cfg, device)
        else:
            raise ValueError(cfg.family)

    @staticmethod
    def specs(cfg: ArchConfig) -> dict:
        """Logical axes of one block's parameters, nested as its modules."""
        specs = {"ln1": ("embed",)}
        if cfg.family in ("dense", "moe"):
            specs["attn"] = Attention.specs(cfg)
            specs["ln2"] = ("embed",)
            if cfg.is_moe:
                specs["moe"] = MoE.specs(cfg)
            else:
                specs["mlp"] = MLP.specs(cfg)
        elif cfg.family == "ssm":
            specs["mamba"] = Mamba.specs(cfg)
        elif cfg.family == "hybrid":
            specs["mixer"] = HymbaMixer.specs(cfg)
            specs["ln2"] = ("embed",)
            specs["mlp"] = MLP.specs(cfg)
        else:
            raise ValueError(cfg.family)
        return specs

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, self.ln2)
        return self.moe(h) if self.cfg.is_moe else self.mlp(h)

    def forward(self, x: torch.Tensor, pos0: int = 0, impl: str = "kernel"):
        """Returns (x, (kv, ssm_state)); either part is None when the
        family has no such cache."""
        cfg = self.cfg
        h = rmsnorm(x, self.ln1)
        if cfg.family in ("dense", "moe"):
            ao, kv = self.attn(h, pos0=pos0, impl=impl)
            x = x + ao
            x = x + self._ffn(x)
            return x, (kv, None)
        if cfg.family == "ssm":
            mo, state = self.mamba(h, impl=impl)
            return x + mo, (None, state)
        mo, kv, state = self.mixer(h, pos0=pos0, impl=impl)
        x = x + mo
        x = x + self.mlp(rmsnorm(x, self.ln2))
        return x, (kv, state)

    def decode(self, x: torch.Tensor, kv, ssm, pos: int, impl: str = "kernel"):
        cfg = self.cfg
        h = rmsnorm(x, self.ln1)
        if cfg.family in ("dense", "moe"):
            ao, kv = self.attn.decode(h, kv, pos)
            x = x + ao
            x = x + self._ffn(x)
        elif cfg.family == "ssm":
            mo, ssm = self.mamba.decode(h, ssm, impl=impl)
            x = x + mo
        else:
            mo, kv, ssm = self.mixer.decode(h, kv, ssm, pos, impl=impl)
            x = x + mo
            x = x + self.mlp(rmsnorm(x, self.ln2))
        return x, kv, ssm


class Model(nn.Module):
    """Parameters of one architecture, built empty on ``device``; run it
    with ``forward`` and ``decode_step``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, v, dt = cfg.d_model, cfg.vocab, param_dtype(cfg)
        if cfg.modality == "text":
            self.embed = empty_param((v, d), dt, device)
        self.final_ln = empty_param((d,), torch.float32, device)
        self.lm_head = empty_param((d, v), dt, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------
def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def param_specs(cfg: ArchConfig) -> dict:
    """Logical-axis names of every parameter, keyed by ``state_dict`` name
    (no materialization).  The port keeps its layers in an
    ``nn.ModuleList``, so a layer's parameters are ``layers.<i>.<path>``
    with the names of one layer: there is no leading ``"layers"`` axis,
    which the reference's stacked tree (``scan_layers``) has as ``None``."""
    specs = {}
    if cfg.modality == "text":
        specs["embed"] = ("vocab", "fsdp")
    specs["final_ln"] = ("embed",)
    specs["lm_head"] = ("fsdp", "vocab")
    layer = _flat(Block.specs(cfg))
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return specs


def shard_params(model: Model, mesh: DeviceMesh, rules=None) -> Model:
    """Swaps each parameter of ``model`` for a DTensor on ``mesh`` under
    ``divisible_spec`` of its ``param_specs`` names (rank 0's values
    distributed; a ``meta`` model stays on meta).  In place; returns the
    model."""
    with use_mesh(mesh, rules):
        return attach(model, param_specs(model.cfg))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _trunc(p: torch.Tensor, scale: float, gen: torch.Generator) -> None:
    """scale * N(0, 1) truncated to [-2, 2], drawn in f32, cast to p."""
    z = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=gen)
    p.copy_(z * scale)


def _init_attention(m: Attention, cfg: ArchConfig, gen) -> None:
    d, hq = cfg.d_model, cfg.n_heads * cfg.hd
    for name in ("wq", "wk", "wv"):
        _trunc(getattr(m, name), d ** -0.5, gen)
    _trunc(m.wo, hq ** -0.5, gen)


def _init_mlp(m: MLP, cfg: ArchConfig, gen) -> None:
    d, f = cfg.d_model, cfg.d_ff
    if m.gated:
        _trunc(m.w_gate, d ** -0.5, gen)
        _trunc(m.w_up, d ** -0.5, gen)
        _trunc(m.w_down, f ** -0.5, gen)
    else:
        _trunc(m.w_in, d ** -0.5, gen)
        _trunc(m.w_out, f ** -0.5, gen)


def _init_moe(m: MoE, cfg: ArchConfig, gen) -> None:
    d, f = cfg.d_model, cfg.d_ff
    _trunc(m.router, d ** -0.5, gen)
    _trunc(m.w_gate, d ** -0.5, gen)
    _trunc(m.w_up, d ** -0.5, gen)
    _trunc(m.w_down, f ** -0.5, gen)


def _init_mamba(m: Mamba, cfg: ArchConfig, gen) -> None:
    d, di, ns, dr = cfg.d_model, cfg.dinner, cfg.ssm_state, cfg.dtrank
    _trunc(m.in_proj, d ** -0.5, gen)
    _trunc(m.conv_w, cfg.conv_width ** -0.5, gen)
    m.conv_b.zero_()
    _trunc(m.x_proj, di ** -0.5, gen)
    _trunc(m.dt_proj, dr ** -0.5, gen)
    m.dt_bias.fill_(-4.0)                       # softplus(-4) ~ 0.018
    m.a_log.copy_(torch.log(torch.arange(1, ns + 1, dtype=torch.float32,
                                         device=m.a_log.device)).expand(di, ns))
    m.d_skip.fill_(1.0)
    _trunc(m.out_proj, di ** -0.5, gen)


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Model:
    """A ``Model`` with random weights drawn from ``generator`` (which must
    live on ``device``) by the reference's recipe: truncated normals scaled
    by fan-in, norms at 1, the Mamba ``dt_bias``/``a_log``/``d_skip``
    constants.  The reference draws from jax.random keys, so the numbers
    differ; tests carry the reference's weights over with
    ``weights.params_from_jax``.  On the ``meta`` device there is nothing
    to draw: the model comes back with shapes and dtypes only."""
    model = Model(cfg, device)
    if torch.device(device or "cpu").type == "meta":
        return model
    d = cfg.d_model
    if cfg.modality == "text":
        z = torch.empty(model.embed.shape, dtype=torch.float32, device=device)
        z.normal_(generator=generator)
        model.embed.copy_(z)
        del z
    model.final_ln.fill_(1.0)
    z = torch.empty(model.lm_head.shape, dtype=torch.float32, device=device)
    z.normal_(generator=generator)
    model.lm_head.copy_(z * d ** -0.5)
    del z
    for blk in model.layers:
        blk.ln1.fill_(1.0)
        if cfg.family != "ssm":
            blk.ln2.fill_(1.0)
        if cfg.is_moe:
            _init_moe(blk.moe, cfg, generator)
        elif cfg.family != "ssm":
            _init_mlp(blk.mlp, cfg, generator)
        if cfg.family in ("dense", "moe"):
            _init_attention(blk.attn, cfg, generator)
        elif cfg.family == "ssm":
            _init_mamba(blk.mamba, cfg, generator)
        else:
            _init_attention(blk.mixer.attn, cfg, generator)
            _init_mamba(blk.mixer.mamba, cfg, generator)
            blk.mixer.norm_a.fill_(1.0)
            blk.mixer.norm_s.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def embed_tokens(cfg: ArchConfig, params: Model, tokens: torch.Tensor):
    if cfg.modality == "text":
        # the table gathered whole first (ZeRO-3: its fsdp and vocab
        # shards), then a data-parallel lookup
        x = F.embedding(tokens, constrain(params.embed, None, None))
    else:
        x = tokens   # precomputed frontend embeddings (B, S, d)
    return constrain(x.to(param_dtype(cfg)), "batch", "res_seq", "embed")


def forward(cfg: ArchConfig, params: Model, tokens: torch.Tensor,
            pos0: int = 0, return_caches: bool = False, impl: str = "kernel"):
    """tokens: int (B,S) for text, float (B,S,d) otherwise -> logits
    (B,S,V).

    ``impl="kernel"`` runs prefill attention and the scans through ``ops``
    (the CUDA kernels on CUDA tensors, which refuse inputs that need a
    gradient); ``impl="xla"`` through the plain, differentiable functions,
    as the reference trains.

    ``return_caches`` also returns the per-layer caches stacked on a leading
    layer axis, as the reference's layer scan returns them:
    ``(kv, ssm)`` with ``kv = (k, v)`` each (L,B,Hkv,S,hd) and
    ``ssm = (h, conv)`` with h (L,B,di,N) f32 and conv (L,B,W-1,di); a part
    is None when the family has no such cache."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    with replicate_plain():
        return _forward(cfg, params, tokens, pos0, return_caches, impl)


def _forward(cfg, params, tokens, pos0, return_caches, impl):
    x = embed_tokens(cfg, params, tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    caches = []
    for blk in params.layers:
        if remat:
            x, cache = checkpoint(blk, x, pos0, impl, use_reentrant=False)
        else:
            x, cache = blk(x, pos0=pos0, impl=impl)
        if return_caches:
            caches.append(cache)
    x = rmsnorm(x, params.final_ln)
    logits = constrain(x @ params.lm_head, "batch", "seq", "vocab")
    if not return_caches:
        return logits
    kv = ssm = None
    if cfg.has_attention:
        kv = tuple(torch.stack([c[0][i] for c in caches]) for i in range(2))
    if cfg.has_ssm:
        ssm = tuple(torch.stack([c[1][i] for c in caches]) for i in range(2))
    return logits, (kv, ssm)


# ---------------------------------------------------------------------------
# decode (serving): one new token against populated caches
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    """Per-layer caches stacked on a leading layer axis."""
    kv_k: Optional[torch.Tensor]       # (L, B, Hkv, T_cache, hd)
    kv_v: Optional[torch.Tensor]
    ssm_h: Optional[torch.Tensor]      # (L, B, d_inner, N) f32
    ssm_conv: Optional[torch.Tensor]   # (L, B, W-1, d_inner)
    pos: int                           # next write position


def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int,
                      dtype: Optional[torch.dtype] = None,
                      device=None) -> DecodeState:
    dt = dtype or param_dtype(cfg)
    L = cfg.n_layers
    kv_k = kv_v = ssm_h = ssm_conv = None
    if cfg.has_attention:
        t = cache_len if cfg.sliding_window is None else min(
            cache_len, cfg.sliding_window)
        shape = (L, batch, cfg.n_kv_heads, t, cfg.hd)
        kv_k = torch.zeros(shape, dtype=dt, device=device)
        kv_v = torch.zeros(shape, dtype=dt, device=device)
    if cfg.has_ssm:
        ssm_h = torch.zeros((L, batch, cfg.dinner, cfg.ssm_state),
                            dtype=torch.float32, device=device)
        ssm_conv = torch.zeros((L, batch, cfg.conv_width - 1, cfg.dinner),
                               dtype=dt, device=device)
    return DecodeState(kv_k, kv_v, ssm_h, ssm_conv, 0)


def decode_state_specs(cfg: ArchConfig) -> DecodeState:
    """Logical-axis tuples for ``DecodeState``.  Its caches are stacked on
    a leading layer axis, as the reference's are (``None``)."""
    kv = (None, "batch", "kv_heads", "kv_seq", None) if cfg.has_attention else None
    return DecodeState(
        kv_k=kv, kv_v=kv,
        ssm_h=(None, "batch", "ff", "state") if cfg.has_ssm else None,
        ssm_conv=(None, "batch", None, "ff") if cfg.has_ssm else None,
        pos=(),
    )


def decode_step(cfg: ArchConfig, params: Model, token: torch.Tensor,
                state: DecodeState, impl: str = "kernel"):
    """token: int (B,1) text / float (B,1,d) otherwise.  Returns (logits
    (B,1,V), new state).  The caches are updated in place: the returned
    state holds the same tensors as ``state``, with ``pos`` advanced.
    ``impl`` picks the scan's path, as in ``forward``."""
    with replicate_plain():
        x = embed_tokens(cfg, params, token)
        pos = state.pos
        for i, blk in enumerate(params.layers):
            kv = (state.kv_k[i], state.kv_v[i]) if cfg.has_attention else None
            ssm = (state.ssm_h[i], state.ssm_conv[i]) if cfg.has_ssm else None
            x, _, new_ssm = blk.decode(x, kv, ssm, pos, impl=impl)
            if cfg.has_ssm:
                state.ssm_h[i].copy_(new_ssm[0])
                state.ssm_conv[i].copy_(new_ssm[1])
        x = rmsnorm(x, params.final_ln)
        logits = constrain(x @ params.lm_head, "batch", "seq", "vocab")
    return logits, state._replace(pos=pos + 1)
