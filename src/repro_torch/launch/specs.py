"""Assigned input shapes and per-cell meta-DTensor builders.

A port of the reference package's ``launch/specs.py``.  Every (architecture
x shape) cell defines which step function is traced:
  train_4k    -> train_step (next-token CE + optimizer update)
  prefill_32k -> prefill_step (build the KV/SSM cache for the prompt)
  decode_32k  -> serve_step (1 new token, cache of seq_len)
  long_500k   -> serve_step (1 new token, 512k context) — sub-quadratic archs
                 only (SSM / sliding-window hybrid); skipped otherwise.

The reference's ``ShapeDtypeStruct`` stand-ins are ``meta`` tensors here,
and their shardings DTensor placements: ``input_specs`` builds every input
of a cell as meta DTensors on the active mesh, so nothing is materialised
(Kimi-K2 1T and Llama-3 405B trace without allocating a byte).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.config import ArchConfig
from ..models.model import (Model, decode_state_specs, init_decode_state,
                            param_specs)
from ..models.sharding import attach
from ..train.train_step import init_train_state, train_state_specs


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Skip rules (recorded in EXPERIMENTS.md §Dry-run)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense KV decode is the "
                       "quadratic regime the shape excludes (DESIGN.md)")
    return True, ""


def _token_struct(cfg: ArchConfig, batch: int, seq: int) -> torch.Tensor:
    """Meta stand-in for the model input: int64 token ids (text, as
    ``train.train_step.batch_to_device`` gives them) or precomputed
    frontend embeddings (vlm/audio stub)."""
    if cfg.modality == "text":
        return torch.empty((batch, seq), dtype=torch.int64, device="meta")
    return torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16,
                       device="meta")


def _token_names(cfg: ArchConfig) -> tuple:
    return (("batch", "seq") if cfg.modality == "text"
            else ("batch", "seq", "embed"))


def batch_specs(cfg: ArchConfig, shape: ShapeSpec):
    """(shape_tree, logical_spec_tree) for the data batch of a train cell."""
    shapes = {
        "tokens": _token_struct(cfg, shape.global_batch, shape.seq_len),
        "labels": torch.empty((shape.global_batch, shape.seq_len),
                              dtype=torch.int32, device="meta"),
    }
    specs = {"tokens": _token_names(cfg), "labels": ("batch", "seq")}
    return shapes, specs


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[Any, ...]:
    """Meta-DTensor stand-ins for every input of the traced step (requires
    an active mesh via sharding.use_mesh)."""
    if shape.kind == "train":
        state = init_train_state(cfg, torch.Generator(), device="meta")
        state = attach(state, train_state_specs(cfg))
        b_shapes, b_specs = batch_specs(cfg, shape)
        return (state, attach(b_shapes, b_specs))

    params = attach(Model(cfg, device="meta"), param_specs(cfg))
    if shape.kind == "prefill":
        tokens = attach(_token_struct(cfg, shape.global_batch, shape.seq_len),
                        _token_names(cfg))
        return (params, tokens)

    # decode
    token = attach(_token_struct(cfg, shape.global_batch, 1), _token_names(cfg))
    state = attach(init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                     device="meta"),
                   decode_state_specs(cfg))
    return (params, token, state)


def rules_for(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Per-cell sharding-rule overrides."""
    rules: Dict[str, Any] = {}
    if cfg.fsdp_over_pod:
        rules["fsdp"] = ("pod", "data")
    if cfg.seq_parallel and shape.kind in ("train", "prefill"):
        rules["res_seq"] = "model"
    if shape.kind == "decode" and cfg.has_attention:
        # flash-decoding-style cache layout: KV heads (often < model width)
        # replicate; the cache SEQ dim shards over "model" instead, so each
        # rank scans 1/16th of the context and the softmax is combined.
        rules["kv_seq"] = "model"
        rules["kv_heads"] = None
    return rules
