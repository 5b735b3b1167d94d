"""Training step: next-token cross-entropy, gradient accumulation, optimizer
apply.

A port of the reference package's ``train/train_step.py``.  The loss runs
the model with ``impl="xla"`` by default, as the reference's does: plain,
differentiable attention (``mha_chunked_ref``) and scan (``ssm_scan_ref``)
that autograd differentiates.  The CUDA kernels have no backward and refuse
inputs that need a gradient, so a loss through them raises; the eval step
may take them (``impl="kernel"``), since it runs without grad.

The reference's step is a pure function of the state; here it updates the
model's parameters and the optimizer's moments in place and returns a new
``TrainState`` holding the same tensors.

Sharded training: place a state on a mesh with
``sharding.attach(state, train_state_specs(cfg))`` under ``use_mesh`` and
give the step a batch of DTensors split along the batch (``"batch"``).
Every gradient is pinned to its parameter's placements as it comes out of
autograd, so a data-parallel gradient is all-reduced (replicated
parameters) or reduce-scattered (ZeRO-3 ``fsdp`` shards) before the
optimizer sees it, and a microbatch's gradients reduce into the
accumulator's shards.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..models.config import ArchConfig
from ..models.model import Model, forward, init_params, param_specs
from ..models.sharding import constrain, replicate_plain, reshape
from ..models.weights import param_leaves
from .optimizer import _leaf_shape, lr_schedule, make_optimizer

F32 = torch.float32


class TrainState(NamedTuple):
    params: Model
    opt: Any                  # AdamWState | AdafactorState
    step: int
    rng: torch.Generator      # the generator the parameters were drawn from


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in fp32. logits (B,S,V), labels (B,S) int."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    # a vocab-sharded gather leaves a masked partial sum: reduce it before
    # dropping the gathered dim
    gold = constrain(torch.gather(logits, -1, labels[..., None].long()),
                     "batch", "seq", None)[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A dataset batch (numpy) as tensors on ``device``; integer token ids
    become int64 for the embedding lookup."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k == "tokens" and not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def make_loss_fn(cfg: ArchConfig, impl: str = "xla"):
    def loss_fn(params: Model, batch) -> torch.Tensor:
        logits = forward(cfg, params, batch["tokens"], impl=impl)
        return cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss_fn


def _opt_kwargs(cfg: ArchConfig) -> dict:
    if cfg.optimizer == "adamw":
        return {"moment_dtype": getattr(torch, cfg.moment_dtype)}
    return {}


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     device=None) -> TrainState:
    """Parameters drawn by ``init_params`` from ``generator`` (on
    ``device``), with grads on for every floating parameter, as
    ``jax.value_and_grad`` covers the whole tree; zero optimizer state."""
    params = init_params(cfg, generator, device=device)
    for p in params.parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
    opt_init = make_optimizer(cfg.optimizer)[0]
    return TrainState(params=params,
                      opt=opt_init(param_leaves(cfg, params), **_opt_kwargs(cfg)),
                      step=0, rng=generator)


def leaf_specs(cfg: ArchConfig) -> Dict[str, tuple]:
    """Logical axes of the optimizer's leaves (``param_leaves``' names):
    with ``scan_layers`` a stacked leaf leads with the layer axis
    (``None``), as the reference's stacked parameter tree does."""
    specs = param_specs(cfg)
    if not cfg.scan_layers:
        return specs
    out = {}
    for k, names in specs.items():
        if k.startswith("layers."):
            out.setdefault("layers." + k.split(".", 2)[2], (None,) + names)
        else:
            out[k] = names
    return out


def train_state_specs(cfg: ArchConfig) -> TrainState:
    """Logical-axis tree for TrainState: the parameters' (keyed by
    ``state_dict`` name, see ``models.model.param_specs``), the optimizer
    state's (keyed by optimizer leaf), and () for the step and the
    generator (replicated)."""
    specs = leaf_specs(cfg)
    meta = param_leaves(cfg, Model(cfg, device="meta"))
    shapes = {k: _leaf_shape(v) for k, v in meta.items()}
    opt_specs = make_optimizer(cfg.optimizer)[2]
    return TrainState(params=param_specs(cfg), opt=opt_specs(specs, shapes),
                      step=(), rng=())


def _pin(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient on its parameter's placements (a no-op unsharded)."""
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _value_and_grad(loss_fn, model: Model, batch, flat):
    # the recomputation under remat runs inside autograd.grad: plain
    # tensors it makes enter DTensor ops there too
    with replicate_plain():
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else _pin(g, p)
                           for p, g in zip(flat, grads)]


def _regroup(cfg: ArchConfig, model: Model, flat_grads):
    """Grads in ``param_leaves``' structure (same order as parameters())."""
    by_param = {id(p): g for p, g in zip(model.parameters(), flat_grads)}
    return {k: ([by_param[id(t)] for t in leaf] if isinstance(leaf, list)
                else by_param[id(leaf)])
            for k, leaf in param_leaves(cfg, model).items()}


def make_train_step(cfg: ArchConfig, *, impl: str = "xla",
                    lr_kwargs: Optional[dict] = None,
                    grad_accum: Optional[int] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` holds tensors on the parameters' device.  ``grad_accum`` > 1
    splits the batch into microbatches run in turn, accumulating gradients
    in ``cfg.accum_dtype``.  Metrics are f32 scalar tensors: ``loss``,
    ``lr`` and ``grad_norm``."""
    loss_fn = make_loss_fn(cfg, impl)
    opt_update = make_optimizer(cfg.optimizer)[1]
    accum = grad_accum or cfg.grad_accum
    lr_kw = lr_kwargs or {}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        model = state.params
        flat = list(model.parameters())
        if accum <= 1:
            loss, grads = _value_and_grad(loss_fn, model, batch, flat)
        else:
            acc_dt = getattr(torch, cfg.accum_dtype)
            loss_sum = 0.0
            # on the parameters' placements: microbatch grads reduce-scatter
            # into ZeRO-3 shards instead of all-reducing whole tensors
            grads = [torch.zeros_like(p, dtype=acc_dt) for p in flat]
            for i in range(accum):
                mb = {k: reshape(v, accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = _value_and_grad(loss_fn, model, mb, flat)
                grads = [a + gi.to(acc_dt) for a, gi in zip(grads, g)]
                loss_sum = loss_sum + l
            loss = loss_sum / accum
            grads = [g / accum for g in grads]
        grads = [g.to(p.dtype) if g.dtype != p.dtype else g
                 for g, p in zip(grads, flat)]
        lr = lr_schedule(state.step, **lr_kw)
        tree = param_leaves(cfg, model)
        gtree = _regroup(cfg, model, grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                               for g in grads))
        _, new_opt = opt_update(tree, gtree, state.opt, lr=lr)
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        return TrainState(model, new_opt, state.step + 1, state.rng), metrics

    return train_step


def make_eval_step(cfg: ArchConfig, impl: str = "xla"):
    loss_fn = make_loss_fn(cfg, impl)

    @torch.no_grad()
    def eval_step(params: Model, batch) -> torch.Tensor:
        return loss_fn(params, batch)

    return eval_step
