"""Dry-run of every architecture x shape cell on the production meshes.

A port of the reference package's ``launch/dryrun.py``.  The reference
lowers and compiles each cell's step on 512 placeholder host devices and
reads the optimized HLO.  Here each cell's step runs once on ``meta``
DTensors over a fake process group of 256 or 512 ranks (``mesh.fake_group``),
so nothing is allocated and nothing moves, and ``hlo_analyzer.analyze``
counts what one rank does: flops, memory bytes, collective bytes by kind.

The multi-pod mesh is traced as (32, 16) ``("data", "model")``, its pod
axis folded into data: on a three-dimensional mesh, DTensor's redistribute
planner (torch 2.13) can search placements for minutes per op (a 4-D
matmul on a fake (2, 2, 2) mesh did not finish in 5 minutes; one cell
took 17 minutes), while two dimensions trace in seconds.  The batch is
split 32 ways as on (2, 16, 16); ``fsdp`` shards parameters 32 ways where
the reference shards them 16 ways within a pod and replicates them across
the two, which is the same layout for the ``fsdp_over_pod``
architectures.

The layer stack is traced at depth 1 and at depth 2, and every count is
taken as ``c1 + (L - 1) * (c2 - c1)``: exact for the architectures here,
whose layers are all alike, as the reference's count of its scanned layer
body times the trip count is.  It keeps a 126-layer model's trace to
three layers.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba_1_5b \\
        --shape train_4k --mesh single --device cpu --force

One JSON per cell under ``results/dryrun_torch/`` (never the reference's
``results/dryrun/``), with the reference's fields less ``compile_s`` and
``cost_analysis_body_once`` (there is no compiler) and with ``memory``
holding only the arguments' bytes per rank.  ``lower_s`` is the trace's
wall time.  ``--save-ops`` (the default) also writes the per-op counts,
gzipped, under ``ops/``, which ``reanalyze`` reads.  The roofline terms are
a model under the H100 constants of ``hlo_stats``, not a measurement.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..models.sharding import use_mesh
from ..serve.engine import make_prefill_step, make_serve_step
from ..train.train_step import make_train_step
from .hlo_analyzer import HloAnalysis, analyze
from .hlo_stats import roofline_terms
from .mesh import fake_group, make_mesh, make_production_mesh
from .specs import SHAPES, cell_supported, input_specs, rules_for

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train), 2·N·D (fwd only); MoE uses active N."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: 1 token per sequence


def _local_bytes(tree) -> int:
    """Bytes of a rank's shards of every tensor in ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(t) for t in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def _trace(cfg, shape):
    """(per-op counts, argument bytes) of one rank running the cell's step
    under the active mesh."""
    # serve steps run under inference_mode: their inputs are made there
    # too, as a prefill makes the decode state
    with torch.inference_mode(shape.kind != "train"):
        args = input_specs(cfg, shape)
    if shape.kind == "train":
        fn = make_train_step(cfg)
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg, cache_len=shape.seq_len, impl="xla")
    else:
        fn = make_serve_step(cfg, impl="xla")
    return analyze(fn, *args).per_op, _local_bytes(args)


def _extrapolate(c1: dict, c2: dict, n_layers: int) -> dict:
    out = {}
    for k in set(c1) | set(c2):
        v1, v2 = c1.get(k, [0, 0, 0]), c2.get(k, [0, 0, 0])
        out[k] = [a + (n_layers - 1) * (b - a) for a, b in zip(v1, v2)]
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             device: str = "cuda", ops_dir: Optional[str] = None,
             cfg=None) -> dict:
    """One cell's record.  ``device`` is the mesh's device type (the
    tensors are ``meta`` whatever it is); ``cfg`` overrides ``arch``'s
    production config (tests pass smoke configs)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind}

    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = (make_mesh((32, 16), ("data", "model"), device=device)
                    if multi_pod else make_production_mesh(device=device))
            with use_mesh(mesh, rules_for(cfg, shape)):
                (c1, a1), (c2, a2) = (_trace(cfg.replace(n_layers=k), shape)
                                      for k in (1, 2))
        t_trace = time.time() - t0
        per_op = _extrapolate(c1, c2, cfg.n_layers)
        ana = HloAnalysis.from_ops(per_op)
        if ops_dir:
            os.makedirs(ops_dir, exist_ok=True)
            with gzip.open(os.path.join(
                    ops_dir, f"{arch}__{shape_name}__{mesh_name}.json.gz"),
                    "wt") as f:
                json.dump(per_op, f)
        chips = mesh.size()
        # analyzer totals are per device; the roofline formula takes
        # globals, so multiply back by the chip count
        flops_global = ana.flops * chips
        mf = model_flops(cfg, shape)
        rec.update(
            status="ok",
            chips=chips,
            lower_s=round(t_trace, 2),
            memory={"argument_size_in_bytes":
                    int(a1 + (cfg.n_layers - 1) * (a2 - a1))},
            hlo_analysis=ana.asdict(),
            model_flops=mf,
            hlo_flops=flops_global,
            useful_flops_ratio=(mf / flops_global) if flops_global else None,
            roofline=roofline_terms(flops_global, ana.hbm_bytes * chips,
                                    ana.collective_bytes * chips, chips),
        )
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--save-ops", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="save gzipped per-op counts next to results")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells with existing result files")
    ap.add_argument("--device", default="cuda",
                    help="device type of the meshes (default: cuda)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "pod2x16x16" if multi else "pod16x16"
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}.json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    print(f"[cached] {arch} {shape} {mesh_name}: "
                          f"{prev.get('status')}")
                    failures += prev.get("status") == "error"
                    continue
                rec = run_cell(
                    arch, shape, multi, device=args.device,
                    ops_dir=os.path.join(args.out, "ops")
                    if args.save_ops else None)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" trace={rec['lower_s']:.0f}s "
                             f"dom={r['dominant']} "
                             f"cmp={r['compute_s']*1e3:.2f}ms "
                             f"mem={r['memory_s']*1e3:.2f}ms "
                             f"col={r['collective_s']*1e3:.2f}ms")
                elif status == "error":
                    failures += 1
                    extra = " " + rec["error"][:160]
                elif status == "skipped":
                    extra = " " + rec["reason"][:80]
                print(f"[{status}] {arch} {shape} {mesh_name}{extra}",
                      flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
