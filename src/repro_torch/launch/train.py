"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1_5b
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1_5b --smoke --device cpu

Runs real training, its state placed on a (data, model) ``DeviceMesh``
as DTensors (``train_state_specs``).  Supports checkpoint/restart (state
and data cursor), periodic + final checkpointing, and elastic training
driven by the spot-market simulator (``--elastic``): emergency checkpoints
on the simulated interruptions, whose timeline the HLEM kernel scores on a
card.  The flags are the reference launcher's plus ``--device`` (default
``cuda``).  The step runs the model's plain, differentiable functions
(``impl="xla"``), as the reference's does.  A process alone is a one-rank
group (``--n-data 0`` means every rank of the group); a mesh wider than
the group raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs import get_config, get_smoke_config
from ..elastic import (
    CheckpointManager,
    ElasticTrainer,
    build_mesh,
    simulate_worker_availability,
)
from ..elastic.elastic import shard_batch
from ..launch.mesh import available_devices, destroy_group, ensure_group
from ..models.sharding import attach, full, tree_shardings, use_mesh
from ..train.data import DataConfig, SyntheticDataset
from ..train.train_step import (
    init_train_state,
    make_train_step,
    train_state_specs,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--n-data", type=int, default=0,
                    help="data-parallel width (0 = all devices)")
    ap.add_argument("--elastic", action="store_true",
                    help="train under simulated spot interruptions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq_len, seed=args.seed)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the "
                           "CPU")

    own_group = ensure_group(device)
    try:
        return _run(args, cfg, dcfg, device)
    finally:
        if own_group:
            destroy_group()


def _run(args, cfg, dcfg, device) -> int:
    n = args.n_data or available_devices(device)
    if args.elastic:
        events = simulate_worker_availability(n, horizon=args.steps,
                                              seed=args.seed, device=device)
        tr = ElasticTrainer(cfg, dcfg, args.ckpt_dir, max_workers=n,
                            seed=args.seed, device=device)
        rep = tr.train_elastic(args.steps, events)
        print(f"elastic run: steps={rep.steps_run} rescales={rep.rescales} "
              f"emergency_saves={rep.emergency_saves} restores={rep.restores}")
        print(f"final loss {rep.losses[-1]:.4f}")
        return 0

    mesh = build_mesh(n, device=device)
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=3)
    dataset = SyntheticDataset(cfg, dcfg)

    with use_mesh(mesh):
        specs = train_state_specs(cfg)
        state = init_train_state(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            device=device)
        latest = ckpt.latest_step()
        if latest is not None:
            state, meta = ckpt.restore(state, shardings=tree_shardings(specs))
            dataset.load_state_dict({"step": meta.get("data_step", 0),
                                     "seed": args.seed})
            print(f"restored from step {latest}")
        else:
            state = attach(state, specs)
        step_fn = make_train_step(cfg)

        t0 = time.time()
        for i in range(args.steps):
            batch = shard_batch(dataset.next_batch(), mesh)
            state, metrics = step_fn(state, batch)
            step = int(state.step)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {float(full(metrics['loss'])):.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({(time.time()-t0)/max(i+1,1):.2f}s/step)", flush=True)
            if args.checkpoint_every and step % args.checkpoint_every == 0:
                ckpt.save(state, step, {"data_step": dataset.step})
        ckpt.save(state, int(state.step), {"data_step": dataset.step},
                  block=True)
        ckpt.wait()
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
