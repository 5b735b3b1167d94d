"""Serving launcher: batched prefill + greedy decode with spot-interruption-
aware request scheduling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b --smoke --device cpu

The flags are the reference launcher's plus ``--device`` (default
``cuda``): on a CUDA device every prefill attention and every selective
scan runs through the port's CUDA kernels.  Weights are random, drawn by
``init_params`` from a ``torch.Generator`` seeded with ``--seed``; prompts
are drawn by numpy from the same seed, as the reference does.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..models.model import init_params
from ..serve import (
    Request,
    SpotServingScheduler,
    make_prefill_step,
    make_serve_step,
)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--interrupt-at", type=int, default=0,
                    help="simulate a spot interruption after N decode steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Serve ``--requests`` requests and return what happened: counts,
    per-batch prefill and decode times on the host clock (each bracketed by
    a device synchronise), the peak device memory, and each batch's
    prompts and generated tokens (an interrupted batch's up to the
    interruption)."""
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                               "the CPU")
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    cache_len = args.prompt_len + args.gen_tokens
    prefill = make_prefill_step(cfg, cache_len)
    step = make_serve_step(cfg)

    sched = SpotServingScheduler(batch_size=args.batch, hibernate=True)
    for i in range(args.requests):
        sched.add(Request(i, args.prompt_len, args.gen_tokens))

    rng = np.random.default_rng(args.seed)
    interrupt_at = args.interrupt_at
    prefill_s: List[float] = []
    decode_s: List[float] = []     # per batch, over its decode steps
    decode_counts: List[int] = []
    batches = []
    _sync(device)
    t0 = time.perf_counter()
    decode_steps = generated = 0
    while len(sched.done) < args.requests:
        batch_reqs = sched.fill_batch()
        if not batch_reqs:
            break
        b = len(batch_reqs)
        if cfg.modality == "text":
            prompts = torch.from_numpy(
                rng.integers(0, cfg.vocab, (b, args.prompt_len))).to(device)
        else:
            prompts = torch.from_numpy(
                rng.normal(0, 1, (b, args.prompt_len, cfg.d_model)).astype(
                    np.float32)).to(device)
        tp = time.perf_counter()
        logits, state = prefill(params, prompts)
        tok = torch.argmax(logits, dim=-1)[:, None]
        _sync(device)
        td = time.perf_counter()
        prefill_s.append(td - tp)
        out = [tok]
        interrupted = False
        for _ in range(args.gen_tokens - 1):
            if cfg.modality != "text":
                tok_in = torch.zeros((b, 1, cfg.d_model), dtype=torch.float32,
                                     device=device)
            else:
                tok_in = tok
            lg, state = step(params, tok_in, state)
            tok = torch.argmax(lg[:, -1, :], dim=-1)[:, None]
            out.append(tok)
            decode_steps += 1
            if interrupt_at and decode_steps == interrupt_at:
                print(f"[market] interruption after {decode_steps} decode "
                      f"steps — hibernating {b} in-flight requests")
                sched.interrupt()
                interrupted = True
                break
        _sync(device)
        decode_s.append(time.perf_counter() - td)
        decode_counts.append(len(out) - 1)
        generated += b * len(out)
        batches.append((prompts, torch.cat(out, dim=1)))
        if interrupted:
            # resume on the next fill_batch (hibernated first)
            interrupt_at = 0
            continue
        sched.step(args.gen_tokens)

    wall = time.perf_counter() - t0
    st = sched.stats()
    return {
        "cfg": cfg, "params": params, "device": device,
        "requests": args.requests, "done": st["done"],
        "interruptions": st["interruptions"], "decode_steps": decode_steps,
        "generated_tokens": generated, "wall_s": wall,
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_counts": decode_counts,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "batches": batches,
    }


def main(argv: Optional[List[str]] = None) -> int:
    r = run(argv)
    print(f"served {r['done']}/{r['requests']} requests in {r['wall_s']:.1f}s "
          f"({r['decode_steps']} decode steps, {r['interruptions']} request "
          f"interruptions) on {r['device']}")
    return 0 if r["done"] == r["requests"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
