#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  It builds the port's kernels from ``src/repro_torch/kernels/
csrc``, holds each against its plain PyTorch version on the card, times it,
drives the trace-driven spot-market simulation through the kernel (the
paper's 60-machine quick trace and a 12,583-machine Google-trace-scale
fleet), and checks the results against the numpy backend.  Any failed check
ends the run with a non-zero exit.  The last lines are a JSON record of the
kernels, the card's name and power limit, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
RTOL, ATOL = 1e-4, 1e-5        # kernel vs plain version, float32 both
N_CLUSTER = 12_583             # machines in the Google cluster trace
QUICK_PINNED = {"vms": 2582, "allocations": 3205, "interruptions": 623,
                "max_interruption_s": 364, "redeployed": 249}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def make_inputs(torch, rng, b, n, d=4, masked_frac=0.3, degen_col=None):
    free = rng.uniform(0, 100, (n, d)).astype("float32")
    if degen_col is not None:
        free[:, degen_col] = 42.0
    masks = rng.random((b, n)) >= masked_frac
    spot = rng.uniform(0, 1, (n, d)).astype("float32")
    alphas = rng.uniform(-0.5, 0.0, b).astype("float32")
    dev = torch.device("cuda")
    return (torch.from_numpy(free).to(dev), torch.from_numpy(masks).to(dev),
            torch.from_numpy(spot).to(dev), torch.from_numpy(alphas).to(dev))


def compare(torch, out, want, masks, what):
    """Unmasked entries within RTOL/ATOL, same argmax per row, masked entries
    <= -1e37.  Returns the largest absolute error on unmasked entries."""
    if out.shape != want.shape:
        fail(f"{what}: shape {tuple(out.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite scores")
    masks = masks.to(torch.bool)
    err = 0.0
    for r in range(out.shape[0]):
        m = masks[r]
        if not m.any():
            if not (out[r] <= -1e37).all():
                fail(f"{what}: row {r} is fully masked but scores > -1e37")
            continue
        o, w = out[r][m], want[r][m]
        if not torch.allclose(o, w, rtol=RTOL, atol=ATOL):
            fail(f"{what}: row {r} differs, max abs err "
                 f"{(o - w).abs().max().item():.3e}")
        if int(torch.argmax(out[r])) != int(torch.argmax(want[r])):
            fail(f"{what}: row {r} argmax differs")
        if not (out[r][~m] <= -1e37).all():
            fail(f"{what}: row {r} masked hosts score above -1e37")
        err = max(err, (o - w).abs().max().item())
    return err


def time_ms(torch, fn, runs=100, warmup=10, prefill=True):
    """Median of ``runs`` single-call times, each between two CUDA events.

    With ``prefill`` a ~1 ms spin is queued on the device before each run,
    so the call's host-side work (Python, argument checks, the launch) is
    done while the device is busy and the events bracket device time only.
    Without it the device waits for the host between the two events: that
    is the time per call as the caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if prefill:
            torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_busy_us(torch, prof):
    """Total self time of device-side activity (kernels, copies) in a
    profiler run, in µs, or None when the profiler saw no device time."""
    busy = 0.0
    for avg in prof.key_averages():
        if getattr(avg, "device_type", None) == torch.autograd.DeviceType.CUDA:
            busy += getattr(avg, "self_device_time_total", 0.0)
    return busy or None


def bound(free, masks):
    """Least time for one call: each input byte read once and each output
    byte written once at the HBM rate, against the float32 operations that
    this call's masks need (17*D + 2 per candidate host per row: compares,
    subtracts, divides, logs, multiplies, adds over the four stages) at the
    non-tensor-core float32 rate.  Returns (ms, "bytes" | "operations")."""
    n, d = free.shape
    b = masks.shape[0]
    nbytes = 2 * n * d * 4 + b * n + b * 4 + b * n * 4
    ops = (17 * d + 2) * int(masks.sum().item())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def trace_stats(sim, metrics):
    s = metrics.spot_stats(sim.vms)
    return {"vms": len(sim.vms), "allocations": metrics.allocations,
            "interruptions": s["interruptions"],
            "max_interruption_s": round(s["max_interruption_time"]),
            "redeployed": s["spot_finished_after_interruption"],
            "spot": s,
            "events": [(e.vm_id, e.time, e.host, e.kind, str(e.cause))
                       for e in metrics.interruption_events]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import SimConfig, hlem as core_hlem, make_policy
    from repro_torch.core import allocation as core_alloc
    from repro_torch.core.types import make_spot, resources
    from repro_torch.kernels import _build, hlem_score as hk, ops
    from repro_torch.market.trace import (TraceConfig, generate_trace,
                                          simulate_trace)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}")

    # -- build -----------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build("hlem_score")
    print(f"[build] hlem_score.cu -> {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in Path(f"{lib}.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    # -- kernel against its plain version on the card ----------------------------
    rng = np.random.default_rng(0)
    err_single = err_batch = 0.0
    for n in (1, 3, 100, 512, 513, 2000, N_CLUSTER):
        for alpha in (0.0, -0.5):
            free, masks, spot, _ = make_inputs(torch, rng, 1, n)
            out = hk.hlem_score(free, masks[0], spot, alpha)
            want = hk.hlem_score_ref(free, masks[0], spot, alpha)
            err_single = max(err_single, compare(
                torch, out[None], want[None], masks, f"single n={n} alpha={alpha}"))
            if not torch.equal(out, hk.hlem_score(free, masks[0], spot, alpha)):
                fail(f"single n={n}: two launches differ (not deterministic)")
    free, masks, spot, _ = make_inputs(torch, rng, 1, 64)
    masks[:] = False
    compare(torch, hk.hlem_score(free, masks[0], spot, 0.0)[None],
            hk.hlem_score_ref(free, masks[0], spot, 0.0)[None], masks, "all-masked")
    free, masks, spot, _ = make_inputs(torch, rng, 1, 1000, degen_col=3)
    err_single = max(err_single, compare(
        torch, hk.hlem_score(free, masks[0], spot, -0.5)[None],
        hk.hlem_score_ref(free, masks[0], spot, -0.5)[None], masks, "degenerate"))
    for b, n in ((1, 100), (4, 100), (3, 513), (8, 257), (64, N_CLUSTER)):
        free, masks, spot, alphas = make_inputs(torch, rng, b, n, degen_col=3)
        if b > 1:
            masks[0] = False
        out = hk.hlem_score_batch(free, masks, spot, alphas)
        want = hk.hlem_score_batch_ref(free, masks, spot, alphas)
        err_batch = max(err_batch, compare(torch, out, want, masks,
                                           f"batch b={b} n={n}"))
        if not torch.equal(out, hk.hlem_score_batch(free, masks, spot, alphas)):
            fail(f"batch b={b} n={n}: two launches differ (not deterministic)")
        for r in range(b):   # each row is the single-VM kernel on its mask
            if not torch.equal(out[r], hk.hlem_score(free, masks[r], spot,
                                                     float(alphas[r]))):
                fail(f"batch b={b} n={n}: row {r} differs from the single-VM launch")
    print(f"[check] kernel == plain version (rtol {RTOL}, atol {ATOL}, same "
          f"argmax, bit-equal reruns): single max_abs_err {err_single:.3e}, "
          f"batch max_abs_err {err_batch:.3e}")

    # -- timing at the cluster's width ---------------------------------------------
    timing = {}
    for b in (1, 64):
        free, masks, spot, alphas = make_inputs(torch, rng, b, N_CLUSTER)
        if b == 1:
            a = float(alphas[0])
            kernel = lambda: hk.hlem_score(free, masks[0], spot, a)
            plain = lambda: hk.hlem_score_ref(free, masks[0], spot, a)
        else:
            kernel = lambda: hk.hlem_score_batch(free, masks, spot, alphas)
            plain = lambda: hk.hlem_score_batch_ref(free, masks, spot, alphas)
        k_ms = time_ms(torch, kernel)
        k_call_ms = time_ms(torch, kernel, prefill=False)
        p_ms = time_ms(torch, plain, runs=100 if b == 1 else 50)
        p_call_ms = time_ms(torch, plain, runs=100 if b == 1 else 50,
                            prefill=False)
        b_ms, b_by = bound(free, masks)
        timing[b] = (k_ms, p_ms, b_ms, b_by)
        print(f"[time] n={N_CLUSTER} B={b}: kernel {k_ms:.4f} ms on the device "
              f"({k_call_ms:.4f} ms per call as the host sees it), plain "
              f"{p_ms:.4f} ms on the device ({p_call_ms:.4f} ms per call), "
              f"bound {b_ms:.6f} ms ({b_by}), library none "
              f"(no single PyTorch call computes HLEM scores); median of "
              f">= 50 runs; card {card}")

    # host -> device staging of the pool state, as one allocation does it
    hfree = rng.uniform(0, 100, (N_CLUSTER, 4))
    hspot = rng.uniform(0, 1, (N_CLUSTER, 4))
    hmask = rng.random((1, N_CLUSTER)) < 0.7

    def stage_sync():
        core_hlem.stage_to_device("cuda", hfree, hmask, hspot)
        torch.cuda.synchronize()

    for _ in range(10):
        stage_sync()
    t_stage = []
    for _ in range(100):
        t0 = time.perf_counter()
        stage_sync()
        t_stage.append(time.perf_counter() - t0)
    ws = core_hlem._DEVICE_WS[core_hlem.resolve_device("cuda")]
    nbytes = ws.nbytes
    copy_ms = time_ms(torch, lambda: ws.dev[:nbytes].copy_(ws.host[:nbytes],
                                                            non_blocking=True))
    print(f"[time] staging n={N_CLUSTER}: stage_to_device + synchronize "
          f"{statistics.median(t_stage) * 1e6:.1f} us on the host clock; its "
          f"{nbytes} B pinned->device copy {copy_ms * 1e3:.1f} us on the "
          f"device ({nbytes / (copy_ms * 1e-3) / 1e9:.1f} GB/s); median of 100")

    # -- quick trace through the kernel ------------------------------------------
    qcfg = TraceConfig(seed=0, n_machines=60, sim_days=0.08, n_spot=300,
                       load_per_machine=30.0, spot_durations_h=(1.0, 2.0))
    qtr = generate_trace(qcfg)
    quick = {}
    for backend in ("torch", "numpy"):
        hk.LAUNCHES = 0
        t0 = time.perf_counter()
        sim, metrics = simulate_trace(
            qtr, policy=make_policy("hlem-vmp-adjusted", backend=backend),
            cfg=qcfg, sim_config=SimConfig(record_timeline=False))
        torch.cuda.synchronize()
        quick[backend] = (trace_stats(sim, metrics), time.perf_counter() - t0,
                          hk.LAUNCHES)
    qs, qwall, qlaunch = quick["torch"]
    pinned = {k: qs[k] for k in QUICK_PINNED}
    print(f"[quick] torch/cuda: {pinned}, wall {qwall:.2f} s, launches {qlaunch}; "
          f"numpy wall {quick['numpy'][1]:.2f} s")
    if qs != quick["numpy"][0]:
        fail("quick trace: torch/cuda backend differs from the numpy backend")
    if pinned != QUICK_PINNED:
        fail(f"quick trace: {pinned} != pinned {QUICK_PINNED}")
    if qlaunch <= 0:
        fail("quick trace: the kernel was never launched")

    # -- cluster-scale trace: the main path ----------------------------------------
    ccfg = TraceConfig(seed=0, n_machines=N_CLUSTER, sim_days=0.005, n_spot=2000)
    horizon = ccfg.sim_days * 86_400.0
    t0 = time.perf_counter()
    ctr = generate_trace(ccfg)
    print(f"[cluster] trace: {N_CLUSTER} machines, {len(ctr.task_events)} VMs, "
          f"sim_days {ccfg.sim_days} (horizon {horizon:.0f} s), generated in "
          f"{time.perf_counter() - t0:.1f} s")
    spot_vms = [make_spot(10_000_000 + i, resources(c, c * 1536.0, 10.0, 1000.0),
                          3600.0) for i, c in enumerate(np.resize([1.0, 2.0, 4.0], 64))]

    def run_cluster(backend):
        policy = make_policy("hlem-vmp-adjusted", backend=backend)
        t0 = time.perf_counter()
        sim, metrics = simulate_trace(ctr, policy=policy, cfg=ccfg,
                                      sim_config=SimConfig(record_timeline=False),
                                      until=horizon)
        torch.cuda.synchronize()
        return sim, metrics, policy, time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    hk.LAUNCHES = 0
    sim, metrics, policy, wall = run_cluster("torch")
    sim_launches = hk.LAUNCHES
    batch_hosts = policy.find_hosts_batch(spot_vms, sim.pool, horizon)
    batch_launches = hk.LAUNCHES - sim_launches
    cstats = trace_stats(sim, metrics)
    alloc = max(metrics.allocations, 1)
    print(f"[cluster] torch/cuda: wall {wall:.2f} s, allocations "
          f"{metrics.allocations}, {wall * 1e6 / alloc:.1f} us/allocation, "
          f"kernel launches {sim_launches} in the simulation + {batch_launches} "
          f"in find_hosts_batch(64 VMs), spot {cstats['spot']}")
    if sim_launches <= 0 or batch_launches <= 0:
        fail("cluster trace: the kernel was not launched on the main path")
    if not ((batch_hosts >= 0) & (batch_hosts < sim.pool.n)).all():
        fail(f"find_hosts_batch returned out-of-range hosts: {batch_hosts}")

    sim_np, metrics_np, policy_np, wall_np = run_cluster("numpy")
    nstats = trace_stats(sim_np, metrics_np)
    agree = nstats == cstats
    batch_np = policy_np.find_hosts_batch(spot_vms, sim_np.pool, horizon)
    print(f"[cluster] numpy: wall {wall_np:.2f} s, allocations "
          f"{metrics_np.allocations}, {wall_np * 1e6 / max(metrics_np.allocations, 1):.1f}"
          f" us/allocation, spot {nstats['spot']}")
    print(f"[cluster] torch/cuda and numpy stats agree: {agree}; "
          f"find_hosts_batch agrees: {bool((batch_np == batch_hosts).all())} "
          f"(a float32 near-tie may flip a pick at this size)")

    # instrumented rerun: time split per scoring call, and the kernel held
    # against its plain version on the first 256 scoring calls' inputs
    split = {"h2d": 0.0, "kernel": 0.0, "total": 0.0, "calls": 0}
    captured = []
    orig_stage, orig_score = core_hlem.stage_to_device, ops.hlem_score
    orig_select = core_alloc.hlem_select_torch

    def stage(*a, **k):
        t = time.perf_counter()
        r = orig_stage(*a, **k)
        torch.cuda.synchronize()
        split["h2d"] += time.perf_counter() - t
        return r

    def score(free, mask, spot, alpha):
        t = time.perf_counter()
        out = orig_score(free, mask, spot, alpha)
        torch.cuda.synchronize()
        split["kernel"] += time.perf_counter() - t
        if len(captured) < 256:
            captured.append((free.clone(), mask.clone(), spot.clone(), alpha,
                             out.clone()))
        return out

    def select(*a, **k):
        t = time.perf_counter()
        r = orig_select(*a, **k)
        split["total"] += time.perf_counter() - t
        split["calls"] += 1
        return r

    core_hlem.stage_to_device, ops.hlem_score = stage, score
    core_alloc.hlem_select_torch = select
    try:
        sim_i, metrics_i, _, wall_i = run_cluster("torch")
    finally:
        core_hlem.stage_to_device, ops.hlem_score = orig_stage, orig_score
        core_alloc.hlem_select_torch = orig_select
    calls = max(split["calls"], 1)
    argmax_sync = split["total"] - split["h2d"] - split["kernel"]
    alloc_i = max(metrics_i.allocations, 1)
    print(f"[split] {split['calls']} scoring calls for {metrics_i.allocations} "
          f"allocations (wall {wall_i:.2f} s with a synchronize at each "
          f"boundary); per call: H2D copy {split['h2d'] / calls * 1e6:.1f} us, "
          f"kernel {split['kernel'] / calls * 1e6:.1f} us, argmax+sync "
          f"{argmax_sync / calls * 1e6:.1f} us; per allocation: H2D "
          f"{split['h2d'] / alloc_i * 1e6:.1f} us, kernel "
          f"{split['kernel'] / alloc_i * 1e6:.1f} us, argmax+sync "
          f"{argmax_sync / alloc_i * 1e6:.1f} us, rest of the simulator "
          f"{(wall_i - split['total']) / alloc_i * 1e6:.1f} us")
    if len(captured) == 0:
        fail("instrumented cluster run captured no scoring calls")
    for i, (free, mask, spot, alpha, out) in enumerate(captured):
        want = hk.hlem_score_ref(free, mask, spot, alpha)
        err_single = max(err_single, compare(torch, out[None], want[None],
                                             mask[None], f"captured call {i}"))
    print(f"[check] kernel == plain version on the first {len(captured)} "
          f"scoring calls of the cluster run (n={captured[0][0].shape[0]}); "
          f"single max_abs_err now {err_single:.3e}")

    # device busy and idle share over the first tenth of the cluster trace
    from torch.profiler import ProfilerActivity, profile
    window = horizon / 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics_w = simulate_trace(
            ctr, policy=make_policy("hlem-vmp-adjusted"), cfg=ccfg,
            sim_config=SimConfig(record_timeline=False), until=window)
        torch.cuda.synchronize()
        wall_w = time.perf_counter() - t0
    busy = device_busy_us(torch, prof)
    if busy is None:
        print("[profile] the profiler recorded no device time: device busy "
              "and idle share not measured")
    else:
        top = sorted((a for a in prof.key_averages()
                      if getattr(a, "device_type", None) == torch.autograd.DeviceType.CUDA),
                     key=lambda a: -a.self_device_time_total)[:4]
        by_name = "; ".join(f"{a.key[:60]} {a.self_device_time_total / 1e3:.1f} ms "
                            f"({a.count} calls)" for a in top)
        print(f"[profile] first {window:.1f} s of the cluster trace under the "
              f"profiler: wall {wall_w:.2f} s, {metrics_w.allocations} "
              f"allocations, device busy {busy / 1e3:.1f} ms, idle share "
              f"{1 - busy / 1e6 / wall_w:.4f}; {by_name}")

    kernels = []
    for name, b, line, launches, err in (
            ("hlem_score", 1, 137, sim_launches, err_single),
            ("hlem_score_batch", 64, 195, batch_launches, err_batch)):
        k_ms, p_ms, b_ms, b_by = timing[b]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hlem_score.cu",
            "replaces": f"src/repro/kernels/hlem_score.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
