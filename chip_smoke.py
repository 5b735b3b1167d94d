#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  It builds the port's kernels from ``src/repro_torch/kernels/
csrc`` (one nvcc per source, in parallel), counts the wgmma (``HGMMA``)
instructions in each library's SASS (the bf16 flash-attention kernel must
have some), prints the HLEM kernel's cluster size at the cluster's width
(it must be above 1), holds each kernel against its plain PyTorch version
on the card, and times it beside a launch floor (an empty kernel).  It
drives these main paths:

* the trace-driven spot-market simulation through the HLEM kernel, which
  scores in float64 as the reference's default (numpy) scorer does (the
  paper's 60-machine quick trace and a 12,583-machine Google-trace-scale
  fleet), whose placements must equal the numpy backend's;
* the dynamic market at the launcher's ``--market`` defaults, each run a
  spec built by ``repro_torch.api``, through the kernel and on the numpy
  backend, and price fans on the card's float64 backend;
* the port's entry point, ``python -m repro_torch.launch.market_sim``, in
  subprocesses: a ``--spec`` sweep on 2 workers (seed 3, whose correlated
  cell a float32 scorer gets wrong), a ``--profile
  --events-out`` market run with ``--diff`` against the numpy backend's
  log, and a ``--serve`` run, each equal to the numpy backend's;
* Hymba-1.5B serving at full width (``repro_torch.launch.serve``: 16
  requests of 2048-token prompts and 32 generated tokens, batch 8, one
  hibernation), whose prefill attention and every selective scan run
  through the flash-attention and scan kernels, checked against a
  teacher-forced forward.
* granite-moe-3b-a800m serving at full width (8 requests, batch 8,
  2048-token prompts): the MoE block, and the flash kernel at a causal
  GQA-3 shape;
* training at full width through ``make_train_step(impl="xla")``
  (Hymba-1.5B, 4 steps; granite-moe, one step), the eval step through the
  kernels against the plain functions, and ``python -m
  repro_torch.launch.train`` at smoke size: a restart from its checkpoint
  against a straight run, and ``--elastic``;
* sharding (``[shard]``): Hymba-1.5B at full width on a one-rank NCCL
  group's (1, 1) ``DeviceMesh``, its parameters and AdamW state DTensors
  placed by ``train_state_specs``: two training steps whose losses must be
  bit-equal to the unsharded step's, and a sharded serve (a prefill, then
  decode steps) through the flash and scan kernels on the local shards,
  whose tokens must equal the unsharded serve's;
* the dry-run (``[dryrun]``, ``python -m repro_torch.launch.dryrun`` in
  subprocesses beside ``[shard]``): Hymba-1.5B x the four shapes and
  granite-moe x train_4k on the (16, 16) mesh, meta tensors under a fake
  group of 256 ranks, each cell's per-device flops, bytes and collectives
  and its H100 roofline terms (a model, not a measurement);
* the elastic layer's scheduling (``simulate_worker_availability`` at 256
  workers, a ``ClusterScheduler`` sequence) through the HLEM kernel,
  checked against the numpy backend.

Any failed check ends the run with a non-zero exit.  The last lines are a
JSON record of the kernels, the card's name and power limit, and
``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
F64_OPS_PER_S = 34e12          # the same for float64 (NVIDIA's H100 SXM data sheet)
# HLEM kernel vs plain version, float64 both, sums in different orders: a
# degenerate column's variation factor 1 - e is 0 exactly, and the order of
# e's n terms leaves ~n * 1e-16 in it, which moves every score by up to
# ~2e-11 relative at n = 12,583 (the plain version vs the numpy oracle, CPU)
RTOL, ATOL = 1e-10, 1e-10
N_CLUSTER = 12_583             # machines in the Google cluster trace
CLUSTER_DAYS = 0.0025          # 216 s of it (cut from 432 s for the time limit)
QUICK_PINNED = {"vms": 2582, "allocations": 3205, "interruptions": 623,
                "max_interruption_s": 364, "redeployed": 249}
KERNEL_SOURCES = ("hlem_score", "flash_attention", "ssm_scan")
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
# kernel vs plain version, as the reference's kernel tests hold Pallas
ATT_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 5e-3)}   # (y, hT)
# Hymba-1.5B at full width: two batches of 8, one hibernation and resume
SERVE_ARGV = ["--arch", "hymba_1_5b", "--requests", "16", "--batch", "8",
              "--prompt-len", "2048", "--gen-tokens", "32",
              "--interrupt-at", "8"]
# a greedy token may differ from teacher forcing only at a near tie: within
# two bf16 ulps of a logit of magnitude 4-8
NEAR_TIE = 0.0625
# the reference kernel tests' cases: b, h, hkv, tq, tk, dh, window, dtype,
# causal; then the model's prefill shape
ATT_CASES = [
    (2, 4, 4, 128, 128, 64, None, "float32", True),
    (1, 8, 2, 96, 96, 64, None, "float32", True),
    (1, 4, 2, 1, 200, 64, None, "float32", True),
    (2, 4, 4, 128, 128, 64, 32, "float32", True),
    (1, 2, 1, 64, 64, 128, None, "bfloat16", True),
    (1, 5, 1, 70, 70, 16, 16, "float32", True),
    (1, 2, 2, 50, 50, 32, None, "float32", False),
    # the tensor-core (bf16) kernel: every head dim, ragged Tq = Tk, Tq < Tk,
    # Tq = 1, no mask, and a window narrower than a key tile
    (1, 4, 2, 200, 200, 16, None, "bfloat16", True),
    (1, 4, 2, 200, 200, 32, 64, "bfloat16", True),
    (1, 4, 1, 300, 300, 128, 100, "bfloat16", True),
    (1, 5, 1, 2047, 2047, 64, 1024, "bfloat16", True),
    (1, 5, 1, 2049, 2049, 64, 1024, "bfloat16", True),
    (1, 5, 1, 300, 1000, 64, 1024, "bfloat16", True),
    (1, 4, 2, 1, 200, 64, None, "bfloat16", True),
    (1, 2, 2, 50, 50, 32, None, "bfloat16", False),
    (1, 4, 4, 200, 260, 128, None, "bfloat16", False),
    (1, 5, 1, 70, 70, 16, 16, "bfloat16", True),
    (1, 4, 2, 300, 300, 64, 16, "bfloat16", True),
    (8, 25, 5, 2048, 2048, 64, 1024, "bfloat16", True),
]
# n where the HLEM kernel's cluster rule changes the cluster size (C = 1, 2,
# 4, 8, 16 up to n = 1024, 2048, 4096, 8192, above), each with n - 1, n + 1
HLEM_BOUNDARIES = [m + d for m in (1025, 2049, 4097, 8193) for d in (-1, 0, 1)]
# b, t, dm, n, with_h0, dtype[, scale of a]; then the model's prefill and
# decode shapes; then the lane layout's edges: N not a multiple of the
# 4-state lane group, T around the 32-step tile, Dm off the 32-channel block
# (with and without 16-byte rows), and exp(dt * a) underflowing to 0
SCAN_CASES = [
    (2, 64, 128, 16, False, "float32"),
    (1, 100, 96, 16, True, "float32"),
    (1, 1, 64, 16, True, "float32"),
    (2, 64, 128, 16, False, "bfloat16"),
    (8, 2048, 3200, 16, False, "bfloat16"),
    (8, 1, 3200, 16, True, "bfloat16"),
    (2, 40, 128, 1, True, "float32"),
    (2, 40, 128, 3, True, "bfloat16"),
    (1, 50, 96, 33, True, "float32"),
    (1, 33, 70, 64, True, "float32"),
    (2, 31, 128, 16, True, "bfloat16"),
    (2, 32, 128, 16, True, "bfloat16"),
    (2, 33, 128, 16, True, "bfloat16"),
    (2, 64, 200, 16, False, "bfloat16"),
    (1, 40, 100, 16, True, "bfloat16"),
    (2, 40, 128, 16, True, "float32", 1000.0),
]
MUFU_PER_SM_CLOCK = 16         # Hopper's special-function unit: ex2 per SM per clock
# the reference launcher's --market defaults (launch/market_sim.py): 4 pools,
# 60 s ticks, advisor volatility, randomized bids floored at 0.45, the
# ``market`` scenario (170 hosts), 14,400 s, seed 0; its default grid and
# its --migration all comparison, then one resilience run.  The grid's runs
# are cut to 3,600 s (a quarter of the default horizon) to keep the script
# inside half its time limit; the storm run keeps its 7,200 s, the profiled
# run and the launcher's 14,400 s
MARKET_POOLS, MARKET_TICK, MARKET_UNTIL, MARKET_SEED = 4, 60.0, 14_400.0, 0
MARKET_GRID_UNTIL = 3_600.0
MARKET_RUNS = ([(r, p, "none", None, None, MARKET_GRID_UNTIL)
                for r in ("calm", "volatile", "correlated")
                for p in ("first-fit", "hlem-vmp-adjusted")]
               + [("volatile", "hlem-vmp-adjusted", m, None, None,
                   MARKET_GRID_UNTIL)
                  for m in ("greedy-cheapest", "gradient-aware", "risk-budgeted")]
               + [("volatile", "first-fit", "none", "diversified", "storm", 7200.0)])
FAN_TICKS, FAN_PATHS = 240, (64, 16_384)
# the [launch] phase: the example migration sweep cut to 1 seed (2 regimes x
# 2 migrations at the market workload's 14,400 s) on 2 workers.  Seed 3's
# (correlated, none) cell is where a float32 scorer parts from the
# reference; its row at the reference's default (numpy) scorer, by
# ``repro.api.run_one`` on the CPU, has these counts
LAUNCH_SPEC = ROOT / "examples" / "specs" / "migration_sweep.json"
LAUNCH_SEEDS, LAUNCH_WORKERS = [3], 2
LAUNCH_CELL = ("correlated", "none")
LAUNCH_CELL_PINNED = {"interruptions": 4167, "price_interruptions": 4044,
                      "waves": 133}
LAUNCH_MARKET = ["--market", "--regimes", "volatile", "--policy",
                 "hlem-vmp-adjusted"]
LAUNCH_SERVE = ["--serve", "diurnal", "--regimes", "volatile",
                "--fleet-target", "24", "--autoscale", "target-tracking",
                "--policy", "hlem-vmp-adjusted", "--json"]
# ``python -m repro_torch.launch.market_sim ARGS`` as ``-m`` runs it (runpy),
# in a process that also reports the HLEM kernel's launches: the launcher's
# process, and each sweep worker it forks, writes its count to a file named
# by its pid in $LAUNCH_COUNTS after every run
LAUNCHER = r"""
import os, runpy
from repro_torch.api import sweep
from repro_torch.kernels import hlem_score as hk


def count():
    path = os.path.join(os.environ["LAUNCH_COUNTS"], str(os.getpid()))
    with open(path, "w") as f:
        f.write(str(hk.LAUNCHES))


run_one = sweep.run_one


def counted(*args, **kwargs):
    row = run_one(*args, **kwargs)
    count()
    return row


sweep.run_one = counted
hk.LAUNCHES = 0
try:
    runpy.run_module("repro_torch.launch.market_sim", run_name="__main__",
                     alter_sys=True)
finally:
    count()
"""
PRICE_RTOL = 1e-12             # float64 torch price paths vs the numpy loop, atol 0
# granite-moe-3b-a800m at full width: 8 requests of 2048-token prompts, batch 8
MOE_ARGV = ["--arch", "granite_moe_3b_a800m", "--requests", "8", "--batch", "8",
            "--prompt-len", "2048", "--gen-tokens", "32"]
# training at full width through make_train_step(impl="xla"): Hymba-1.5B,
# AdamW, 4 steps at B = 8 x 512; then one granite-moe step at B = 4 x 512
TRAIN_HYMBA = ("hymba_1_5b", 8, 512, 4)
TRAIN_MOE = ("granite_moe_3b_a800m", 4, 512, 1)
# the eval loss through the kernels vs the plain functions (bf16, 32
# layers), an end-to-end check beside the kernels' element-wise ones on the
# eval step's captured inputs: the scan's bf16 output tolerance, the looser
# of the two kernels'
EVAL_ATOL = 5e-2
# the training launcher at smoke size: 8 steps straight vs 4 + a restart
# from the checkpoint for 4 more (losses at rtol 1e-5, as the reference's
# restart test holds them), and --elastic under two simulated interruptions
TRAIN_ARGV = ["--arch", "hymba_1_5b", "--smoke", "--device", "cuda",
              "--batch", "4", "--seq-len", "24", "--log-every", "1"]
RESTART_RTOL = 1e-5
ELASTIC_ARGV = TRAIN_ARGV + ["--elastic", "--steps", "20", "--seed", "3"]
# [shard]: Hymba-1.5B on a one-rank (1, 1) mesh: 2 train steps at B = 8 x
# 512 (bit-equal to the unsharded step's), a prefill at B = 8 x 2048 and 8
# decode steps (tokens equal to the unsharded serve's)
SHARD_TRAIN = ("hymba_1_5b", 8, 512, 2)
SHARD_SERVE = (8, 2048, 8)
# [dryrun]: cells on the (16, 16) mesh, one subprocess each, run beside [shard]
DRYRUN_CELLS = ([("hymba_1_5b", s) for s in ("train_4k", "prefill_32k",
                                             "decode_32k", "long_500k")]
                + [("granite_moe_3b_a800m", "train_4k")])
DRYRUN_TIMEOUT = 600
# the worker fleet of simulate_worker_availability: 256 spot workers under
# heavy on-demand churn (contention 100: ~600 arrivals over the horizon)
AVAIL_WORKERS, AVAIL_HORIZON, AVAIL_CONTENTION = 256, 3600.0, 100.0
# ``python -m repro_torch.launch.train ARGS`` as ``-m`` runs it, recording
# every step's loss (printed as the last line) and the HLEM kernel's
# launches (to $LAUNCH_COUNTS/<pid>, as LAUNCHER does)
TRAIN_LAUNCHER = r"""
import json, os, runpy
from repro_torch.kernels import hlem_score as hk
from repro_torch.models.sharding import full
from repro_torch.train import train_step as ts

losses = []
make = ts.make_train_step


def recorded(*args, **kwargs):
    step = make(*args, **kwargs)

    def run(state, batch):
        state, metrics = step(state, batch)
        losses.append(float(full(metrics["loss"])))
        return state, metrics
    return run


ts.make_train_step = recorded
hk.LAUNCHES = 0
try:
    runpy.run_module("repro_torch.launch.train", run_name="__main__",
                     alter_sys=True)
finally:
    with open(os.path.join(os.environ["LAUNCH_COUNTS"], str(os.getpid())),
              "w") as f:
        f.write(str(hk.LAUNCHES))
    print(json.dumps({"losses": losses}))
"""


def sass_count(lib, opcode):
    """How many ``opcode`` instructions the SASS of a built library holds."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "--dump-sass", str(lib)],
        check=True, capture_output=True, text=True).stdout
    return sum(1 for line in sass.splitlines() if f" {opcode}" in line)


def ptxas_usage(lib, entry):
    """(registers, spill store bytes, spill load bytes) that ``-Xptxas -v``
    reported for the first kernel whose mangled name holds ``entry``."""
    regs = stores = loads = None
    inside = False
    for line in Path(f"{lib}.log").read_text().splitlines():
        if "Compiling entry function" in line:
            if inside:
                break
            inside = entry in line
        elif inside and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            stores, loads = nums[1], nums[2]
        elif inside and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
    if regs is None:
        fail(f"no ptxas report for a kernel named *{entry}* in {lib}.log")
    return regs, stores, loads


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def make_inputs(torch, rng, b, n, d=4, masked_frac=0.3, degen_col=None):
    """Float64 HLEM inputs on the card: free (n, d), masks (b, n), spot
    (n, d), alphas (b,)."""
    free = rng.uniform(0, 100, (n, d))
    if degen_col is not None:
        free[:, degen_col] = 42.0
    masks = rng.random((b, n)) >= masked_frac
    spot = rng.uniform(0, 1, (n, d))
    alphas = rng.uniform(-0.5, 0.0, b)
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
    byte written once at the HBM rate (float64 free and spot, a mask byte,
    float64 alphas and scores), against the float64 operations that this
    call's masks need (29*D + 2 per candidate host per row: compares,
    subtracts, divides, logs, multiplies, adds over the four stages, with
    the two compensated dot products' 8 operations a term) at the
    non-tensor-core float64 rate.  Returns (ms, "bytes" | "operations")."""
    n, d = free.shape
    b = masks.shape[0]
    nbytes = 2 * n * d * 8 + b * n + b * 8 + b * n * 8
    ops = (29 * d + 2) * int(masks.sum().item())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def staging_paths(torch, core_hlem, HostPool, n, calls=300, rows=2,
                  seed=0):
    """Host time of one scoring call's staging at n hosts through each path,
    on the host clock: the whole fleet (the device's pool-less instance) and
    the pool's device mirror with ``rows`` rows written between calls (a
    placement writes one, a release one).  Each call starts with the card
    idle, as after the last call's pick.  Returns (medians in us, the
    mirror's bytes a call)."""
    rng = np.random.default_rng(seed)
    pool = HostPool()
    base = np.array([1.0, 2048.0, 250.0, 25_000.0])
    for _ in range(n):
        pool.add_host(float(rng.choice([16.0, 32.0, 64.0])) * base)
    dev = core_hlem.resolve_device("cuda")
    mirror = core_hlem._FleetMirror(dev)
    mask = rng.random(n) < 0.7
    clock = time.perf_counter
    took = {"full": [], "mirror": []}
    for i in range(calls + 20):
        for hid in rng.choice(n, rows, replace=False):
            pool.update_host(int(hid), pool.total[hid])
        order = ("full", "mirror") if i % 2 else ("mirror", "full")
        for path in order:
            torch.cuda.synchronize()
            t0 = clock()
            if path == "full":
                core_hlem.stage_to_device(dev, pool.free(), mask,
                                          pool.spot_frac_view())
            else:
                mirror.stage(pool, mask, None)
            dt = clock() - t0
            if i >= 20:
                took[path].append(dt)
    torch.cuda.synchronize()
    if mirror.full or mirror.rows_sent != rows:
        fail(f"staging probe n={n}: the mirror sent full={mirror.full}, "
             f"{mirror.rows_sent} rows, not {rows} rows")
    return ({k: statistics.median(v) * 1e6 for k, v in took.items()},
            mirror.nbytes)


def check_mirror_upload(torch, core_hlem, hk, HostPool, make_spot, resources,
                        n, seed=0):
    """The upload of a pool's device mirror (gather, one copy, the
    ``fleet_mirror_scatter`` launch) against its plain version on the card:
    after each call with k rows written (spot placements, which change free
    and the spot fraction, and new capacities), k = 1, 2 (with B = 64), 3,
    0 and the share of the fleet (``MIRROR_FULL_SHARE``), the device's
    planes, rows beyond n too, must equal ``mirror_scatter_ref`` of
    ``mirror_gather_ref``'s rows applied to a clone of the planes taken
    before the call, bit for bit, and equal the pool's own rows; each call
    must launch the scatter once and send only its rows.  One row past the
    share, the call must send the whole fleet.  Returns the number of calls
    checked."""
    rng = np.random.default_rng(seed)
    pool = HostPool()
    base = np.array([1.0, 2048.0, 250.0, 25_000.0])
    for _ in range(n):
        pool.add_host(float(rng.choice([16.0, 32.0, 64.0])) * base)
    next_id = [20_000_000]

    def write(hid):
        c = float(rng.choice([1.0, 2.0]))
        vm = make_spot(next_id[0], resources(c, c * 1536.0, 10.0, 1000.0),
                       3600.0)
        if rng.random() < 0.5 and pool.fits_fast(hid, vm.demand):
            pool.place(vm, hid)
            next_id[0] += 1
        else:
            pool.update_host(hid, pool.total[hid] * rng.uniform(1.0, 1.05))

    for hid in range(0, n, 3):
        write(hid)
    dev = core_hlem.resolve_device("cuda")
    mirror = core_hlem._FleetMirror(dev)
    rows = pool.planes().shape[1]

    def planes_d():
        return mirror.dev[:16 * rows * 4].view(torch.float64).view(2, rows, 4)

    # the first call (B = 64 sizes the buffers) sends the whole fleet
    mirror.stage(pool, rng.random((64, n)) < 0.7, rng.uniform(-1, 1, 64))
    torch.cuda.synchronize()
    if not mirror.full or not np.array_equal(mirror.held(n),
                                             pool.planes()[:, :n]):
        fail(f"mirror n={n}: the first call did not hold the pool's planes")
    limit = int(core_hlem.MIRROR_FULL_SHARE * n)
    cases = (1, 2, 3, 0, limit, limit + 1)
    for k in cases:
        full = k > limit
        want = planes_d().clone()
        ids = rng.choice(n, k, replace=False).astype(np.int32)
        for hid in ids:
            write(int(hid))
        src = np.empty((2, k, 4))
        hk.mirror_gather_ref(src, pool.planes(), ids)
        hk.mirror_scatter_ref(want, torch.from_numpy(src).to(dev),
                              torch.from_numpy(ids).to(dev))
        b = 64 if k == 2 else None
        masks = rng.random(n if b is None else (b, n)) < 0.7
        hk.SCATTERS = 0
        mirror.stage(pool, masks, None if b is None
                     else rng.uniform(-1, 1, b))
        torch.cuda.synchronize()
        if (mirror.full != full or mirror.rows_sent != (0 if full else k)
                or hk.SCATTERS != 1):
            fail(f"mirror n={n} k={k}: full={mirror.full}, "
                 f"{mirror.rows_sent} rows sent, {hk.SCATTERS} scatter "
                 f"launches (expected full={full}, one launch)")
        if int(mirror.bufs.done_np[0]) != mirror.bufs.ticket:
            fail(f"mirror n={n} k={k}: the scatter did not store its ticket")
        # bits, as rows past n hold whatever the buffer held (NaN too); a
        # full upload writes them too, so it is held to the first n
        m = n if full else rows
        got_bits = planes_d()[:, :m].view(torch.int64)
        want_bits = want[:, :m].view(torch.int64)
        if not torch.equal(got_bits, want_bits):
            bad = int((got_bits != want_bits).any(dim=2).sum())
            fail(f"mirror n={n} k={k}: {bad} rows differ from "
                 "mirror_scatter_ref on the planes before the call")
        if not np.array_equal(mirror.held(n), pool.planes()[:, :n]):
            fail(f"mirror n={n} k={k}: the planes differ from the pool's")
    pool.check_invariants()
    return len(cases)


def attention_bound(q, k, causal, window):
    """Least time for one attention call: q, k, v read and o written once at
    the HBM rate, against 4*dh flops (QK^T and PV) per unmasked (q, k) pair
    at the bf16 tensor-core rate (f32 rate for f32 inputs).  Exps and the
    softmax bookkeeping are not counted.  Returns (ms, by, flops)."""
    b, h, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    pairs = 0
    for i in range(tq):
        qpos = i + tk - tq
        hi = qpos if causal else tk - 1
        lo = max(0, qpos - window + 1) if window else 0
        pairs += max(0, min(hi, tk - 1) - lo + 1)
    flops = 4 * dh * pairs * b * h
    nbytes = q.element_size() * (2 * b * h * tq * dh + 2 * b * hkv * tk * dh)
    rate = BF16_OPS_PER_S if q.element_size() == 2 else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def scan_bound(x, n, with_h0):
    """Least time for one selective scan: x, dt, b, c, a, d (and h0) read,
    y and hT written once at the HBM rate, against the f32 operations per
    (b, t, d, n): dt*a, exp, dt*b, *x, the state FMA (2) and the output FMA
    (2), 8 in all, plus 2 per (b, t, d) for d*x + y, at the non-tensor-core
    f32 rate.  Returns (ms, by)."""
    bsz, t, dm = x.shape
    es = x.element_size()
    nbytes = (es * (3 * bsz * t * dm + 2 * bsz * t * n) + 4 * (dm * n + dm)
              + 4 * bsz * dm * n * (2 if with_h0 else 1))
    ops = 8 * bsz * t * dm * n + 2 * bsz * t * dm
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_attention(torch, rng, fa):
    """The flash kernel against its plain version on the reference's cases
    and the model's prefill shape: tolerance, finite, bit-equal reruns.
    Returns the largest absolute error by dtype."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for b, h, hkv, tq, tk, dh, window, dt, causal in ATT_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype("float32")).to(
            "cuda", dtype) for s in ((b, h, tq, dh), (b, hkv, tk, dh),
                                     (b, hkv, tk, dh)))
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        again = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.mha_ref(q, k, v, causal=causal, window=window)
        what = f"attention {(b, h, hkv, tq, tk, dh, window, dt, causal)}"
        if out.dtype != dtype or out.shape != want.shape:
            fail(f"{what}: got {out.dtype} {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            fail(f"{what}: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        if err > ATT_TOL[dt]:
            fail(f"{what}: max abs err {err:.3e} > {ATT_TOL[dt]}")
        if not torch.equal(out, again):
            fail(f"{what}: two launches differ (not deterministic)")
        errs[dt] = max(errs[dt], err)
        del q, k, v, out, again, want
    return errs


def scan_inputs(torch, rng, b, t, dm, n, with_h0, dt, a_scale=1.0):
    dtype = getattr(torch, dt)
    f = lambda *s: rng.normal(0, 1, s).astype("float32")
    x = torch.from_numpy(f(b, t, dm)).to("cuda", dtype)
    dtv = torch.from_numpy(rng.uniform(0.001, 0.1, (b, t, dm)).astype(
        "float32")).to("cuda", dtype)
    a = torch.from_numpy((-rng.uniform(0.1, 1, (dm, n)) * a_scale).astype(
        "float32")).cuda()
    bb = torch.from_numpy(f(b, t, n)).to("cuda", dtype)
    c = torch.from_numpy(f(b, t, n)).to("cuda", dtype)
    d = torch.from_numpy(f(dm)).cuda()
    h0 = torch.from_numpy(f(b, dm, n)).cuda() if with_h0 else None
    return x, dtv, a, bb, c, d, h0


def compare_scan(torch, got, want, dt, what):
    (y, h), (yr, hr) = got, want
    if y.dtype != yr.dtype or y.shape != yr.shape or h.shape != hr.shape:
        fail(f"{what}: got y {y.dtype} {tuple(y.shape)}, hT {tuple(h.shape)}")
    if not (torch.isfinite(y).all() and torch.isfinite(h).all()):
        fail(f"{what}: non-finite output")
    ey = (y.float() - yr.float()).abs().max().item()
    eh = (h - hr).abs().max().item()
    ty, th = SCAN_TOL[dt]
    if ey > ty or eh > th:
        fail(f"{what}: max abs err y {ey:.3e} (tol {ty}), hT {eh:.3e} (tol {th})")
    return ey, eh


def check_scan(torch, rng, ss):
    """The scan kernel against its plain version on the reference's cases,
    the model's prefill and decode shapes, and two chunks with carried
    state against one full scan.  Returns the largest (y, hT) errors by
    dtype."""
    errs = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    for case in SCAN_CASES:
        args = scan_inputs(torch, rng, *case)
        out = ss.ssm_scan(*args)
        again = ss.ssm_scan(*args)
        dt = case[5]
        ey, eh = compare_scan(torch, out, ss.ssm_scan_ref(*args), dt,
                              f"scan {case}")
        if not (torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])):
            fail(f"scan {case}: two launches differ (not deterministic)")
        e = errs[dt]
        errs[dt] = (max(e[0], ey), max(e[1], eh))
    x, dtv, a, bb, c, d, _ = scan_inputs(torch, rng, 1, 64, 64, 16, False,
                                         "float32")
    y_full, h_full = ss.ssm_scan(x, dtv, a, bb, c, d)
    y1, h1 = ss.ssm_scan(x[:, :32], dtv[:, :32], a, bb[:, :32], c[:, :32], d)
    y2, h2 = ss.ssm_scan(x[:, 32:], dtv[:, 32:], a, bb[:, 32:], c[:, 32:], d, h1)
    ey = (torch.cat([y1, y2], 1) - y_full).abs().max().item()
    eh = (h2 - h_full).abs().max().item()
    if ey > 1e-4 or eh > 1e-4:
        fail(f"scan: two chunks with carried state differ from one full scan "
             f"(y {ey:.3e}, hT {eh:.3e})")
    return errs


def device_breakdown(torch, prof):
    """Device self time in ms by kernel family, from a profiler run."""
    groups = {"flash_attention": 0.0, "ssm_scan": 0.0, "gemm": 0.0,
              "other": 0.0}
    for a in prof.key_averages():
        if getattr(a, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        key = a.key.lower()
        if "flash_attention_" in key:
            g = "flash_attention"
        elif "ssm_scan_kernel" in key:
            g = "ssm_scan"
        elif any(s in key for s in ("gemm", "xmma", "cutlass", "nvjet")):
            g = "gemm"
        else:
            g = "other"
        groups[g] += a.self_device_time_total / 1e3
    return groups


def top_kernels(torch, prof, k=8):
    """The ``k`` device kernels with the most self time: (name, ms, calls)."""
    rows = [(a.key, a.self_device_time_total / 1e3, a.count)
            for a in prof.key_averages()
            if getattr(a, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])[:k]


def trace_stats(sim, metrics):
    s = metrics.spot_stats(sim.vms)
    return {"vms": len(sim.vms), "allocations": metrics.allocations,
            "interruptions": s["interruptions"],
            "max_interruption_s": round(s["max_interruption_time"]),
            "redeployed": s["spot_finished_after_interruption"],
            "spot": s,
            "events": [(e.vm_id, e.time, e.host, e.kind, str(e.cause))
                       for e in metrics.interruption_events]}


def market_spec(ta, regime, policy, migration, fleet, faults, backend,
                device="cuda"):
    """A ``--market`` run as the launcher specifies it: the ``market``
    workload (170 hosts) under advisor volatility, randomized bids floored
    at 0.45, the HLEM policy's ``backend`` on ``device``."""
    params = ({"alpha": -0.5, "backend": backend, "device": device}
              if policy == "hlem-vmp-adjusted" else {})
    return ta.RunSpec(
        scenario=ta.ScenarioSpec(
            workload="market", regime=regime, n_pools=MARKET_POOLS,
            tick_interval=MARKET_TICK, from_advisor=True,
            bid=ta.BidSpec("randomized", {"lo": 0.45})),
        policy=ta.PolicySpec(policy, params),
        migration=ta.MigrationSpec(migration),
        fleet=(ta.FleetSpec(fleet, {"target_capacity": 64.0})
               if fleet else None),
        faults=ta.FaultSpec(faults) if faults else None)


class PlacementTap:
    """Records every placement (VM id, host) while installed, and the host
    time spent in the torch scorer's calls (staging, kernel, argmax and the
    result's trip to the host).  Given the placements of another run, it
    also keeps the first placement that differs from that run's, with the
    HLEM scorer's inputs that chose it (the pool does not change between
    the choice and the placement)."""

    def __init__(self, host_pool_cls, core_alloc, other=None):
        self.cls, self.alloc, self.other = host_pool_cls, core_alloc, other
        self.placed, self.first_diff, self.last_select = [], {}, None
        self.select_s, self.select_calls = 0.0, 0

    def __enter__(self):
        self.orig_place = orig_place = self.cls.place
        self.orig_select = orig_select = self.alloc.hlem_select_torch

        def place(pool, vm, hid, now=0.0):
            i, other = len(self.placed), self.other
            self.placed.append((vm.id, hid))
            if (other is not None and not self.first_diff
                    and (i >= len(other) or other[i] != (vm.id, hid))):
                free, mask, spot, alpha = self.last_select[:4]
                self.first_diff.update(
                    i=i, vm=vm.id, host=hid,
                    other_host=next((h for v, h in other[i:] if v == vm.id), None),
                    args=(free.copy(), np.array(mask), spot.copy(), float(alpha)))
            return orig_place(pool, vm, hid, now)

        def select(*a, **k):
            self.last_select = a
            t = time.perf_counter()
            r = orig_select(*a, **k)
            self.select_s += time.perf_counter() - t
            self.select_calls += 1
            return r

        self.cls.place, self.alloc.hlem_select_torch = place, select
        return self

    def __exit__(self, *exc):
        self.cls.place, self.alloc.hlem_select_torch = (self.orig_place,
                                                        self.orig_select)
        return False


class ScoreTap:
    """Keeps the inputs and the output of the first ``keep`` calls of
    ``ops.<name>`` (the scorer entry the simulator calls) while installed.
    The copies are queued on the call's stream, so they hold what the kernel
    read and wrote even where a staging buffer is reused."""

    def __init__(self, ops, name, keep=256):
        self.ops, self.name, self.keep, self.calls = ops, name, keep, []

    def __enter__(self):
        self.orig = orig = getattr(self.ops, self.name)

        def tap(*args):
            out = orig(*args)
            if len(self.calls) < self.keep:
                self.calls.append(tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args)
                    + (out.clone(),))
            return out

        setattr(self.ops, self.name, tap)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)
        return False


def tie_report(core_hlem, first_diff):
    """The scores of the first placement that differs from the numpy run's,
    by the kernel and by the float64 oracle, with their gaps: (text, True
    only where the two hosts' inputs are identical, free capacity and, for
    an adjusted VM (alpha != 0), spot fraction, so that their scores are
    equal in exact arithmetic and the oracle's matrix-vector product, which
    rounds rows by where they sit, decided between them)."""
    free, mask, spot, alpha = first_diff["args"]
    t, o = first_diff["host"], first_diff["other_host"]
    kern = core_hlem.hlem_scores_torch(free, mask, spot, alpha).cpu().numpy()
    f64 = core_hlem.hlem_scores_np(free, mask, spot, alpha)
    exact = (o is not None and bool(mask[t]) and bool(mask[o])
             and np.array_equal(free[t], free[o])
             and (alpha == 0.0 or np.array_equal(spot[t], spot[o])))
    if o is None:
        gaps = "no numpy placement of this VM to compare"
    else:
        gaps = (f"kernel scores {float(kern[t])!r} vs {float(kern[o])!r} "
                f"(gap {float(kern[t] - kern[o])!r}), float64 oracle "
                f"{float(f64[t])!r} vs {float(f64[o])!r} (gap "
                f"{float(f64[t] - f64[o])!r}); identical inputs: {exact}")
    text = (f"#{first_diff['i']} (VM {first_diff['vm']}): torch/cuda host {t}, "
            f"numpy host {o}; {gaps}")
    return text, exact


def run_market(torch, ta, tc, hk, ops, core_alloc, core_hlem, card):
    """The dynamic spot market at the launcher's ``--market`` defaults, each
    run a spec built and collected by ``repro_torch.api``.  Every HLEM run
    goes twice, through the kernel (torch backend on the card) and through
    the numpy float64 oracle; placements, rows and event streams must be
    equal, with no allowance for ties (a departure is printed by
    ``tie_report`` and fails).  The kernel is
    held against its plain version on the first 256 scoring calls of each
    kernel run and on the batch probe's call.  Returns the engine of the
    volatile hlem-vmp-adjusted run (for the fan), the largest absolute
    errors of the single and batch checks, and the kernel's launches over
    the kernel runs."""
    from repro_torch.api.build import event_streams

    total_launches, fan_engine = 0, None
    err_single = err_batch = 0.0
    profiles = [p[:4] for p in tc.VM_PROFILES]   # cpu, ram, bw, storage
    probe = [tc.make_spot(10_000_000 + i,
                          tc.resources(*profiles[i % len(profiles)]), 3600.0)
             for i in range(64)]
    t_phase = time.perf_counter()
    for regime, policy, mig, fleet, faults, until in MARKET_RUNS:
        what = (f"{regime} {policy} migration={mig}"
                + (f" fleet={fleet} faults={faults}" if fleet else "")
                + f" until={until:.0f}")
        hlem = policy.startswith("hlem")
        runs = {}
        for backend in (("numpy", "torch") if hlem else ("torch",)):
            other = runs["numpy"][4] if backend == "torch" and hlem else None
            spec = market_spec(ta, regime, policy, mig, fleet, faults, backend)
            sim = ta.build(spec, MARKET_SEED)
            with (PlacementTap(tc.HostPool, core_alloc, other) as tap,
                  ScoreTap(ops, "hlem_score") as scored):
                # the main path: counts set to 0 just before, read just after
                hk.LAUNCHES = 0
                t0 = time.perf_counter()
                metrics = sim.run(until=until)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = hk.LAUNCHES
            row = ta.collect_row(sim, metrics, spec, MARKET_SEED)
            events = event_streams(metrics)
            runs[backend] = (sim, row, events, wall, tap.placed, tap.first_diff,
                             launches, tap.select_s, tap.select_calls,
                             scored.calls)
        (sim, row, events, wall, _, first_diff, launches, select_s,
         select_calls, captured) = runs["torch"]
        alloc = max(row["allocations"], 1)
        print(f"[market] {what}: wall {wall:.2f} s, allocations "
              f"{row['allocations']}, HLEM launches {launches}, "
              f"{wall * 1e6 / alloc:.1f} us/allocation"
              + (f" (scoring calls {select_calls}, "
                 f"{select_s * 1e6 / max(select_calls, 1):.1f} us each on the "
                 f"host clock: staging + kernel + argmax + result to host, "
                 f"{select_s / wall:.3f} of the wall; numpy backend: "
                 f"{runs['numpy'][3]:.2f} s, "
                 f"{runs['numpy'][3] * 1e6 / max(runs['numpy'][1]['allocations'], 1):.1f}"
                 f" us/allocation)" if hlem else "")
              + f"; interruptions {row['interruptions']} (price "
              f"{row['price_interruptions']}) in {row['waves']} waves, "
              f"migrations {row['migrations']}"
              + (f", faults fired {row['faults_fired']}, fleet launches "
                 f"{row['fleet_launches']}, mean recovery {row['mean_recovery_s']} s"
                 if fleet else ""))
        if not np.isfinite(np.array([v for v in row.values()
                                     if not isinstance(v, str)],
                                    dtype=float)).all():
            fail(f"market {what}: non-finite value in the row {row}")
        if row["allocations"] <= 0 or row["interruptions"] <= 0:
            fail(f"market {what}: no allocation or no interruption: {row}")
        if fleet and (row["faults_fired"] <= 0 or row["fleet_launches"] <= 0):
            fail(f"market {what}: the storm did not fire or the fleet did not "
                 f"launch: {row}")
        if not hlem:
            if launches != 0:
                fail(f"market {what}: {policy} launched the HLEM kernel")
            continue
        total_launches += launches
        if launches <= 0:
            fail(f"market {what}: the HLEM kernel was not launched")
        _, row_np, events_np, _, placed_np = runs["numpy"][:5]
        same = row == row_np and events == events_np
        if first_diff:
            text, _ = tie_report(core_hlem, first_diff)
            fail(f"market {what}: the kernel's run departs from numpy's: "
                 f"{text}; rows equal: {row == row_np}, event streams equal: "
                 f"{events == events_np}")
        if not same:
            fail(f"market {what}: equal placements but rows or event streams "
                 f"differ: {row} vs {row_np}")
        print(f"[market]   rows, event streams and all {len(placed_np)} "
              f"placements equal the numpy backend's")
        # the kernel against its plain version on this run's own scoring
        # calls (n = the scenario's hosts, identical hosts tying exactly)
        if not captured:
            fail(f"market {what}: no scoring call was captured")
        err_run, ties = 0.0, 0
        for i, (free, mask, spot, alpha, out) in enumerate(captured):
            want = hk.hlem_score_ref(free, mask, spot, alpha)
            err_run = max(err_run, compare(torch, out[None], want[None],
                                           mask[None], f"market {what} call {i}"))
            ties += int((out == out.max()).sum()) > 1
        err_single = max(err_single, err_run)
        print(f"[market]   kernel == plain version on the first {len(captured)} "
              f"scoring calls (n={captured[0][0].shape[0]}, rtol {RTOL}, atol "
              f"{ATOL}, same argmax; {ties} of them with an exact tie at the "
              f"top): max_abs_err {err_run:.3e}")
        # the batched kernel on the run's final pool: 64 VMs of the
        # scenario's profiles, held against its plain version and the float64
        # oracle's picks; a probe made after the run (the simulator's flush
        # scores one row at a time and never reaches the batch kernel)
        hk.LAUNCHES = 0
        with ScoreTap(ops, "hlem_score_batch") as scored:
            picked = sim.policy.find_hosts_batch(probe, sim.pool, until)
        batch_launches = hk.LAUNCHES
        np_sim = runs["numpy"][0]
        if batch_launches <= 0 or not scored.calls:
            fail(f"market {what}: find_hosts_batch did not launch the batch kernel")
        for free, masks, spot, alphas, out in scored.calls:
            want = hk.hlem_score_batch_ref(free, masks, spot, alphas)
            err_run = compare(torch, out, want, masks, f"market {what} batch probe")
            err_batch = max(err_batch, err_run)
            print(f"[market]   batch kernel == plain version on the probe's "
                  f"call (B={out.shape[0]}, n={out.shape[1]}): max_abs_err "
                  f"{err_run:.3e}")
        want = np_sim.policy.find_hosts_batch(probe, np_sim.pool, until)
        n_same = int((picked == want).sum())
        print(f"[market]   find_hosts_batch(64 VMs) on the final pool: "
              f"{batch_launches} batch launch(es), {n_same}/64 picks equal "
              f"the float64 oracle's")
        if n_same != 64:
            fail(f"market {what}: batched picks differ from the oracle's: "
                 f"{picked.tolist()} vs {want.tolist()}")
        if regime == "volatile" and mig == "none":
            fan_engine = sim.engine
    print(f"[market] {len(MARKET_RUNS)} runs ({sum(r[1].startswith('hlem') for r in MARKET_RUNS)}"
          f" on both backends) in {time.perf_counter() - t_phase:.1f} s; HLEM "
          f"kernel launches over the kernel runs {total_launches}; kernel vs "
          f"plain version on the runs' own inputs: single max_abs_err "
          f"{err_single:.3e}, batch {err_batch:.3e}; card {card}")

    # device busy and idle share over one whole volatile run
    from torch.profiler import ProfilerActivity, profile
    sim = ta.build(market_spec(ta, "volatile", "hlem-vmp-adjusted", "none",
                               None, None, "torch"), MARKET_SEED)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = sim.run(until=MARKET_UNTIL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_us(torch, prof)
    if busy is None:
        print("[profile] the profiler recorded no device time: market device "
              "busy and idle share not measured")
    else:
        top = "; ".join(f"{name[:60]} {ms:.1f} ms ({calls} calls)"
                        for name, ms, calls in top_kernels(torch, prof, 4))
        print(f"[profile] market, volatile hlem-vmp-adjusted {MARKET_UNTIL:.0f} s "
              f"under the profiler: wall {wall:.2f} s, {metrics.allocations} "
              f"allocations, device busy {busy / 1e3:.1f} ms, idle share "
              f"{1 - busy / 1e6 / wall:.4f}; {top}; card {card}")
    return fan_engine, err_single, err_batch, total_launches


def rel_err(got, want):
    """Largest |got - want| / |want| (0 where both are 0)."""
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), np.finfo(np.float64).tiny)))


def run_fan(torch, tm, engine, card):
    """Monte-Carlo price fans from the market engine's state, and the regime
    comparison, on the card's float64 backend against the numpy loop."""
    for n_paths in FAN_PATHS:
        kw = dict(n_ticks=FAN_TICKS, n_paths=n_paths, seed=0)
        t0 = time.perf_counter()
        want = tm.simulated_price_fan(engine, **kw, backend="numpy")
        t_np = time.perf_counter() - t0
        tm.simulated_price_fan(engine, **kw, backend="torch")   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tm.simulated_price_fan(engine, **kw, backend="torch")
        t_torch = time.perf_counter() - t0
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"fan n_paths={n_paths}: {got.shape} vs {want.shape} or non-finite")
        rel = rel_err(got, want)
        if not np.allclose(got, want, rtol=PRICE_RTOL, atol=0):
            fail(f"fan n_paths={n_paths}: max rel err {rel:.3e} > {PRICE_RTOL}")
        print(f"[fan] simulated_price_fan({FAN_TICKS} ticks x {n_paths} paths x "
              f"{engine.n_pools} pools): torch/cuda float64 {t_torch * 1e3:.1f} ms, "
              f"numpy {t_np * 1e3:.1f} ms (host clock, shocks drawn and "
              f"quantiles taken on the host in both); max rel err {rel:.3e} "
              f"(rtol {PRICE_RTOL}, atol 0); card {card}")
    rng = np.random.default_rng(2)
    worst = 0.0
    for fam, kwargs in ((tm.AUCTION_FAMILY, dict(shock_sigma=0.4, shock_rho=0.6, seed=3)),
                        (tm.AUCTION_FAMILY, dict(shock_sigma=0.3, seed=5)),
                        (tm.SMOOTHED_FAMILY, dict(alpha=0.15, max_step=0.04))):
        utils, shocks = rng.uniform(0.0, 1.0, (50, 4)), rng.standard_normal((50, 4))
        p_np, s_np = tm.simulate_price_paths(fam, fam.init([kwargs] * 4), utils, shocks)
        p_t, s_t = tm.simulate_price_paths(fam, fam.init([kwargs] * 4), utils,
                                           shocks, backend="torch")
        for a, b in [(p_t, p_np)] + [(s_t[k], s_np[k]) for k in s_np]:
            if not np.allclose(a, b, rtol=PRICE_RTOL, atol=0):
                fail(f"price paths {fam.name} {kwargs}: torch/cuda differs "
                     f"from numpy beyond rtol {PRICE_RTOL}")
            worst = max(worst, rel_err(a, b))
    claims = tm.regime_comparison(n=600, seed=0)
    scan = tm.regime_comparison(n=600, seed=0, use_scan=True)
    for k, v in claims.items():
        if not abs(scan[k] - v) <= 1e-9 * abs(v):
            fail(f"regime_comparison on the card: {k} {scan[k]!r} vs {v!r}")
    print(f"[fan] simulate_price_paths on the card == numpy (both families, "
          f"rtol {PRICE_RTOL}): max rel err {worst:.3e}; regime_comparison("
          f"use_scan=True) on the card matches the scalar claims (rel 1e-9): {scan}")


def launch(argv, work, name, timeout=600, code=LAUNCHER,
           module="repro_torch.launch.market_sim"):
    """Runs ``python -m <module> *argv`` (``code``: ``LAUNCHER`` or
    ``TRAIN_LAUNCHER``) from the root of the checkout in a fresh process
    group, killed with its sweep workers if it outlives ``timeout`` s;
    fails on a non-zero exit.  Returns (stdout, stderr, wall s, HLEM kernel
    launches of the launcher and its sweep workers)."""
    counts = work / f"counts_{name}"
    counts.mkdir()
    path = str(ROOT / "src")
    if os.environ.get("PYTHONPATH"):
        path += os.pathsep + os.environ["PYTHONPATH"]
    env = dict(os.environ, LAUNCH_COUNTS=str(counts), PYTHONPATH=path)
    what = f"python -m {module} {' '.join(argv)}"
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code, *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"launch {name}: {what} ran past {timeout} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"launch {name}: {what} exited {proc.returncode}:\n"
             f"{out[-3000:]}\n{err[-3000:]}")
    launches = sum(int(f.read_text()) for f in counts.iterdir())
    return out, err, wall, launches


def strip_wall(row):
    return {k: v for k, v in row.items() if k != "wall_s"}


def run_launch(ta, kind, card):
    """The port's entry point on the card, ``python -m repro_torch.launch.
    market_sim``, in subprocesses (so the sweep's forked workers never meet
    the CUDA context this process holds): a ``--spec`` sweep on 2 workers
    through the kernel and on the numpy backend, whose report cells must be
    equal and whose kernel report's manifest must name the card; one
    ``--market --profile --events-out`` run, whose row and event log (by the
    launcher's ``--diff``) must equal the numpy backend's; and one
    ``--serve`` run, whose row must equal the numpy backend's.  The numpy
    counterparts of the single runs are the same specs run here through
    ``repro_torch.api``.  Returns the HLEM kernel's launches on this path."""
    t_phase = time.perf_counter()
    work = ROOT / "build" / "launch"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # 1. the spec sweep, through the kernel and on the numpy backend
    spec = json.loads(LAUNCH_SPEC.read_text())
    spec["seeds"] = LAUNCH_SEEDS
    reports, walls, launches = {}, {}, {}
    for backend in ("torch", "numpy"):
        spec["policies"][0]["params"]["backend"] = backend
        path = work / f"sweep_{backend}.json"
        path.write_text(json.dumps(spec))
        report = work / f"report_{backend}.json"
        _, _, walls[backend], launches[backend] = launch(
            ["--spec", str(path), "--workers", str(LAUNCH_WORKERS),
             "--report", str(report), "--fresh"], work, f"sweep_{backend}")
        if not report.is_file():
            fail(f"launch sweep ({backend}): no report at {report}")
        reports[backend] = json.loads(report.read_text())
    if launches["torch"] <= 0 or launches["numpy"] != 0:
        fail(f"launch sweep: HLEM kernel launches {launches} (kernel, numpy)")
    total = launches["torch"]
    n_runs = reports["torch"]["n_runs"]
    device = reports["torch"]["manifest"].get("device")
    print(f"[launch] --spec {LAUNCH_SPEC.relative_to(ROOT)} cut to seeds "
          f"{LAUNCH_SEEDS} ({n_runs} runs at {reports['torch']['horizon']} s) "
          f"on {LAUNCH_WORKERS} workers: kernel {walls['torch']:.1f} s "
          f"({walls['torch'] * LAUNCH_WORKERS / n_runs:.2f} s a run per "
          f"worker, {total} HLEM kernel launches), numpy backend "
          f"{walls['numpy']:.1f} s ({walls['numpy'] * LAUNCH_WORKERS / n_runs:.2f}"
          f" s a run per worker); host clock, process start included; "
          f"manifest device {device!r}; card {card}")
    if reports["torch"]["cells"] != reports["numpy"]["cells"]:
        fail("launch sweep: the kernel's report cells differ from the numpy "
             "backend's")
    if device != kind:
        fail(f"launch sweep: the report's manifest names {device!r}, not the "
             f"card {kind!r}")
    cell = next(c for c in reports["torch"]["cells"]
                if (c["regime"], c["migration"]) == LAUNCH_CELL)
    got = {k: cell["rows"][0][k] for k in LAUNCH_CELL_PINNED}
    print(f"[launch]   report cells equal the numpy backend's "
          f"({len(reports['torch']['cells'])} cells); {LAUNCH_CELL} at seed "
          f"{LAUNCH_SEEDS[0]} through the kernel: {got}, avg interruption "
          f"{cell['rows'][0]['avg_interruption_time']!r} s, realized spot cost "
          f"{cell['rows'][0]['realized_spot_cost']!r}")
    if got != LAUNCH_CELL_PINNED:
        fail(f"launch sweep: {LAUNCH_CELL} at seed {LAUNCH_SEEDS[0]} gives "
             f"{got}, not the reference's {LAUNCH_CELL_PINNED}")

    # 2. one market run with the profile and the event log
    log = work / "market_torch.ndjson"
    out, err, wall, n_launch = launch(
        LAUNCH_MARKET + ["--profile", "--events-out", str(log), "--json"],
        work, "market")
    total += n_launch
    row = strip_wall(json.loads(out)["rows"][0])
    if "subsystem" not in err:
        fail(f"launch market: --profile printed no table:\n{err[-3000:]}")
    table = err[err.index("subsystem"):].split("\n# wrote")[0].splitlines()
    print(f"[launch] {' '.join(LAUNCH_MARKET)} --profile --events-out: wall "
          f"{wall:.1f} s (host clock, process start included), allocations "
          f"{row['allocations']}, HLEM kernel launches {n_launch}; profile "
          f"(host clock; card {card}):")
    for line in table:
        print(f"[launch]   {line}")
    spec = market_spec(ta, "volatile", "hlem-vmp-adjusted", "none", None,
                       None, "numpy").replace(obs=ta.ObsSpec(events=True))
    sim = ta.build(spec, MARKET_SEED)
    metrics = sim.run(until=MARKET_UNTIL)
    row_np = ta.collect_row(sim, metrics, spec, MARKET_SEED)
    log_np = work / "market_numpy.ndjson"
    sim.events.save(str(log_np))
    if n_launch <= 0:
        fail("launch market: the HLEM kernel was not launched")
    if row != row_np:
        fail(f"launch market: the kernel's row differs from the numpy "
             f"backend's: {row} vs {row_np}")
    out, _, _, _ = launch(["--diff", str(log), str(log_np)], work, "diff")
    print(f"[launch]   row equals the numpy backend's; --diff of the two "
          f"event logs ({len(sim.events)} events): {out.strip()}")

    # 3. one serve run through the kernel
    out, _, wall, n_launch = launch(LAUNCH_SERVE, work, "serve")
    total += n_launch
    row = strip_wall(json.loads(out)["rows"][0])
    spec = ta.RunSpec(
        scenario=ta.ScenarioSpec(workload="serve-diurnal", regime="volatile",
                                 n_pools=MARKET_POOLS,
                                 tick_interval=MARKET_TICK, horizon=MARKET_UNTIL),
        policy=ta.PolicySpec("hlem-vmp-adjusted",
                             {"alpha": -0.5, "backend": "numpy"}),
        fleet=ta.FleetSpec("diversified", {"target_capacity": 24.0}),
        serve=ta.ServeSpec(), autoscale=ta.AutoscaleSpec("target-tracking"))
    row_np = ta.run_one(spec, MARKET_SEED, until=MARKET_UNTIL)
    print(f"[launch] {' '.join(LAUNCH_SERVE)}: wall {wall:.1f} s, requests "
          f"{row['requests_done']}/{row['requests_arrived']}, SLO attainment "
          f"{row['slo_attainment']}, HLEM kernel launches {n_launch}; row "
          f"equals the numpy backend's: {row == row_np}")
    if n_launch <= 0:
        fail("launch serve: the HLEM kernel was not launched")
    if row != row_np:
        fail(f"launch serve: the kernel's row differs from the numpy "
             f"backend's: {row} vs {row_np}")
    print(f"[launch] phase wall {time.perf_counter() - t_phase:.1f} s; HLEM "
          f"kernel launches on the launcher's path {total}")
    return total


class KernelTap:
    """Keeps the first call's inputs and outputs of ``ops.attention`` and of
    ``ops.selective_scan`` (the model's entries to the two kernels) while
    installed: ``attention`` is ((q, k, v, out), kwargs), ``scan`` is
    (x, dt, a, b, c, d, h0, y, hT); None where the op was not called."""

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.attention = self.scan = None

    def keep(self, *ts):
        return tuple(None if t is None else t.clone(
            memory_format=self.torch.contiguous_format) for t in ts)

    def __enter__(self):
        self.orig = orig_att, orig_scan = (self.ops.attention,
                                           self.ops.selective_scan)

        def attention(q, k, v, **kw):
            out = orig_att(q, k, v, **kw)
            if self.attention is None:
                self.attention = (self.keep(q, k, v, out), kw)
            return out

        def scan(*args):
            out = orig_scan(*args)
            if self.scan is None:
                self.scan = self.keep(*args, *out)
            return out

        self.ops.attention, self.ops.selective_scan = attention, scan
        return self

    def __exit__(self, *exc):
        self.ops.attention, self.ops.selective_scan = self.orig
        return False


def check_tapped(torch, fa, ss, tap, what):
    """The kernels on the first call's inputs that ``tap`` kept: against
    the run's own outputs (bit-equal) and element-wise against their plain
    versions (``ATT_TOL``, ``SCAN_TOL``, bf16).  Returns the attention
    error and the scan's (y, hT) errors, None for an op the run never
    called."""
    att_err = scan_err = None
    found = []
    if tap.attention is not None:
        (q, k, v, out), kw = tap.attention
        again = fa.flash_attention(q, k, v, **kw)
        if not torch.equal(again, out):
            fail(f"{what}: flash_attention on the captured inputs differs "
                 f"from the run")
        att_err = (again.float()
                   - fa.mha_ref(q, k, v, **kw).float()).abs().max().item()
        if att_err > ATT_TOL["bfloat16"]:
            fail(f"{what}: flash_attention on the captured layer-0 inputs: "
                 f"max abs err {att_err:.3e} > {ATT_TOL['bfloat16']}")
        found.append(f"flash_attention q {tuple(q.shape)} kv {tuple(k.shape)} "
                     f"{q.dtype} {kw}: max abs err {att_err:.3e}")
    if tap.scan is not None:
        *args, y_run, h_run = tap.scan
        got = ss.ssm_scan(*args)
        if not (torch.equal(got[0], y_run) and torch.equal(got[1], h_run)):
            fail(f"{what}: ssm_scan on the captured inputs differs from the run")
        scan_err = compare_scan(torch, got, ss.ssm_scan_ref(*args), "bfloat16",
                                f"{what}: ssm_scan on the captured layer-0 "
                                f"inputs")
        found.append(f"ssm_scan x {tuple(args[0].shape)} {args[0].dtype}, h0 "
                     f"{'given' if args[6] is not None else 'none'}: max abs "
                     f"err y {scan_err[0]:.3e} hT {scan_err[1]:.3e}")
    print(f"[check] {what}, kernels on the run's captured layer-0 inputs "
          f"against their plain versions: " + "; ".join(found)
          + "; bit-equal to the run's outputs")
    return att_err, scan_err


def run_moe(torch, ops, fa, ss, hk, serve_launch, forward, card):
    """granite-moe-3b-a800m served at its published width through
    ``repro_torch.launch.serve`` (every prefill attention through the flash
    kernel, the MoE block plain tensor code as in the reference): all
    requests served, first greedy tokens equal to a teacher-forced forward
    over the prompts (the same token groups as the prefill), that forward
    bit-equal across two runs, and the kernel held against its plain
    version and timed at this prefill's shape (GQA group 3, causal, no
    window).  Returns the flash kernel's launches on the path and its
    largest error here."""
    # the main path: counts set to 0 just before, read just after
    hk.LAUNCHES = fa.LAUNCHES = ss.LAUNCHES = 0
    with KernelTap(torch, ops) as tap:
        served = serve_launch.run(MOE_ARGV)
    fa_launches, ss_launches = fa.LAUNCHES, ss.LAUNCHES
    (q, k, v, att_out), att_kw = tap.attention
    cfg, params = served["cfg"], served["params"]
    n_prefill, steps = len(served["prefill_s"]), served["decode_steps"]
    print(f"[moe] {cfg.name} at full width ({cfg.n_params():,} parameters, "
          f"{cfg.n_active_params():,} active, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, {cfg.dtype}): served "
          f"{served['done']}/{served['requests']} requests, {n_prefill} "
          f"prefills, {steps} decode steps; kernel launches: flash_attention "
          f"{fa_launches}, ssm_scan {ss_launches}")
    if served["done"] != served["requests"]:
        fail(f"moe: served {served['done']}/{served['requests']} requests")
    if fa_launches != cfg.n_layers * n_prefill or ss_launches or hk.LAUNCHES:
        fail(f"moe: kernel launches flash {fa_launches} (expected "
             f"{cfg.n_layers} x {n_prefill}), scan {ss_launches}, hlem "
             f"{hk.LAUNCHES} (expected 0)")
    b, s = q.shape[0], q.shape[2]
    prefill_ms = statistics.median(served["prefill_s"]) * 1e3
    decode_ms = sum(served["decode_s"]) / sum(served["decode_counts"]) * 1e3
    print(f"[moe] prefill (B={b} x {s} tokens) {prefill_ms:.1f} ms (the run's "
          f"first, cold); decode {decode_ms:.2f} ms per step (B={b}); "
          f"{served['generated_tokens'] / served['wall_s']:.1f} generated "
          f"tokens/s over the run ({served['generated_tokens']} tokens, "
          f"{served['wall_s']:.2f} s wall, host clock); peak memory "
          f"{served['peak_bytes'] / 2**30:.2f} GiB; card {card}")

    # first tokens against a teacher-forced forward over the prompts, and
    # that forward (the MoE's routing, gathers and combine) twice
    n_first = 0
    for prompts, gen in served["batches"]:
        with torch.inference_mode():
            tf = forward(cfg, params, prompts)[:, -1].float()
            again = forward(cfg, params, prompts)[:, -1].float()
        if not torch.isfinite(tf).all():
            fail("moe: teacher-forced logits are not finite")
        if not torch.equal(tf, again):
            fail("moe: two forwards over the same prompts differ (not "
                 "bit-equal)")
        first_ok = tf.argmax(-1) == gen[:, 0]
        gap = tf.max(-1).values - tf.gather(-1, gen[:, :1]).squeeze(-1)
        if (~first_ok & (gap > NEAR_TIE)).any():
            fail(f"moe: first tokens {gen[:, 0].tolist()} != teacher-forced "
                 f"argmax {tf.argmax(-1).tolist()}")
        n_first += int(first_ok.sum())
    print(f"[moe] first token equals the teacher-forced argmax for "
          f"{n_first}/{served['requests']} prompts; the forward over the "
          f"prompts is bit-equal across two runs")

    # a warm prefill, then one prefill and 8 decode steps under the profiler
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import make_prefill_step, make_serve_step

    prefill = make_prefill_step(cfg, s + 32)
    step = make_serve_step(cfg)
    prompts = served["batches"][-1][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, prompts)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lg, st = prefill(params, prompts)
        tok = lg.argmax(-1)[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(8):
            lg, st = step(params, tok, st)
            tok = lg[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    busy = device_busy_us(torch, prof)
    print(f"[moe] warm prefill {warm_ms:.1f} ms (host clock, synchronized)")
    if busy is None:
        print("[profile] the profiler recorded no device time: moe device "
              "busy and idle share not measured")
    else:
        print(f"[profile] moe, one prefill (B={b} x {s}) + 8 decode steps under "
              f"the profiler: wall {(t2 - t0) * 1e3:.1f} ms (prefill "
              f"{(t1 - t0) * 1e3:.1f}, decode {(t2 - t1) * 1e3:.1f}), device "
              f"busy {busy / 1e3:.1f} ms, idle share "
              f"{1 - busy / 1e6 / (t2 - t0):.4f}; device ms by kernel family: "
              + ", ".join(f"{g} {t:.1f}" for g, t in
                          device_breakdown(torch, prof).items())
              + f"; card {card}")
        for name, ms, calls in top_kernels(torch, prof):
            print(f"[profile]   {ms:9.2f} ms {calls:6d} calls  {name[:90]}")
    del prefill, step, st, lg

    # the flash kernel at this prefill's shape
    err, _ = check_tapped(torch, fa, ss, tap, "moe serve")
    k_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **att_kw), runs=50)
    p_ms = time_ms(torch, lambda: fa.mha_ref(q, k, v, **att_kw), runs=10, warmup=2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                   runs=50)
    lib_err = (sdpa(q, k, v, is_causal=True, enable_gqa=True).float()
               - att_out.float()).abs().max().item()
    b_ms, b_by, flops = attention_bound(q, k, True, att_kw["window"])
    print(f"[time] flash_attention {tuple(q.shape)} kv {tuple(k.shape)} "
          f"{q.dtype} causal, no window (granite-moe prefill): kernel "
          f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} "
          f"ms, scaled_dot_product_attention {l_ms:.4f} ms (max abs diff to "
          f"the kernel {lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}); max abs "
          f"err vs plain {err:.3e}; medians; card {card}")
    del params, served, q, k, v, att_out, again, tap
    torch.cuda.empty_cache()
    return fa_launches, err


def train_steps(torch, tt, arch, batch, seq_len, steps, card,
                profile_last=False):
    """``steps`` steps of ``make_train_step(impl="xla")`` at the published
    width of ``arch``: losses finite, no kernel launched; with
    ``profile_last`` the last step runs under the profiler (device busy,
    idle share, top kernels).  Returns the config, the state, the last
    batch, (loss, grad norm, lr, s) per step and the peak GiB."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
    from repro_torch.train.train_step import batch_to_device

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tt.init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                                device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ds = tt.SyntheticDataset(cfg, tt.DataConfig(batch=batch, seq_len=seq_len,
                                                seed=0))
    step = tt.make_train_step(cfg)
    fa.LAUNCHES = ss.LAUNCHES = 0
    rows, prof = [], None
    for i in range(steps):
        b = batch_to_device(ds.next_batch(), "cuda")
        torch.cuda.synchronize()
        if profile_last and i == steps - 1:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss, gnorm, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        rows.append((loss, gnorm, lr, time.perf_counter() - t0))
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(r[:2]).all() for r in rows):
        fail(f"train {arch}: non-finite loss or grad norm: {rows}")
    if fa.LAUNCHES or ss.LAUNCHES:
        fail(f"train {arch}: the training step launched a kernel "
             f"(flash {fa.LAUNCHES}, scan {ss.LAUNCHES})")
    n = sum(p.numel() for p in state.params.parameters())
    print(f"[train] {cfg.name} at full width ({n:,} parameters, {cfg.dtype}, "
          f"{cfg.optimizer}, remat {cfg.remat}), B={batch} x {seq_len}, "
          f"make_train_step(impl='xla'): init {t_init:.1f} s; "
          + "; ".join(f"step {i + 1} loss {r[0]:.4f} grad_norm {r[1]:.4f} lr "
                      f"{r[2]:.2e} {r[3]:.2f} s" for i, r in enumerate(rows))
          + f"; peak memory {peak:.2f} GiB; no kernel launched; card {card}")
    if prof is not None:
        busy = device_busy_us(torch, prof)
        n_dev = sum(a.count for a in prof.key_averages()
                    if getattr(a, "device_type", None) == torch.autograd.DeviceType.CUDA)
        if busy is None:
            print("[profile] the profiler recorded no device time: train "
                  "device busy and idle share not measured")
        else:
            print(f"[profile] train {cfg.name}, step {steps} under the "
                  f"profiler: wall {rows[-1][3]:.2f} s, {n_dev} device kernels "
                  f"and copies ({busy / max(n_dev, 1):.1f} us each on average), "
                  f"device busy {busy / 1e6:.3f} s, idle share "
                  f"{1 - busy / 1e6 / rows[-1][3]:.4f}; card {card}")
            for name, ms, calls in top_kernels(torch, prof, 6):
                print(f"[profile]   {ms:9.2f} ms {calls:7d} calls  {name[:90]}")
    return cfg, state, b, rows, peak


def run_train(torch, ops, fa, ss, card):
    """Training at full width on the card: Hymba-1.5B for 4 steps and one
    granite-moe step (the MoE backward), through the plain functions; the
    eval step through the kernels, each kernel held element-wise against
    its plain version on the step's captured layer-0 inputs and the loss
    against the plain functions'; a loss through the kernels under grad
    raises.  Returns the flash and scan kernels' launches in the eval step
    and their errors there: (launches, attention err, scan (y, hT) err)."""
    import repro_torch.train as tt

    cfg, state, batch, rows, _ = train_steps(torch, tt, *TRAIN_HYMBA, card)
    # the eval step, through the kernels and through the plain functions
    fa.LAUNCHES = ss.LAUNCHES = 0
    t0 = time.perf_counter()
    with KernelTap(torch, ops) as tap:
        got = float(tt.make_eval_step(cfg, impl="kernel")(state.params, batch))
    t_kernel = time.perf_counter() - t0
    eval_launches = (fa.LAUNCHES, ss.LAUNCHES)
    att_err, scan_err = check_tapped(torch, fa, ss, tap, "Hymba eval step")
    del tap
    t0 = time.perf_counter()
    want = float(tt.make_eval_step(cfg)(state.params, batch))
    t_plain = time.perf_counter() - t0
    print(f"[train] eval step on one batch: through the kernels {got:.6f} "
          f"({t_kernel:.2f} s; flash_attention {eval_launches[0]}, ssm_scan "
          f"{eval_launches[1]} launches), plain functions {want:.6f} "
          f"({t_plain:.2f} s); |diff| {abs(got - want):.3e} (atol {EVAL_ATOL})")
    if not np.isfinite([got, want]).all() or abs(got - want) > EVAL_ATOL:
        fail(f"train: eval loss through the kernels {got} vs plain {want}")
    if eval_launches != (cfg.n_layers, cfg.n_layers):
        fail(f"train: eval step launched {eval_launches}, expected "
             f"{cfg.n_layers} each")
    try:
        tt.make_loss_fn(cfg, impl="kernel")(state.params, batch)
    except RuntimeError as e:
        if 'impl="xla"' not in str(e):
            fail(f'train: the kernel path under grad raised without naming '
                 f'impl="xla": {e}')
        print(f"[train] a loss through the kernels under grad raises: {e}")
    else:
        fail("train: a loss through the kernels under grad did not raise")
    del state, batch
    # its one step under the profiler (Hymba's ~2M profiler events take
    # minutes to summarise, so its steps run unprofiled)
    train_steps(torch, tt, *TRAIN_MOE, card, profile_last=True)
    torch.cuda.empty_cache()
    return eval_launches, att_err, scan_err


def run_train_launcher(card):
    """``python -m repro_torch.launch.train`` on the card at smoke size: 8
    steps straight against 4, then a restart from the checkpoint for 4
    more (losses at ``RESTART_RTOL``), and ``--elastic`` (steps, emergency
    saves, final loss).  Returns the HLEM kernel's launches (the elastic
    run's availability timeline)."""
    work = ROOT / "build" / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()

    def run(argv, name):
        out, _, wall, hlem = launch(argv, work, name, code=TRAIN_LAUNCHER,
                                    module="repro_torch.launch.train")
        lines = out.strip().splitlines()
        return lines[:-1], json.loads(lines[-1])["losses"], wall, hlem

    # the straight run, the first half and the elastic run at once; the
    # restart when the first half has ended
    with ThreadPoolExecutor(3) as pool:
        straight_f = pool.submit(run, TRAIN_ARGV + [
            "--steps", "8", "--ckpt-dir", str(work / "ck_a")], "straight")
        elastic_f = pool.submit(run, ELASTIC_ARGV + [
            "--ckpt-dir", str(work / "ck_e")], "elastic")
        _, first, wall_b, _ = run(TRAIN_ARGV + ["--steps", "4", "--ckpt-dir",
                                                str(work / "ck_b")], "first")
        out, second, wall_c, _ = run(TRAIN_ARGV + ["--steps", "4", "--ckpt-dir",
                                                   str(work / "ck_b")], "restart")
        _, straight, wall_a, _ = straight_f.result()
        elastic = elastic_f.result()
    resumed = first + second
    rel = np.abs(np.array(resumed) - straight) / np.abs(straight)
    free = shutil.disk_usage(work).free / 2**30
    print(f"[train] launcher --smoke restart: 8 steps straight ({wall_a:.1f} s) "
          f"vs 4 ({wall_b:.1f} s) + '{out[0]}' and 4 more ({wall_c:.1f} s), "
          f"host clock with process start, three processes at a time; "
          f"step-8 losses {straight[-1]:.6f} vs {resumed[-1]:.6f}, max rel "
          f"diff over the 8 steps {rel.max():.3e} (rtol {RESTART_RTOL}); "
          f"free disk at the checkpoint directory {free:.1f} GiB")
    if out[0] != "restored from step 4" or len(resumed) != 8:
        fail(f"train launcher: the restart did not resume at step 4: {out[:2]}")
    if not np.allclose(resumed, straight, rtol=RESTART_RTOL, atol=0):
        fail(f"train launcher: restart losses {resumed} != straight {straight}")
    out, losses, wall, hlem = elastic
    print(f"[elastic] {' '.join(ELASTIC_ARGV)}: {out[0]}; {out[1]}; {wall:.1f} s "
          f"(host clock, process start included); HLEM kernel launches "
          f"{hlem} (the availability timeline)")
    saves = int(out[0].split("emergency_saves=")[1].split()[0])
    if len(losses) != 20 or not np.isfinite(losses).all() or saves < 1 \
            or hlem <= 0:
        fail(f"elastic launcher: {out}, {len(losses)} losses, HLEM {hlem}")
    print(f"[train] launcher phase {time.perf_counter() - t_phase:.1f} s")
    return hlem


def start_dryrun():
    """Starts one ``python -m repro_torch.launch.dryrun`` a cell of
    ``DRYRUN_CELLS`` (meta tensors, meshes of CPU ranks: no card memory),
    writing to ``build/dryrun/``.  Returns (out dir, [(arch, shape,
    process)], start time)."""
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--device", "cpu", "--out",
         str(out), "--no-save-ops", "--force"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for arch, shape in DRYRUN_CELLS]
    return out, procs, time.perf_counter()


def stop_dryrun(procs):
    """Kills the cells still running."""
    for _, _, p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def finish_dryrun(out, procs, t0):
    """Waits for the cells (killing all on a failure) and prints one line
    each; fails if a cell errs.  Each cell's analysis is also held against
    the committed ``results/dryrun_torch/`` record (reported, not
    required: another torch may place some ops differently)."""
    try:
        for arch, shape, p in procs:
            try:
                _, err = p.communicate(timeout=max(
                    1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"dryrun {arch} {shape}: over {DRYRUN_TIMEOUT} s")
            name = f"{arch}__{shape}__pod16x16.json"
            path = out / name
            if not path.exists():
                fail(f"dryrun {arch} {shape}: exit {p.returncode}, no record: "
                     f"{err[-2000:]}")
            rec = json.loads(path.read_text())
            if p.returncode or rec["status"] != "ok":
                fail(f"dryrun {arch} {shape}: exit {p.returncode}, "
                     f"{rec['status']}: {rec.get('error')}\n"
                     f"{rec.get('traceback', '')[-3000:]}")
            ana, r = rec["hlo_analysis"], rec["roofline"]
            kept = ROOT / "results" / "dryrun_torch" / name
            same = (json.loads(kept.read_text()).get("hlo_analysis") == ana
                    if kept.exists() else "no record")
            print(f"[dryrun] {arch} {shape} pod16x16: {rec['status']}, trace "
                  f"{rec['lower_s']:.1f} s; per device: flops "
                  f"{ana['flops']:.4e}, bytes {ana['hbm_bytes']:.4e}, "
                  f"collective bytes {ana['collective_bytes']:.4e} "
                  f"{ {k: f'{v:.3e}' for k, v in ana['collective_by_kind'].items()} }; "
                  f"useful_flops_ratio {rec['useful_flops_ratio']:.4f}; "
                  f"H100 roofline model (not measured): compute "
                  f"{r['compute_s'] * 1e3:.3f} ms, memory "
                  f"{r['memory_s'] * 1e3:.3f} ms, collective "
                  f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}; "
                  f"analysis equals the committed record: {same}")
    finally:
        stop_dryrun(procs)
    print(f"[dryrun] {len(procs)} cells, all ok; wall "
          f"{time.perf_counter() - t0:.1f} s (beside [shard])")


def run_shard(torch, ops, fa, ss, card):
    """Hymba-1.5B at full width on a one-rank NCCL group's (1, 1) mesh: the
    parameters and AdamW state DTensors placed by ``train_state_specs``,
    two train steps whose losses must be bit-equal to the unsharded
    step's (one rank does the same arithmetic), the second under the
    dry-run's analyzer (its collectives by kind) and an eval step under
    ``CommDebugMode`` (whose module tracker cannot follow a remat
    backward); then a sharded serve through the kernels on the
    local shards, its tokens equal to the unsharded serve's and its tapped
    kernel calls held against their plain versions.  Ends the group.
    Returns (flash launches, scan launches, attention err, scan errs)."""
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.train as tt
    from repro_torch.configs import get_config
    from repro_torch.elastic.elastic import shard_batch
    from repro_torch.launch.hlo_analyzer import analyze
    from repro_torch.launch.mesh import destroy_group, init_group, make_mesh
    from repro_torch.models import sharding
    from repro_torch.models.model import init_params, shard_params
    from repro_torch.serve import make_prefill_step, make_serve_step
    from repro_torch.train.train_step import batch_to_device

    arch, b, s, steps = SHARD_TRAIN
    cfg = get_config(arch)
    init_group("nccl", 0, 1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        ds = tt.SyntheticDataset(cfg, tt.DataConfig(batch=b, seq_len=s, seed=0))
        batches = [ds.next_batch() for _ in range(steps)]
        step_fn = tt.make_train_step(cfg)

        def state0():
            return tt.init_train_state(
                cfg, torch.Generator("cuda").manual_seed(0), device="cuda")

        state, want, plain_s = state0(), [], []
        for bt in batches:
            batch = batch_to_device(bt, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            want.append(float(m["loss"]))
            plain_s.append(time.perf_counter() - t0)
        del state, m
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES = ss.LAUNCHES = 0
        got, shard_s = [], []
        with sharding.use_mesh(mesh):
            state = sharding.attach(state0(), tt.train_state_specs(cfg))
            placed = sum(isinstance(p, torch.distributed.tensor.DTensor)
                         for p in state.params.parameters())
            for i, bt in enumerate(batches):
                batch = shard_batch(bt, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == steps - 1:
                    res = {}
                    ana = analyze(lambda: res.update(out=step_fn(state, batch)))
                    state, m = res.pop("out")
                else:
                    state, m = step_fn(state, batch)
                got.append(float(sharding.full(m["loss"])))
                shard_s.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            with CommDebugMode() as comm:
                tt.make_eval_step(cfg)(state.params, batch)
        comm_counts = {str(k).split(".")[-1]: v
                       for k, v in comm.get_comm_counts().items()}
        n = sum(p.numel() for p in state.params.parameters())
        print(f"[shard] {cfg.name} at full width ({n:,} parameters, "
              f"{cfg.dtype}), {placed} DTensor parameters on the (1, 1) "
              f"('data', 'model') mesh of a one-rank NCCL group, AdamW state "
              f"placed by train_state_specs; B={b} x {s}: sharded losses "
              f"{got} vs unsharded {want}; bit-equal: {got == want}; step "
              f"walls sharded {', '.join(f'{x:.2f}' for x in shard_s)} s "
              f"(the last under the analyzer) vs unsharded "
              f"{', '.join(f'{x:.2f}' for x in plain_s)} s (host clock, "
              f"synchronized); peak memory {peak:.2f} GiB; the last step's "
              f"collectives {ana.collective_counts} ({ana.collective_bytes:.4e}"
              f" operand bytes); CommDebugMode counts of a sharded eval step "
              f"{comm_counts}; no kernel launched: "
              f"{(fa.LAUNCHES, ss.LAUNCHES) == (0, 0)}; card {card}")
        if got != want:
            fail(f"shard: sharded losses {got} differ from the unsharded "
                 f"step's {want}")
        if fa.LAUNCHES or ss.LAUNCHES:
            fail("shard: the training step launched a kernel")
        del state, m, batch
        torch.cuda.empty_cache()

        # the sharded serve against the unsharded one, same weights
        b, s, n_dec = SHARD_SERVE
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             device="cuda")
        prompts = torch.randint(0, cfg.vocab, (b, s), device="cuda",
                                generator=torch.Generator("cuda").manual_seed(1))

        def serve(tokens):
            prefill = make_prefill_step(cfg, s + n_dec)
            step = make_serve_step(cfg)
            lg, st = prefill(params, tokens)
            out = [sharding.full(lg).argmax(-1)]
            for _ in range(n_dec):
                tok = sharding.attach(out[-1][:, None], ("batch", "seq"))
                lg, st = step(params, tok, st)
                out.append(sharding.full(lg)[:, -1].argmax(-1))
            torch.cuda.synchronize()
            return torch.stack(out, 1)

        t0 = time.perf_counter()
        plain_tokens = serve(prompts)
        plain_wall = time.perf_counter() - t0
        # DTensors that inference-mode code takes views of are made there
        with torch.inference_mode():
            shard_params(params, mesh)
        fa.LAUNCHES = ss.LAUNCHES = 0
        with (torch.inference_mode(), sharding.use_mesh(mesh),
              KernelTap(torch, ops) as tap):
            t0 = time.perf_counter()
            shard_tokens = serve(sharding.attach(prompts, ("batch", "seq")))
            shard_wall = time.perf_counter() - t0
        launches = (fa.LAUNCHES, ss.LAUNCHES)
        same = torch.equal(shard_tokens, plain_tokens)
        print(f"[shard] sharded serve, prefill B={b} x {s} then {n_dec} decode "
              f"steps on the (1, 1) mesh: tokens equal the unsharded serve's: "
              f"{same} ({shard_tokens.numel()} tokens); wall {shard_wall:.2f} s "
              f"sharded vs {plain_wall:.2f} s unsharded (host clock); kernel "
              f"launches flash_attention {launches[0]}, ssm_scan {launches[1]}")
        if not same:
            fail("shard: the sharded serve's tokens differ from the unsharded "
                 "serve's")
        if launches != (cfg.n_layers, cfg.n_layers * (1 + n_dec)):
            fail(f"shard: kernel launches {launches}, expected "
                 f"({cfg.n_layers}, {cfg.n_layers * (1 + n_dec)})")
        att_err, scan_err = check_tapped(torch, fa, ss, tap,
                                         "Hymba sharded serve")
        del params, tap
        torch.cuda.empty_cache()
    finally:
        destroy_group()
    return launches[0], launches[1], att_err, scan_err


def run_elastic(torch, hk, tc, card):
    """The elastic layer's scheduling through the HLEM kernel against the
    numpy backend: ``simulate_worker_availability`` over 256 spot workers
    (event lists equal) and a ``ClusterScheduler`` placement sequence
    (placements and states equal).  Returns the kernel's launches."""
    from repro_torch.elastic import (ClusterScheduler, JobSpec,
                                     simulate_worker_availability)

    kw = dict(horizon=AVAIL_HORIZON, seed=0, contention=AVAIL_CONTENTION)
    # the main path: counts set to 0 just before, read just after
    hk.LAUNCHES = 0
    t0 = time.perf_counter()
    got = simulate_worker_availability(AVAIL_WORKERS, **kw)
    wall = time.perf_counter() - t0
    avail = hk.LAUNCHES
    t0 = time.perf_counter()
    want = simulate_worker_availability(
        AVAIL_WORKERS, **kw, policy=tc.HlemVmpAdjusted(backend="numpy"))
    wall_np = time.perf_counter() - t0
    kinds = {k: sum(e.kind == k for e in got) for k in ("start", "interrupt")}
    print(f"[elastic] simulate_worker_availability({AVAIL_WORKERS}, horizon="
          f"{AVAIL_HORIZON:.0f}, contention={AVAIL_CONTENTION:.0f}): "
          f"{len(got)} events {kinds}, fewest live workers "
          f"{min(e.available for e in got)}; kernel {wall:.2f} s, {avail} HLEM "
          f"launches; numpy {wall_np:.2f} s; event lists equal: {got == want}")
    if got != want or avail <= 0 or kinds["interrupt"] <= 0:
        fail("elastic: the kernel's availability timeline differs from "
             "numpy's, or nothing was scored or interrupted")

    rng = np.random.default_rng(5)
    jobs = []
    for i in range(64):
        chips = int(rng.choice([32, 64, 128, 256]))
        jobs.append((JobSpec(f"job-{i}", chips=chips, hbm_gb=chips * 16.0,
                             ici_gbps=chips * 80.0, host_ram_gb=chips * 40.0,
                             duration_h=float(rng.uniform(0.5, 4.0)),
                             preemptible=bool(rng.random() < 0.7)),
                     float(rng.uniform(0, 6 * 3600))))
    result = {}
    for backend in ("torch", "numpy"):
        cs = ClusterScheduler(n_slices=16)
        if backend == "numpy":
            cs.sim.policy = tc.HlemVmpAdjusted(alpha=-0.5, backend="numpy")
        hk.LAUNCHES = 0
        for job, at in jobs:
            cs.submit(job, at=at)
        metrics = cs.run(until_h=8.0)
        result[backend] = (cs.placement(), cs.states(), hk.LAUNCHES,
                           metrics.allocations,
                           sum(vm.interruptions for vm in cs._jobs.values()))
    placed, states, placement_launches, allocs, interrupted = result["torch"]
    print(f"[elastic] ClusterScheduler: 64 jobs on 16 v5e-256 slices over 8 h: "
          f"{allocs} allocations, {interrupted} spot-job interruptions, "
          f"{placement_launches} HLEM launches; placements and states equal "
          f"the numpy backend's: {result['torch'][:2] == result['numpy'][:2]}; "
          f"card {card}")
    if result["torch"][:2] != result["numpy"][:2] or placement_launches <= 0:
        fail("elastic: ClusterScheduler placements differ from numpy's or "
             "the kernel was not launched")
    return avail + placement_launches


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

    from repro_torch.core import SimConfig, hlem as core_hlem, make_policy
    from repro_torch.core import allocation as core_alloc
    from repro_torch.core.hosts import HostPool
    from repro_torch.core.types import make_spot, resources
    from repro_torch.kernels import _build, hlem_score as hk, ops
    from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models.model import forward
    from repro_torch.serve import make_prefill_step, make_serve_step
    from repro_torch.market.trace import (TraceConfig, generate_trace,
                                          simulate_trace)
    import repro_torch.api as ta
    import repro_torch.core as tc
    import repro_torch.market as tm

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    sm_clock_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}")
    t_start = t_last = time.perf_counter()

    def phase(name):
        """Prints the wall of the phase that just ended (host clock)."""
        nonlocal t_last
        now = time.perf_counter()
        print(f"[phase] {name}: {now - t_last:.1f} s (script {now - t_start:.1f} s)")
        t_last = now

    # -- build: one nvcc per source, all started together ------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
    print(f"[build] {', '.join(f'{n}.cu -> {p.name}' for n, p in libs.items())} "
          f"in {time.perf_counter() - t0:.1f} s (in parallel)")
    for name, lib in libs.items():
        for line in Path(f"{lib}.log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build]   {name}: {line.strip()}")
    # the serve path's scan instantiation: bf16, S = 4 lanes per channel
    scan_regs = ptxas_usage(libs["ssm_scan"], "ssm_scan_kernelI13__nv_bfloat16Li4E")
    print(f"[build] ssm_scan kernel <bf16, S=4> (the serve shape's): "
          f"{scan_regs[0]} registers, spill stores {scan_regs[1]} B, spill "
          f"loads {scan_regs[2]} B")
    hgmma = {name: sass_count(lib, "HGMMA") for name, lib in libs.items()}
    print(f"[build] HGMMA (wgmma) instructions in the SASS: {hgmma}")
    if hgmma["flash_attention"] == 0:
        fail("the flash_attention library holds no HGMMA instruction")
    cluster = hk.cluster_size(N_CLUSTER)
    print(f"[build] hlem_score launches clusters of {cluster} CTAs per row at "
          f"n={N_CLUSTER} (1 at the quick trace's n=60: {hk.cluster_size(60)})")
    if cluster <= 1:
        fail(f"hlem_score uses no thread-block cluster at n={N_CLUSTER}")

    # -- kernel against its plain version on the card ----------------------------
    rng = np.random.default_rng(0)
    err_single = err_batch = 0.0
    for n in (1, 3, 100, 512, 513, 2000, *HLEM_BOUNDARIES, N_CLUSTER, 60_000):
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
    for b, n in ((1, 100), (4, 100), (3, 513), (8, 257), (64, N_CLUSTER),
                 (2, 60_000), *((3, n) for n in HLEM_BOUNDARIES)):
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

    phase("build and kernel checks")

    # -- timing at the cluster's width ---------------------------------------------
    floor_ms = time_ms(torch, lambda: torch.cuda._sleep(0))
    print(f"[time] launch floor: an empty kernel (torch.cuda._sleep(0)) "
          f"{floor_ms:.4f} ms on the device, timed as the kernels below; "
          f"card {card}")
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
              f"bound {b_ms:.6f} ms ({b_by}), launch floor {floor_ms:.4f} ms, "
              f"library none "
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
    ws = core_hlem._POOLLESS[core_hlem.resolve_device("cuda")]
    nbytes = ws.nbytes
    copy_ms = time_ms(torch, lambda: ws.dev[:nbytes].copy_(ws.host[:nbytes],
                                                            non_blocking=True))
    print(f"[time] staging n={N_CLUSTER}: stage_to_device + synchronize "
          f"{statistics.median(t_stage) * 1e6:.1f} us on the host clock; its "
          f"{nbytes} B pinned->device copy {copy_ms * 1e3:.1f} us on the "
          f"device ({nbytes / (copy_ms * 1e-3) / 1e9:.1f} GB/s); median of 100")
    # the whole fleet against the pool's device mirror, with the rows a
    # placement and a release write, and with MIRROR_FULL_SHARE of the fleet
    for n in (170, 1_000, 4_000, N_CLUSTER):
        us, mbytes = staging_paths(torch, core_hlem, HostPool, n)
        print(f"[time] staging paths n={n}: whole fleet {us['full']:.1f} us, "
              f"mirror with 2 changed rows {us['mirror']:.1f} us ({mbytes} B) "
              f"a call on the host clock, medians of 300")
    rows = int(core_hlem.MIRROR_FULL_SHARE * N_CLUSTER)   # the most a delta
    us, mbytes = staging_paths(torch, core_hlem, HostPool, N_CLUSTER,
                               calls=60, rows=rows)
    print(f"[time] staging paths n={N_CLUSTER}: whole fleet "
          f"{us['full']:.1f} us, mirror with {rows} changed rows "
          f"{us['mirror']:.1f} us ({mbytes} B) a call on the host clock, "
          f"medians of 60")
    checked = sum(check_mirror_upload(torch, core_hlem, hk, HostPool,
                                      make_spot, resources, n)
                  for n in (170, N_CLUSTER))
    print(f"[check] fleet_mirror_scatter == mirror_scatter_ref on the planes "
          f"before each call, bit for bit, at n = 170 and {N_CLUSTER} "
          f"({checked} calls: k = 1, 2 at B = 64, 3, 0 and n/16 changed "
          f"rows as deltas, n/16 + 1 as a full upload), one launch a call")

    phase("HLEM timing and staging")

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

    phase("quick trace")

    # -- cluster-scale trace: the main path ----------------------------------------
    ccfg = TraceConfig(seed=0, n_machines=N_CLUSTER, sim_days=CLUSTER_DAYS,
                       n_spot=2000)
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
    hk.LAUNCHES = hk.SCATTERS = 0
    sim, metrics, policy, wall = run_cluster("torch")
    sim_launches, sim_scatters = hk.LAUNCHES, hk.SCATTERS
    mirror = sim.pool.mirror
    mirror_delta = mirror is not None and not mirror.full
    sim.pool.check_invariants()   # the mirror outside the log, one D2H
    batch_hosts = policy.find_hosts_batch(spot_vms, sim.pool, horizon)
    batch_launches = hk.LAUNCHES - sim_launches
    batch_scatters = hk.SCATTERS - sim_scatters
    print(f"[check] cluster trace: {sim_scatters} fleet_mirror_scatter "
          f"launches for {sim_launches} scoring calls, {batch_scatters} for "
          f"find_hosts_batch's {batch_launches}; the pool's mirror took the "
          f"last call's rows as a delta: {mirror_delta}")
    if (sim_scatters, batch_scatters) != (sim_launches, batch_launches):
        fail("cluster trace: the upload's scatter did not run once a "
             "scoring call on the main path")
    if not (isinstance(mirror, core_hlem._FleetMirror) and mirror_delta):
        fail("cluster trace: the main path did not stage through the pool's "
             "device mirror")
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

    # the numpy run records every placement, (VM id, host), in order
    with PlacementTap(HostPool, core_alloc) as np_tap:
        sim_np, metrics_np, policy_np, wall_np = run_cluster("numpy")
    nstats = trace_stats(sim_np, metrics_np)
    agree = nstats == cstats
    batch_np = policy_np.find_hosts_batch(spot_vms, sim_np.pool, horizon)
    print(f"[cluster] numpy: wall {wall_np:.2f} s, allocations "
          f"{metrics_np.allocations}, {wall_np * 1e6 / max(metrics_np.allocations, 1):.1f}"
          f" us/allocation, spot {nstats['spot']}")
    pools_equal = bool(np.array_equal(sim.pool.free(), sim_np.pool.free()))
    batch_equal = bool((batch_np == batch_hosts).all())
    print(f"[cluster] torch/cuda and numpy stats agree: {agree}; "
          f"final pools equal: {pools_equal}; find_hosts_batch(64 VMs) "
          f"agrees: {batch_equal}")

    # instrumented rerun: time split per scoring call, the kernel held
    # against its plain version on the first 256 scoring calls' inputs, and
    # the first placement that differs from the numpy run's
    split = {"h2d": 0.0, "kernel": 0.0}
    captured = []
    orig_stage, orig_score = core_hlem.stage_to_device, ops.hlem_score

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

    core_hlem.stage_to_device, ops.hlem_score = stage, score
    try:
        with PlacementTap(HostPool, core_alloc, np_tap.placed) as tap:
            sim_i, metrics_i, _, wall_i = run_cluster("torch")
    finally:
        core_hlem.stage_to_device, ops.hlem_score = orig_stage, orig_score
    calls = max(tap.select_calls, 1)
    argmax_sync = tap.select_s - split["h2d"] - split["kernel"]
    alloc_i = max(metrics_i.allocations, 1)
    print(f"[split] {tap.select_calls} scoring calls for {metrics_i.allocations} "
          f"allocations (wall {wall_i:.2f} s with a synchronize at each "
          f"boundary); per call: H2D copy {split['h2d'] / calls * 1e6:.1f} us, "
          f"kernel {split['kernel'] / calls * 1e6:.1f} us, argmax+sync "
          f"{argmax_sync / calls * 1e6:.1f} us; per allocation: H2D "
          f"{split['h2d'] / alloc_i * 1e6:.1f} us, kernel "
          f"{split['kernel'] / alloc_i * 1e6:.1f} us, argmax+sync "
          f"{argmax_sync / alloc_i * 1e6:.1f} us, rest of the simulator "
          f"{(wall_i - tap.select_s) / alloc_i * 1e6:.1f} us")
    if tap.first_diff:   # a flipped pick, scored by the kernel and the oracle
        text, exact = tie_report(core_hlem, tap.first_diff)
        print(f"[cluster] first placement that differs from numpy's, of "
              f"{len(tap.placed)}: {text}")
        if not exact:
            fail("cluster trace: the kernel's placements depart from numpy's "
                 "at hosts whose inputs differ")
        print("[cluster]   the two hosts' inputs are identical: an exact tie "
              "that the oracle's matrix-vector rounding decided (a reference "
              "gap, not a float64 difference)")
    else:
        print(f"[cluster] all {len(tap.placed)} placements equal the numpy "
              f"run's ({len(np_tap.placed)})")
        if len(tap.placed) != len(np_tap.placed) or not (
                agree and pools_equal and batch_equal):
            fail("cluster trace: equal placements, but the stats, final pools "
                 "or find_hosts_batch picks differ from numpy's")
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

    phase("cluster trace")

    # -- the dynamic spot market (--market grid) and price fans: the third path --
    fan_engine, err_m, err_mb, market_launches = run_market(
        torch, ta, tc, hk, ops, core_alloc,
                                           core_hlem, card)
    err_single, err_batch = max(err_single, err_m), max(err_batch, err_mb)
    run_fan(torch, tm, fan_engine, card)

    phase("market and fans")

    # -- the port's entry point, python -m repro_torch.launch.market_sim ---------
    # the main path: each launcher process counts from 0 and reports its count
    launch_launches = run_launch(ta, kind, card)

    phase("launcher")

    # -- attention and scan kernels against their plain versions ------------------
    t0 = time.perf_counter()
    att_err = check_attention(torch, rng, fa)
    scan_err = check_scan(torch, rng, ss)
    print(f"[check] flash_attention == plain version on {len(ATT_CASES)} cases "
          f"(tol {ATT_TOL}, bit-equal reruns): max abs err {att_err}; "
          f"ssm_scan == plain version on {len(SCAN_CASES)} cases + chunked == "
          f"full (tol y/hT {SCAN_TOL}, bit-equal reruns): max abs err (y, hT) "
          f"{scan_err}; {time.perf_counter() - t0:.1f} s")

    phase("attention and scan checks")

    # -- Hymba-1.5B serving at full width: the second main path -------------------
    # the main path: counts set to 0 just before, read just after
    hk.LAUNCHES = fa.LAUNCHES = ss.LAUNCHES = 0
    with KernelTap(torch, ops) as tap:
        served = serve_launch.run(SERVE_ARGV)
    fa_launches, ss_launches = fa.LAUNCHES, ss.LAUNCHES
    cfg, params = served["cfg"], served["params"]
    n_prefill, steps = len(served["prefill_s"]), served["decode_steps"]
    print(f"[serve] {cfg.name} at full width ({cfg.n_params():,} parameters, "
          f"{cfg.dtype}): served {served['done']}/{served['requests']} requests, "
          f"{n_prefill} prefills, {steps} decode steps, "
          f"{served['interruptions']} request interruptions; kernel launches: "
          f"flash_attention {fa_launches}, ssm_scan {ss_launches}")
    if served["done"] != served["requests"]:
        fail(f"served {served['done']}/{served['requests']} requests")
    if fa_launches != cfg.n_layers * n_prefill or fa_launches <= 0:
        fail(f"flash_attention launched {fa_launches} times, expected "
             f"{cfg.n_layers} per prefill x {n_prefill}")
    if ss_launches != cfg.n_layers * (n_prefill + steps) or ss_launches <= 0:
        fail(f"ssm_scan launched {ss_launches} times, expected {cfg.n_layers} "
             f"per prefill and per decode step x {n_prefill + steps}")
    if hk.LAUNCHES != 0:
        fail("the serve path launched the HLEM kernel")
    b, s = 8, 2048
    prefill_ms = statistics.median(served["prefill_s"]) * 1e3
    decode_ms = sum(served["decode_s"]) / sum(served["decode_counts"]) * 1e3
    print(f"[serve] prefill (B={b} x {s} tokens) {prefill_ms:.1f} ms median of "
          f"{n_prefill} ({', '.join(f'{x * 1e3:.1f}' for x in served['prefill_s'])}"
          f"); decode {decode_ms:.2f} ms per step (B={b}); "
          f"{served['generated_tokens'] / served['wall_s']:.1f} generated "
          f"tokens/s over the run ({served['generated_tokens']} tokens, "
          f"{served['wall_s']:.2f} s wall, host clock with a synchronize at "
          f"each prefill and batch end); peak memory "
          f"{served['peak_bytes'] / 2**30:.2f} GiB; card {card}")

    # captured first-layer prefill inputs: kernels against plain versions
    err, (ey, eh) = check_tapped(torch, fa, ss, tap, "Hymba serve")
    att_err["bfloat16"] = max(att_err["bfloat16"], err)
    scan_err["bfloat16"] = (max(scan_err["bfloat16"][0], ey),
                            max(scan_err["bfloat16"][1], eh))
    (q, k, v, att_out), att_kw = tap.attention
    scan_args = tap.scan[:7]
    x, a, h0 = scan_args[0], scan_args[2], scan_args[6]

    # greedy tokens against a teacher-forced forward through the kernels,
    # for every batch (the interrupted one up to its interruption)
    n_first = n_agree = n_tokens = 0
    for prompts, gen in served["batches"]:
        with torch.inference_mode():
            logits = forward(cfg, params,
                             torch.cat([prompts, gen[:, :-1]], dim=1))
        tf = logits[:, s - 1:].float()
        del logits
        if not torch.isfinite(tf).all():
            fail("teacher-forced logits are not finite")
        pred = tf.argmax(-1)
        first_ok = pred[:, 0] == gen[:, 0]
        gap = (tf[:, 0].max(-1).values
               - tf[:, 0].gather(-1, gen[:, :1]).squeeze(-1))
        if (~first_ok & (gap > NEAR_TIE)).any():
            fail(f"first generated tokens {gen[:, 0].tolist()} != teacher-"
                 f"forced argmax {pred[:, 0].tolist()} (gaps {gap.tolist()})")
        n_first += int(first_ok.sum())
        n_agree += int((pred == gen).sum())
        n_tokens += gen.numel()
        del tf
    n_prompts = sum(g.shape[0] for _, g in served["batches"])
    print(f"[serve] greedy vs teacher-forced forward over all "
          f"{len(served['batches'])} batches: first token agrees for "
          f"{n_first}/{n_prompts} prompts, share of all {n_tokens} generated "
          f"tokens agreeing {n_agree / n_tokens:.4f}")

    # kernel times at the main path's shapes (the captured layer-0 inputs)
    att_window = att_kw["window"]
    fa_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **att_kw), runs=50)
    fa_plain = time_ms(torch, lambda: fa.mha_ref(q, k, v, **att_kw), runs=10,
                       warmup=2)
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    sdpa_mask = (kpos <= qpos) & (kpos > qpos - att_window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fa_lib = time_ms(torch, lambda: sdpa(q, k, v, attn_mask=sdpa_mask,
                                         enable_gqa=True), runs=50)
    lib_err = (sdpa(q, k, v, attn_mask=sdpa_mask, enable_gqa=True).float()
               - att_out.float()).abs().max().item()
    fa_bound, fa_by, fa_flops = attention_bound(q, k, True, att_window)
    print(f"[time] flash_attention {tuple(q.shape)} kv {tuple(k.shape)} "
          f"{q.dtype} W={att_window}: kernel {fa_ms:.4f} ms "
          f"({fa_flops / fa_ms / 1e9:.1f} TFLOP/s), plain {fa_plain:.4f} ms, "
          f"scaled_dot_product_attention {fa_lib:.4f} ms (max abs diff to the "
          f"kernel {lib_err:.3e}), bound {fa_bound:.4f} ms ({fa_by}); medians; "
          f"card {card}")
    ss_ms = time_ms(torch, lambda: ss.ssm_scan(*scan_args), runs=50)
    ss_plain = time_ms(torch, lambda: ss.ssm_scan_ref(*scan_args), runs=3,
                       warmup=1, prefill=False)
    ss_bound, ss_by = scan_bound(x, a.shape[1], h0 is not None)
    dec = scan_inputs(torch, rng, b, 1, x.shape[2], a.shape[1], True, "bfloat16")
    ss_dec_ms = time_ms(torch, lambda: ss.ssm_scan(*dec), runs=100)
    n_exp = x.numel() * a.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu_ms = n_exp / (sms * MUFU_PER_SM_CLOCK * sm_clock_mhz * 1e6) * 1e3
    print(f"[time] ssm_scan x {tuple(x.shape)} {x.dtype} N={a.shape[1]}: kernel "
          f"{ss_ms:.4f} ms, plain {ss_plain:.4f} ms (a loop over time), "
          f"library none, bound {ss_bound:.4f} ms ({ss_by}), MUFU floor "
          f"{mufu_ms:.4f} ms ({n_exp:.3e} exps, one MUFU ex2 each, / ({sms} SMs x "
          f"{MUFU_PER_SM_CLOCK} per clock x {sm_clock_mhz} MHz, clocks.max.sm)); "
          f"decode shape (T=1, with h0) kernel {ss_dec_ms:.4f} ms, bound "
          f"{scan_bound(dec[0], a.shape[1], True)[0]:.6f} ms, launch floor "
          f"{floor_ms:.4f} ms; kernel <bf16, S=4> {scan_regs[0]} registers, "
          f"spill stores {scan_regs[1]} B, spill loads {scan_regs[2]} B; "
          f"medians; card {card}")
    del q, k, v, att_out, scan_args, x, a, h0, tap

    # where the device time goes in one prefill and 8 decode steps
    from torch.profiler import ProfilerActivity, profile
    prefill = make_prefill_step(cfg, s + 32)
    step = make_serve_step(cfg)
    prompts = served["batches"][-1][0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lg, st = prefill(params, prompts)
        tok = lg.argmax(-1)[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(8):
            lg, st = step(params, tok, st)
            tok = lg[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    busy = device_busy_us(torch, prof)
    groups = device_breakdown(torch, prof)
    if busy is None:
        print("[profile] the profiler recorded no device time: serve device "
              "busy and idle share not measured")
    else:
        print(f"[profile] serve, one prefill (B={b} x {s}) + 8 decode steps "
              f"under the profiler: wall {(t2 - t0) * 1e3:.1f} ms (prefill "
              f"{(t1 - t0) * 1e3:.1f}, decode {(t2 - t1) * 1e3:.1f}), device "
              f"busy {busy / 1e3:.1f} ms, idle share "
              f"{1 - busy / 1e6 / (t2 - t0):.4f}; device ms by kernel family: "
              + ", ".join(f"{g} {t:.1f}" for g, t in groups.items())
              + f"; card {card}")
        for name, ms, calls in top_kernels(torch, prof):
            print(f"[profile]   {ms:9.2f} ms {calls:6d} calls  {name[:90]}")
    del params, served, prefill, step, st, lg
    torch.cuda.empty_cache()

    phase("Hymba serving")

    # -- granite-moe-3b-a800m serving at full width: the MoE block ---------------
    moe_fa_launches, moe_err = run_moe(torch, ops, fa, ss, hk, serve_launch,
                                       forward, card)
    att_err["bfloat16"] = max(att_err["bfloat16"], moe_err)

    phase("granite-moe serving")

    # -- training at full width; the eval step through the kernels ----------------
    (eval_fa, eval_ss), eval_att, eval_scan = run_train(torch, ops, fa, ss, card)
    att_err["bfloat16"] = max(att_err["bfloat16"], eval_att)
    scan_err["bfloat16"] = (max(scan_err["bfloat16"][0], eval_scan[0]),
                            max(scan_err["bfloat16"][1], eval_scan[1]))

    phase("training")

    # -- sharding on a one-rank mesh, the dry-run's cells beside it -----------------
    dry = start_dryrun()
    try:
        shard_fa, shard_ss, shard_att, shard_scan = run_shard(
            torch, ops, fa, ss, card)
    except BaseException:
        stop_dryrun(dry[1])
        raise
    finish_dryrun(*dry)
    att_err["bfloat16"] = max(att_err["bfloat16"], shard_att)
    scan_err["bfloat16"] = (max(scan_err["bfloat16"][0], shard_scan[0]),
                            max(scan_err["bfloat16"][1], shard_scan[1]))

    phase("sharding and dry-run")

    # -- the training launcher: restart from a checkpoint, and --elastic -------------
    train_launches = run_train_launcher(card)

    phase("training launcher")

    # -- the elastic layer's scheduling through the HLEM kernel ---------------------
    elastic_launches = run_elastic(torch, hk, tc, card)

    # the single-VM kernel's launches over its main paths: the cluster trace,
    # the --market runs and the launcher's runs
    phase("elastic scheduling")
    hlem_launches = (sim_launches + market_launches + launch_launches
                     + train_launches + elastic_launches)
    print(f"[check] hlem_score launches on the main paths: cluster trace "
          f"{sim_launches}, --market runs {market_launches}, launcher "
          f"{launch_launches}, training launcher --elastic {train_launches}, "
          f"elastic scheduling {elastic_launches}; total {hlem_launches}")
    print(f"[check] flash_attention launches on the main paths: Hymba serve "
          f"{fa_launches}, granite-moe serve {moe_fa_launches}, Hymba eval "
          f"step {eval_fa}, sharded serve {shard_fa}; ssm_scan: Hymba serve "
          f"{ss_launches}, eval step {eval_ss}, sharded serve {shard_ss}")
    fa_launches += moe_fa_launches + eval_fa + shard_fa
    ss_launches += eval_ss + shard_ss
    kernels = []
    for name, b, line, launches, err in (
            ("hlem_score", 1, 137, hlem_launches, err_single),
            ("hlem_score_batch", 64, 195, batch_launches, err_batch)):
        k_ms, p_ms, b_ms, b_by = timing[b]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hlem_score.cu",
            "replaces": f"src/repro/kernels/hlem_score.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:130",
        "launches": fa_launches, "max_abs_err": max(att_err.values()),
        "ms": fa_ms, "plain_ms": fa_plain, "bound_ms": fa_bound,
        "bound_by": fa_by, "library_ms": fa_lib})
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:102",
        "launches": ss_launches,
        "max_abs_err": max(max(e) for e in scan_err.values()),
        "ms": ss_ms, "plain_ms": ss_plain, "bound_ms": ss_bound,
        "bound_by": ss_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
