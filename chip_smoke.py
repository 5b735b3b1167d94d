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
drives two main paths:

* the trace-driven spot-market simulation through the HLEM kernel (the
  paper's 60-machine quick trace and a 12,583-machine Google-trace-scale
  fleet), checked against the numpy backend;
* Hymba-1.5B serving at full width (``repro_torch.launch.serve``: 16
  requests of 2048-token prompts and 32 generated tokens, batch 8, one
  hibernation), whose prefill attention and every selective scan run
  through the flash-attention and scan kernels, checked against a
  teacher-forced forward.

Any failed check ends the run with a non-zero exit.  The last lines are a
JSON record of the kernels, the card's name and power limit, and
``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
RTOL, ATOL = 1e-4, 1e-5        # kernel vs plain version, float32 both
N_CLUSTER = 12_583             # machines in the Google cluster trace
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
    from repro_torch.core.hosts import HostPool
    from repro_torch.core.types import make_spot, resources
    from repro_torch.kernels import _build, hlem_score as hk, ops
    from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models.model import forward
    from repro_torch.serve import make_prefill_step, make_serve_step
    from repro_torch.market.trace import (TraceConfig, generate_trace,
                                          simulate_trace)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    sm_clock_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}")

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

    orig_place = HostPool.place

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

    # the numpy run records every placement, (VM id, host), in order
    np_placed = []

    def place_np(pool, vm, hid, now=0.0):
        np_placed.append((vm.id, hid))
        return orig_place(pool, vm, hid, now)

    HostPool.place = place_np
    try:
        sim_np, metrics_np, policy_np, wall_np = run_cluster("numpy")
    finally:
        HostPool.place = orig_place
    nstats = trace_stats(sim_np, metrics_np)
    agree = nstats == cstats
    batch_np = policy_np.find_hosts_batch(spot_vms, sim_np.pool, horizon)
    print(f"[cluster] numpy: wall {wall_np:.2f} s, allocations "
          f"{metrics_np.allocations}, {wall_np * 1e6 / max(metrics_np.allocations, 1):.1f}"
          f" us/allocation, spot {nstats['spot']}")
    print(f"[cluster] torch/cuda and numpy stats agree: {agree}; "
          f"final pools equal: "
          f"{bool(np.array_equal(sim.pool.free(), sim_np.pool.free()))}; "
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

    # the first placement that differs from the numpy run's, with the
    # scorer's inputs that chose it (the pool is unchanged between the
    # choice and the placement)
    last_select, first_diff, n_placed = {}, {}, [0]

    def place(pool, vm, hid, now=0.0):
        i = n_placed[0]
        n_placed[0] += 1
        if not first_diff and (i >= len(np_placed) or np_placed[i] != (vm.id, hid)):
            free, mask, spot, alpha = last_select["args"][:4]
            first_diff.update(
                i=i, vm=vm.id, host=hid,
                np_host=next((h for v, h in np_placed[i:] if v == vm.id), None),
                args=(free.copy(), np.array(mask), spot.copy(), float(alpha)))
        return orig_place(pool, vm, hid, now)

    def select(*a, **k):
        last_select["args"] = a
        t = time.perf_counter()
        r = orig_select(*a, **k)
        split["total"] += time.perf_counter() - t
        split["calls"] += 1
        return r

    core_hlem.stage_to_device, ops.hlem_score = stage, score
    core_alloc.hlem_select_torch, HostPool.place = select, place
    try:
        sim_i, metrics_i, _, wall_i = run_cluster("torch")
    finally:
        core_hlem.stage_to_device, ops.hlem_score = orig_stage, orig_score
        core_alloc.hlem_select_torch, HostPool.place = orig_select, orig_place
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
    if first_diff:   # a flipped pick, scored by the kernel and the oracle
        free, mask, spot, alpha = first_diff["args"]
        t, o = first_diff["host"], first_diff["np_host"]
        f32 = core_hlem.hlem_scores_torch(free, mask, spot, alpha).cpu().numpy()
        f64 = core_hlem.hlem_scores_np(free, mask, spot, alpha)
        print(f"[cluster] first placement that differs from numpy's: "
              f"#{first_diff['i']} of {n_placed[0]} (VM {first_diff['vm']}): "
              f"torch/cuda host {t}, numpy host {o}; float32 kernel scores "
              f"{float(f32[t])!r} vs "
              f"{None if o is None else float(f32[o])!r}, float64 oracle "
              f"{float(f64[t])!r} vs {None if o is None else float(f64[o])!r}")
    else:
        print(f"[cluster] all {n_placed[0]} placements equal the numpy run's")
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

    # -- attention and scan kernels against their plain versions ------------------
    t0 = time.perf_counter()
    att_err = check_attention(torch, rng, fa)
    scan_err = check_scan(torch, rng, ss)
    print(f"[check] flash_attention == plain version on {len(ATT_CASES)} cases "
          f"(tol {ATT_TOL}, bit-equal reruns): max abs err {att_err}; "
          f"ssm_scan == plain version on {len(SCAN_CASES)} cases + chunked == "
          f"full (tol y/hT {SCAN_TOL}, bit-equal reruns): max abs err (y, hT) "
          f"{scan_err}; {time.perf_counter() - t0:.1f} s")

    # -- Hymba-1.5B serving at full width: the second main path -------------------
    captured = {}
    orig_attention, orig_scan = ops.attention, ops.selective_scan

    def keep(*ts):
        return tuple(None if t is None else t.clone(
            memory_format=torch.contiguous_format) for t in ts)

    def attention_tap(q, k, v, **kw):   # keeps the first call's inputs
        out = orig_attention(q, k, v, **kw)
        if "attention" not in captured:
            captured["attention"] = (keep(q, k, v, out), kw)
        return out

    def scan_tap(*args):
        out = orig_scan(*args)
        if "scan" not in captured:
            captured["scan"] = keep(*args, *out)
        return out

    ops.attention, ops.selective_scan = attention_tap, scan_tap
    # the main path: counts set to 0 just before, read just after
    hk.LAUNCHES = fa.LAUNCHES = ss.LAUNCHES = 0
    try:
        served = serve_launch.run(SERVE_ARGV)
    finally:
        ops.attention, ops.selective_scan = orig_attention, orig_scan
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

    # captured first-layer prefill inputs: kernel against plain version
    (q, k, v, att_out), att_kw = captured["attention"]
    again = fa.flash_attention(q, k, v, **att_kw)
    if not torch.equal(again, att_out):
        fail("flash_attention on the captured inputs differs from the run")
    err = (again.float() - fa.mha_ref(q, k, v, **att_kw).float()).abs().max().item()
    if err > ATT_TOL["bfloat16"]:
        fail(f"flash_attention on the captured layer-0 inputs: err {err:.3e}")
    att_err["bfloat16"] = max(att_err["bfloat16"], err)
    x, dtv, a, bb, c, d, h0, y_run, h_run = captured["scan"]
    scan_args = (x, dtv, a, bb, c, d, h0)
    got = ss.ssm_scan(*scan_args)
    if not (torch.equal(got[0], y_run) and torch.equal(got[1], h_run)):
        fail("ssm_scan on the captured inputs differs from the run")
    ey, eh = compare_scan(torch, got, ss.ssm_scan_ref(*scan_args), "bfloat16",
                          "ssm_scan on the captured layer-0 inputs")
    scan_err["bfloat16"] = (max(scan_err["bfloat16"][0], ey),
                            max(scan_err["bfloat16"][1], eh))
    print(f"[check] on the captured layer-0 prefill inputs (q {tuple(q.shape)} "
          f"{q.dtype}, x {tuple(x.shape)} {x.dtype}): flash_attention max abs "
          f"err {err:.3e}, ssm_scan y {ey:.3e} hT {eh:.3e}; both bit-equal to "
          f"the serve run's outputs")

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
    del q, k, v, att_out, again, captured

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
