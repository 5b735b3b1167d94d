"""The CUDA scan kernel's layout and reduction order, emulated on the CPU.

``csrc/ssm_scan.cu`` splits a channel's N states over S lanes of 4 states
each (S a power of two), stages tiles of 32 steps of x and dt (rows of the
block's channels) and of b and c (quads of 4 states, zero past N) with the
kernel's own index arithmetic, converts (dt, dt * x) to f32 once per tile,
and reduces the output dot product across the S lanes in transposed form,
once per group of S steps.  ``emulate_kernel`` below repeats that, block by block and lane by
lane, in PyTorch (fused multiply-adds rounded once, via float64), so an
algebra or indexing error shows here before the kernel runs on a card.  It
is held against the port's plain ``ssm_scan_ref`` and the reference
package's Pallas scan in interpret mode at the kernel tests' tolerances.
Nothing on the port's path imports this file.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as jax_scan
from repro_torch.kernels import ssm_scan as ss

# the kernel's constants
G, TILE = 4, 32

# the CPU scan tests' cases, then the layout's edges: N not a multiple of
# the lane group, T around the tile, Dm off the block's channel run (with
# and without 16-byte rows), and the decode shape
SSM_CASES = [
    (2, 64, 128, 16, False, "float32"),
    (1, 100, 96, 16, True, "float32"),
    (1, 1, 64, 16, True, "float32"),
    (2, 64, 128, 16, False, "bfloat16"),
]
EDGE_CASES = [
    (2, 40, 128, 1, True, "float32"),
    (2, 40, 128, 3, True, "bfloat16"),
    (1, 50, 96, 33, True, "float32"),
    (1, 33, 70, 64, True, "float32"),
    (2, 40, 100, 8, True, "float32"),
    (2, 31, 128, 16, True, "bfloat16"),
    (2, 32, 128, 16, True, "bfloat16"),
    (2, 33, 128, 16, True, "bfloat16"),
    (2, 64, 200, 16, False, "bfloat16"),
    (1, 40, 100, 16, True, "bfloat16"),
    (8, 1, 3200, 16, True, "bfloat16"),
]
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 5e-3)}   # (y, hT)


def lanes(n):
    """S: lanes per channel, the power of two >= ceil(n / 4)."""
    return 1 << max(0, math.ceil(math.log2(math.ceil(n / G))))


def channels(s):
    return 32 if s <= 8 else 16


def fma(a, b, c):
    """f32 fused multiply-add: one rounding."""
    return (a.double() * b.double() + c.double()).float()


def transposed_reduce(p):
    """p (..., S lanes, S partials) -> (..., S): entry j is the sum over the
    lanes of partial j, by the kernel's butterfly (round w pairs lanes j and
    j ^ w; the lane with bit w clear keeps the lower half)."""
    s = p.shape[-1]
    j = torch.arange(s)
    w = s // 2
    while w >= 1:
        upper = ((j & w) != 0)[:, None]
        lo, hi = p[..., :w], p[..., w:2 * w]
        send = torch.where(upper, lo, hi)
        keep = torch.where(upper, hi, lo)
        p = keep + send[..., j ^ w, :]
        w //= 2
    return p[..., 0]


def emulate_kernel(x, dt, a, b, c, d, h0=None):
    """The kernel's computation, block by block: (y in x's dtype, hT f32)."""
    bsz, t_len, dm = x.shape
    n = a.shape[1]
    s_lanes = lanes(n)
    cw_ = channels(s_lanes)
    e = 16 // x.element_size()
    vec_d, vec_n = dm % e == 0, n % G == 0
    xf, dtf, bf, cf = (z.reshape(-1) for z in (x, dt, b, c))
    af = a.reshape(-1)
    h0f = None if h0 is None else h0.reshape(-1)
    y = torch.zeros(bsz * t_len * dm, dtype=x.dtype)
    h_t = torch.zeros(bsz * dm * n, dtype=torch.float32)
    ch = torch.arange(cw_)
    n_idx = torch.arange(s_lanes)[:, None] * G + torch.arange(G)   # (S, G)
    for bb in range(bsz):
        for blk in range((dm + cw_ - 1) // cw_):
            d0 = blk * cw_
            live = d0 + ch < dm
            valid = live[:, None, None] & (n_idx < n)           # (C, S, G)
            hbase = (bb * dm + d0 + ch)[:, None, None] * n + n_idx
            abase = (d0 + ch)[:, None, None] * n + n_idx
            av = torch.where(valid, af[abase.clamp(0, af.numel() - 1)],
                             torch.zeros(()))
            h = (torch.zeros(valid.shape) if h0f is None else torch.where(
                valid, h0f[hbase.clamp(0, h0f.numel() - 1)], torch.zeros(())))
            dd = torch.where(live, d[(d0 + ch).clamp(max=dm - 1)],
                             torch.zeros(()))
            for t0 in range(0, t_len, TILE):
                steps = min(TILE, t_len - t0)
                row0 = bb * t_len + t0
                # stage: the raw tiles, as the kernel's copies index them
                xr = torch.zeros((steps, cw_), dtype=x.dtype)
                dr = torch.zeros((steps, cw_), dtype=x.dtype)
                if vec_d:
                    cpr = cw_ // e
                    for i in range(steps * cpr):
                        s, k = i // cpr, (i % cpr) * e
                        if d0 + k < dm:
                            g = (row0 + s) * dm + d0 + k
                            xr[s, k:k + e] = xf[g:g + e]
                            dr[s, k:k + e] = dtf[g:g + e]
                else:
                    for i in range(steps * cw_):
                        s, k = i // cw_, i % cw_
                        if d0 + k < dm:
                            g = (row0 + s) * dm + d0 + k
                            xr[s, k], dr[s, k] = xf[g], dtf[g]
                # b, c: quad q of step s, whole quads copied where n % 4 == 0
                # (the rest zeroed once), else value by value, 0 past n
                bq = torch.zeros((s_lanes, steps, G), dtype=x.dtype)
                cq = torch.zeros((s_lanes, steps, G), dtype=x.dtype)
                for q in range(s_lanes):
                    for s in range(steps):
                        g = (row0 + s) * n + 4 * q
                        if vec_n:
                            if 4 * q < n:
                                bq[q, s] = bf[g:g + G]
                                cq[q, s] = cf[g:g + G]
                        else:
                            for i in range(G):
                                if 4 * q + i < n:
                                    bq[q, s, i], cq[q, s, i] = bf[g + i], cf[g + i]
                # convert: (dt, dt * x) per channel in f32
                xv = torch.where(live, xr.float(), torch.zeros(()))
                dv = torch.where(live, dr.float(), torch.zeros(()))
                u_dt, u_dx = dv, dv * xv
                bw = bq.float().transpose(0, 1)              # (steps, S, G)
                cwt = cq.float().transpose(0, 1)
                yt = torch.zeros((steps, cw_), dtype=x.dtype)
                for s0 in range(0, steps, s_lanes):
                    part = torch.zeros((cw_, s_lanes, s_lanes))   # (C, lane, k)
                    for k in range(s_lanes):
                        if s0 + k >= steps:
                            break
                        s = s0 + k
                        acc = torch.zeros((cw_, s_lanes))
                        for g in range(G):
                            da = torch.exp(u_dt[s][:, None] * av[..., g])
                            h[..., g] = fma(da, h[..., g],
                                            u_dx[s][:, None] * bw[s, :, g])
                            acc = fma(h[..., g], cwt[s, :, g], acc)
                        part[..., k] = acc
                    red = transposed_reduce(part)               # (C, lane)
                    for j in range(s_lanes):
                        if s0 + j < steps:
                            yt[s0 + j] = fma(dd, xr[s0 + j].float(),
                                             red[:, j]).to(x.dtype)
                for s in range(steps):   # write-out, either copy width
                    lo = (row0 + s) * dm + d0
                    m = int(live.sum())
                    y[lo:lo + m] = yt[s, :m]
            h_t[hbase[valid]] = h[valid]
    return y.view(bsz, t_len, dm), h_t.view(bsz, dm, n)


def _inputs(b, t, dm, n, with_h0, seed=0, a_scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    x = f(b, t, dm)
    dt = rng.uniform(0.001, 0.1, (b, t, dm)).astype(np.float32)
    a = (-rng.uniform(0.1, 1, (dm, n)) * a_scale).astype(np.float32)
    bb, c, d = f(b, t, n), f(b, t, n), f(dm)
    h0 = f(b, dm, n) if with_h0 else None
    return x, dt, a, bb, c, d, h0


def _torch(arrays, dtype):
    low = {0, 1, 3, 4}
    return tuple(None if z is None else torch.from_numpy(z).to(
        getattr(torch, dtype) if i in low else torch.float32)
        for i, z in enumerate(arrays))


def _f32(z):
    return z.float().numpy() if torch.is_tensor(z) else np.asarray(z, np.float32)


def _close(got, want, dtype):
    ytol, htol = TOL[dtype]
    np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), atol=ytol)
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), atol=htol)


@pytest.mark.parametrize("s", [1, 2, 4, 8, 16])
def test_transposed_reduction_sums_each_step_over_lanes(s):
    """Integer-valued partials: every lane ends with the exact sum of its
    step over the group's lanes."""
    p = torch.from_numpy(np.random.default_rng(s).integers(
        -50, 50, (3, s, s)).astype(np.float32))
    torch.testing.assert_close(transposed_reduce(p), p.sum(dim=-2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,want", [(1, 1), (3, 1), (4, 1), (5, 2), (8, 2),
                                    (9, 4), (16, 4), (17, 8), (33, 16),
                                    (64, 16)])
def test_lane_split_covers_every_state_once(n, want):
    s = lanes(n)
    assert s == want and s * G >= n > (s // 2) * G
    assert channels(s) * s in (32, 64, 128, 256) and TILE % s == 0


@pytest.mark.parametrize("b,t,dm,n,with_h0,dtype", SSM_CASES)
def test_emulated_kernel_matches_pallas_interpret(b, t, dm, n, with_h0, dtype):
    arrays = _inputs(b, t, dm, n, with_h0)
    js = tuple(None if z is None else jnp.asarray(
        z, getattr(jnp, dtype) if i in {0, 1, 3, 4} else jnp.float32)
        for i, z in enumerate(arrays))
    want = jax_scan(*js, block_d=64, block_t=32, interpret=True)
    got = emulate_kernel(*_torch(arrays, dtype))
    assert got[0].dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("b,t,dm,n,with_h0,dtype", SSM_CASES + EDGE_CASES)
def test_emulated_kernel_matches_plain_scan(b, t, dm, n, with_h0, dtype):
    ts = _torch(_inputs(b, t, dm, n, with_h0, seed=1), dtype)
    _close(emulate_kernel(*ts), ss.ssm_scan_ref(*ts), dtype)


def test_emulated_kernel_underflowing_decay():
    """Large |a| * dt: exp(dt * a) underflows to 0 and the state is its
    last input."""
    ts = _torch(_inputs(2, 40, 128, 16, True, seed=2, a_scale=1000.0),
                "float32")
    assert float((ts[1] * ts[2][None, None, :, 0]).min()) < -88
    _close(emulate_kernel(*ts), ss.ssm_scan_ref(*ts), "float32")


def test_emulated_kernel_chunked_equals_full():
    x, dt, a, bb, c, d, _ = _torch(_inputs(1, 64, 64, 16, False), "float32")
    y_full, h_full = emulate_kernel(x, dt, a, bb, c, d)
    y1, h1 = emulate_kernel(x[:, :32], dt[:, :32], a, bb[:, :32], c[:, :32], d)
    y2, h2 = emulate_kernel(x[:, 32:], dt[:, 32:], a, bb[:, 32:], c[:, 32:],
                            d, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-4)
