"""The port's plain selective scan (the CPU path of ``ops.selective_scan``
and what the CUDA scan kernel is held against) against the reference
package's Pallas scan in interpret mode and its ``ssm_scan_ref`` oracle, on
the reference kernel tests' cases at their tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssm_scan import ssm_scan as jax_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ss

SSM_CASES = [
    (2, 64, 128, 16, False, "float32"),
    (1, 100, 96, 16, True, "float32"),
    (1, 1, 64, 16, True, "float32"),      # decode single step
    (2, 64, 128, 16, False, "bfloat16"),
]


def _inputs(b, t, dm, n, with_h0, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    x = f(b, t, dm)
    dt = rng.uniform(0.001, 0.1, (b, t, dm)).astype(np.float32)
    a = -rng.uniform(0.1, 1, (dm, n)).astype(np.float32)
    bb, c, d = f(b, t, n), f(b, t, n), f(dm)
    h0 = f(b, dm, n) if with_h0 else None
    return x, dt, a, bb, c, d, h0


def _both(arrays, dtype):
    """(jax, torch) argument tuples: x, dt, b, c in ``dtype``; a, d, h0 f32."""
    low = {0, 1, 3, 4}
    js = tuple(None if a is None else jnp.asarray(
        a, getattr(jnp, dtype) if i in low else jnp.float32)
        for i, a in enumerate(arrays))
    ts = tuple(None if a is None else torch.from_numpy(a).to(
        getattr(torch, dtype) if i in low else torch.float32)
        for i, a in enumerate(arrays))
    return js, ts


def _close(got, want, dtype):
    ytol = 5e-2 if dtype == "bfloat16" else 1e-4
    htol = 5e-3 if dtype == "bfloat16" else 1e-3
    y, h = got
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want[0], np.float32),
                               atol=ytol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want[1]), atol=htol)


@pytest.mark.parametrize("b,t,dm,n,with_h0,dtype", SSM_CASES)
def test_plain_scan_matches_pallas_interpret(b, t, dm, n, with_h0, dtype):
    js, ts = _both(_inputs(b, t, dm, n, with_h0), dtype)
    want = jax_scan(*js, block_d=64, block_t=32, interpret=True)
    got = ops.selective_scan(*ts)
    assert got[0].dtype == ts[0].dtype and got[1].dtype == torch.float32
    assert got[0].shape == (b, t, dm) and got[1].shape == (b, dm, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("b,t,dm,n,with_h0,dtype", SSM_CASES)
def test_plain_scan_matches_reference_oracle(b, t, dm, n, with_h0, dtype):
    js, ts = _both(_inputs(b, t, dm, n, with_h0, seed=1), dtype)
    _close(ss.ssm_scan_ref(*ts), ref.ssm_scan_ref(*js), dtype)


def test_plain_scan_chunked_equals_full():
    """Two chunks with the state carried between them == one full scan."""
    x, dt, a, bb, c, d, _ = (None if z is None else torch.from_numpy(z)
                             for z in _inputs(1, 64, 64, 16, False))
    y_full, h_full = ss.ssm_scan_ref(x, dt, a, bb, c, d)
    y1, h1 = ss.ssm_scan_ref(x[:, :32], dt[:, :32], a, bb[:, :32], c[:, :32], d)
    y2, h2 = ss.ssm_scan_ref(x[:, 32:], dt[:, 32:], a, bb[:, 32:], c[:, 32:],
                             d, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    ts = tuple(None if z is None else torch.from_numpy(z)
               for z in _inputs(1, 4, 8, 4, False))
    before = ss.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssm_scan(*ts)
    assert ss.LAUNCHES == before
