"""The port's plain attention (the CPU path of ``ops.attention`` and what
the CUDA flash kernel is held against) against the reference package's
Pallas flash attention in interpret mode and its ``mha_ref`` oracle, on the
reference kernel tests' cases at their tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

CASES = [
    # b, h, hkv, tq, tk, dh, window, dtype
    (2, 4, 4, 128, 128, 64, None, "float32"),
    (1, 8, 2, 96, 96, 64, None, "float32"),       # GQA, ragged
    (1, 4, 2, 1, 200, 64, None, "float32"),       # decode tq=1
    (2, 4, 4, 128, 128, 64, 32, "float32"),       # sliding window
    (1, 2, 1, 64, 64, 128, None, "bfloat16"),
    (1, 5, 1, 70, 70, 16, 16, "float32"),         # odd heads (hymba-like)
]


def _inputs(b, h, hkv, tq, tk, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, tq, dh)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, tk, dh)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, tk, dh)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jax arrays and torch tensors of ``dtype``."""
    js = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return js, ts


@pytest.mark.parametrize("b,h,hkv,tq,tk,dh,window,dtype", CASES)
def test_plain_attention_matches_pallas_interpret(b, h, hkv, tq, tk, dh,
                                                  window, dtype):
    (q, k, v), (tq_, tk_, tv_) = _both(_inputs(b, h, hkv, tq, tk, dh), dtype)
    want = jax_flash(q, k, v, window=window, block_q=64, block_k=64,
                     interpret=True)
    got = ops.attention(tq_, tk_, tv_, causal=True, window=window)
    assert got.dtype == tq_.dtype and got.shape == (b, h, tq, dh)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("b,h,hkv,tq,tk,dh,window,dtype", CASES)
def test_plain_attention_matches_reference_oracle(b, h, hkv, tq, tk, dh,
                                                  window, dtype):
    (q, k, v), (tq_, tk_, tv_) = _both(_inputs(b, h, hkv, tq, tk, dh, 1), dtype)
    want = ref.mha_ref(q, k, v, window=window)
    got = fa.mha_ref(tq_, tk_, tv_, window=window)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


def test_plain_attention_noncausal():
    (q, k, v), (tq_, tk_, tv_) = _both(_inputs(1, 2, 2, 50, 50, 32), "float32")
    want = jax_flash(q, k, v, causal=False, block_q=32, block_k=32,
                     interpret=True)
    got = ops.attention(tq_, tk_, tv_, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_attention_matches_chunked_reference():
    """The reference model's default path (kv-chunked online softmax) is the
    same function: the port's dense plain version agrees with it."""
    (q, k, v), (tq_, tk_, tv_) = _both(_inputs(1, 4, 2, 257, 257, 64),
                                       "float32")
    want = ref.mha_chunked_ref(q, k, v, window=100, chunk=64)
    got = fa.mha_ref(tq_, tk_, tv_, window=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 16))
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    assert fa.LAUNCHES == before
