"""The flash-attention and selective-scan CUDA kernels on a card, held
against their plain PyTorch versions on the same device (tolerances of the
reference's kernel tests, bit-equal reruns), and the model's prefill path
through both kernels.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_model_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ss

ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SCAN_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 5e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,tq,tk,dh,window,dtype,causal", [
    (2, 4, 4, 128, 128, 64, None, torch.float32, True),
    (1, 8, 2, 96, 96, 64, None, torch.float32, True),
    (1, 4, 2, 1, 200, 64, None, torch.float32, True),
    (2, 4, 4, 128, 128, 64, 32, torch.float32, True),
    (1, 2, 1, 64, 64, 128, None, torch.bfloat16, True),
    (1, 5, 1, 70, 70, 16, 16, torch.float32, True),
    (1, 2, 2, 50, 50, 32, None, torch.float32, False),
    (2, 25, 5, 300, 300, 64, 128, torch.bfloat16, True),
    # the tensor-core (bf16) kernel at every head dim, ragged tiles, Tq < Tk,
    # no mask, and a window narrower than a key tile
    (1, 4, 2, 200, 200, 16, None, torch.bfloat16, True),
    (1, 4, 2, 200, 200, 32, 64, torch.bfloat16, True),
    (1, 4, 1, 300, 300, 128, 100, torch.bfloat16, True),
    (1, 5, 1, 2047, 2047, 64, 1024, torch.bfloat16, True),
    (1, 5, 1, 2049, 2049, 64, 1024, torch.bfloat16, True),
    (1, 5, 1, 300, 1000, 64, 1024, torch.bfloat16, True),
    (1, 4, 2, 1, 200, 64, None, torch.bfloat16, True),
    (1, 2, 2, 50, 50, 32, None, torch.bfloat16, False),
    (1, 4, 4, 200, 260, 128, None, torch.bfloat16, False),
    (1, 5, 1, 70, 70, 16, 16, torch.bfloat16, True),
    (1, 4, 2, 300, 300, 64, 16, torch.bfloat16, True),
])
def test_flash_attention_kernel_matches_plain(cuda, b, h, hkv, tq, tk, dh,
                                              window, dtype, causal):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(
        cuda, dtype) for s in ((b, h, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh)))
    fa.LAUNCHES = 0
    out = ops.attention(q, k, v, causal=causal, window=window)
    again = ops.attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == 2
    assert torch.equal(out, again)
    want = fa.mha_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=ATT_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,dm,n,with_h0,dtype", [
    (2, 64, 128, 16, False, torch.float32),
    (1, 100, 96, 16, True, torch.float32),
    (1, 1, 64, 16, True, torch.float32),
    (2, 64, 128, 16, False, torch.bfloat16),
    (2, 40, 100, 8, True, torch.float32),
    (1, 33, 70, 64, True, torch.float32),
    # the lane layout: N not a multiple of the 4-state lane group, T below,
    # at and above the 32-step tile, Dm off the 32-channel block with and
    # without 16-byte rows, and the decode shape
    (2, 40, 128, 1, True, torch.float32),
    (2, 40, 128, 3, True, torch.bfloat16),
    (1, 50, 96, 33, True, torch.float32),
    (2, 31, 128, 16, True, torch.bfloat16),
    (2, 32, 128, 16, True, torch.bfloat16),
    (2, 33, 128, 16, True, torch.bfloat16),
    (2, 64, 200, 16, False, torch.bfloat16),
    (1, 40, 100, 16, True, torch.bfloat16),
    (8, 1, 3200, 16, True, torch.bfloat16),
])
def test_ssm_scan_kernel_matches_plain(cuda, b, t, dm, n, with_h0, dtype):
    _check_scan_kernel(cuda, b, t, dm, n, with_h0, dtype)


@pytest.mark.cuda
def test_ssm_scan_kernel_underflowing_decay(cuda):
    """Large |a| * dt: exp(dt * a) underflows to 0 in the kernel."""
    _check_scan_kernel(cuda, 2, 40, 128, 16, True, torch.float32, a_scale=1000.0)


@pytest.mark.cuda
def test_ssm_scan_kernel_chunked_equals_full(cuda):
    """Two kernel calls with the state carried between them == one."""
    x, dt, a, bb, c, d, _ = _scan_inputs(cuda, 1, 64, 64, 16, False,
                                         torch.float32)
    y_full, h_full = ops.selective_scan(x, dt, a, bb, c, d)
    y1, h1 = ops.selective_scan(x[:, :32], dt[:, :32], a, bb[:, :32],
                                c[:, :32], d)
    y2, h2 = ops.selective_scan(x[:, 32:], dt[:, 32:], a, bb[:, 32:],
                                c[:, 32:], d, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0, atol=1e-4)
    torch.testing.assert_close(h2, h_full, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_unaligned_inputs(cuda, dtype):
    """Contiguous inputs that start off a 16-byte boundary take the kernel's
    plain-load staging and give the same bits as aligned copies."""
    args = _scan_inputs(cuda, 2, 40, 128, 16, True, dtype)

    def shifted(z):   # the same values, one element past an aligned start
        if z is None:
            return None
        buf = torch.empty(z.numel() + 1, dtype=z.dtype, device=z.device)
        out = buf[1:].view(z.shape)
        out.copy_(z)
        return out

    moved = tuple(shifted(z) for z in args)
    assert all(z is None or z.data_ptr() % 16 for z in moved)
    y, h = ops.selective_scan(*args)
    y2, h2 = ops.selective_scan(*moved)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def _scan_inputs(cuda, b, t, dm, n, with_h0, dtype, a_scale=1.0):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
    x = f(b, t, dm).to(cuda, dtype)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, t, dm)).astype(
        np.float32)).to(cuda, dtype)
    a = torch.from_numpy((-rng.uniform(0.1, 1, (dm, n)) * a_scale).astype(
        np.float32)).to(cuda)
    bb, c = f(b, t, n).to(cuda, dtype), f(b, t, n).to(cuda, dtype)
    d = f(dm).to(cuda)
    h0 = f(b, dm, n).to(cuda) if with_h0 else None
    return x, dt, a, bb, c, d, h0


def _check_scan_kernel(cuda, b, t, dm, n, with_h0, dtype, a_scale=1.0):
    x, dt, a, bb, c, d, h0 = _scan_inputs(cuda, b, t, dm, n, with_h0, dtype,
                                          a_scale)
    ss.LAUNCHES = 0
    y, h = ops.selective_scan(x, dt, a, bb, c, d, h0)
    y2, h2 = ops.selective_scan(x, dt, a, bb, c, d, h0)
    assert ss.LAUNCHES == 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    yr, hr = ss.ssm_scan_ref(x, dt, a, bb, c, d, h0)
    ty, th = SCAN_TOL[dtype]
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr.float(), rtol=0, atol=ty)
    torch.testing.assert_close(h, hr, rtol=0, atol=th)


@pytest.mark.cuda
def test_hymba_smoke_prefill_through_kernels(cuda):
    """The smoke Hymba's greedy tokens on the card, through both kernels,
    equal the same weights' tokens on the CPU through the plain versions."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import greedy_generate

    cfg = get_smoke_config("hymba_1_5b")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)))
    want = greedy_generate(cfg, model, prompt, 6)
    fa.LAUNCHES = ss.LAUNCHES = 0
    got = greedy_generate(cfg, model.to(cuda), prompt.to(cuda), 6)
    assert fa.LAUNCHES == cfg.n_layers
    assert ss.LAUNCHES == cfg.n_layers * 6
    assert torch.equal(got.cpu(), want)
