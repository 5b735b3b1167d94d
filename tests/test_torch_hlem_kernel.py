"""The port's HLEM scoring kernel module (``repro_torch.kernels.hlem_score``)
held against the JAX package's Pallas kernel (interpret mode), its jnp
reference and the numpy batch oracle, on the same seeded inputs.

On the CPU the port runs the kernel's plain PyTorch version; the CUDA kernel
itself is checked on a card by ``test_torch_hlem_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hlem import hlem_scores_batch_np
from repro.kernels import ref
from repro.kernels.hlem_score import hlem_score_pallas, hlem_score_pallas_batch
from repro_torch.core.allocation import HlemVmp, HlemVmpAdjusted
from repro_torch.kernels import hlem_score as hk
from repro_torch.kernels import ops

RTOL, ATOL = 1e-4, 1e-5   # float32 on both sides, different summation order


def _rng():
    return np.random.default_rng(0)


def _single_inputs(n):
    rng = _rng()
    free = rng.uniform(0, 100, (n, 4)).astype(np.float32)
    mask = rng.random(n) < 0.7
    spot = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    return free, mask, spot


def _batch_inputs(b, n):
    rng = _rng()
    free = rng.uniform(0, 100, (n, 4)).astype(np.float32)
    free[:, 3] = 42.0  # degenerate column across every candidate set
    masks = rng.random((b, n)) < 0.7
    if b > 1:
        masks[0] = False  # fully-masked row -> all -big
    spot = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    alphas = np.linspace(-0.5, 0.5, b).astype(np.float32)
    return free, masks, spot, alphas


def _assert_scores(out, want, mask):
    if mask.any():
        np.testing.assert_allclose(out[mask], want[mask], rtol=RTOL, atol=ATOL)
        assert int(np.argmax(out)) == int(np.argmax(want))
    assert bool((out[~mask] <= -1e37).all())


@pytest.mark.parametrize("n", [1, 3, 100, 512, 513, 2000])
@pytest.mark.parametrize("alpha", [0.0, -0.5])
def test_plain_matches_pallas_and_jnp_ref(n, alpha):
    free, mask, spot = _single_inputs(n)
    out = ops.hlem_score(torch.from_numpy(free), torch.from_numpy(mask),
                         torch.from_numpy(spot), alpha).numpy()
    args = (jnp.asarray(free), jnp.asarray(mask), jnp.asarray(spot),
            jnp.float32(alpha))
    _assert_scores(out, np.asarray(hlem_score_pallas(*args, interpret=True)),
                   mask)
    _assert_scores(out, np.asarray(ref.hlem_score_ref(*args)), mask)


def test_plain_all_masked():
    n = 64
    out = ops.hlem_score(torch.zeros((n, 4)), torch.zeros(n, dtype=torch.bool),
                         torch.zeros((n, 4)), 0.0)
    want = np.asarray(hlem_score_pallas(
        jnp.zeros((n, 4), jnp.float32), jnp.zeros((n,), bool),
        jnp.zeros((n, 4), jnp.float32), jnp.float32(0.0), interpret=True))
    assert bool((out <= -1e37).all()) and bool((want <= -1e37).all())


@pytest.mark.parametrize("b,n", [(1, 100), (4, 100), (3, 513), (8, 257)])
def test_batch_plain_matches_pallas_batch_and_np(b, n):
    free, masks, spot, alphas = _batch_inputs(b, n)
    out = ops.hlem_score_batch(torch.from_numpy(free), torch.from_numpy(masks),
                               torch.from_numpy(spot),
                               torch.from_numpy(alphas)).numpy()
    assert out.shape == (b, n)
    pallas = np.asarray(hlem_score_pallas_batch(
        jnp.asarray(free), jnp.asarray(masks), jnp.asarray(spot),
        jnp.asarray(alphas), interpret=True))
    oracle = hlem_scores_batch_np(free, masks, spot, alphas)
    for i in range(b):
        _assert_scores(out[i], pallas[i], masks[i])
        _assert_scores(out[i], oracle[i], masks[i])


def test_batch_rows_equal_single_plain():
    free, masks, spot, alphas = _batch_inputs(5, 200)
    t = torch.from_numpy
    batch = ops.hlem_score_batch(t(free), t(masks), t(spot), t(alphas))
    for i in range(5):
        single = ops.hlem_score(t(free), t(masks[i]), t(spot), float(alphas[i]))
        np.testing.assert_allclose(batch[i].numpy(), single.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_ops_on_cpu_tensors_never_launch():
    hk.LAUNCHES = 0
    free, masks, spot, alphas = _batch_inputs(3, 100)
    t = torch.from_numpy
    ops.hlem_score(t(free), t(masks[1]), t(spot), -0.5)
    ops.hlem_score_batch(t(free), t(masks), t(spot), t(alphas))
    assert hk.LAUNCHES == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    free, masks, spot, alphas = _batch_inputs(2, 10)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        hk.hlem_score(t(free), t(masks[1]), t(spot), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        hk.hlem_score_batch(t(free), t(masks), t(spot), t(alphas))
    assert hk.LAUNCHES == 0


@pytest.mark.parametrize("cls", [HlemVmp, HlemVmpAdjusted])
def test_torch_backend_default_device_needs_cuda(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls()
    assert cls(device="cpu").device == torch.device("cpu")
