"""The HLEM scoring CUDA kernel (float64) on a card, held against its plain
PyTorch version on the same device: tolerance, argmax, bit-equal reruns,
and each batch row bit-equal to the single-VM launch.  Skips without a CUDA
device.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_hlem_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hlem_score as hk
from repro_torch.kernels import ops

# float64 on both sides, different summation order.  A degenerate column's
# variation factor g = 1 - e is 0 in exact arithmetic; the order of the n
# terms of e leaves ~n * 1e-16 in it, which moves every weight, and so every
# score, by up to ~2e-11 relative at n = 12,583 (the plain version against
# the numpy oracle shows the same)
RTOL, ATOL = 1e-10, 1e-10


# the cluster rule (``hlem_score.cu``: C = 1, 2, 4, 8, 16 up to n = 1024,
# 2048, 4096, 8192, above) changes C at these n
BOUNDARIES = [1025, 2049, 4097, 8193]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1), (1, 513), (1, 12583), (8, 257),
                                 (64, 12583), (2, 60000)]
                         + [(b, n + d) for n in BOUNDARIES for d in (-1, 0, 1)
                            for b in (1, 3)])
def test_cuda_kernel_matches_plain_and_is_deterministic(b, n, d=4):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    free = rng.uniform(0, 100, (n, d))
    free[:, d - 1] = 42.0   # degenerate column
    masks = rng.random((b, n)) < 0.7
    if b > 1:
        masks[0] = False  # fully-masked row
    spot = rng.uniform(0, 1, (n, d))
    alphas = np.linspace(-0.5, 0.5, b)
    dev = torch.device("cuda")
    f, m, s, a = (torch.from_numpy(x).to(dev)
                  for x in (free, masks, spot, alphas))
    hk.LAUNCHES = 0
    out = ops.hlem_score_batch(f, m, s, a)
    again = ops.hlem_score_batch(f, m, s, a)
    assert hk.LAUNCHES == 2
    assert torch.equal(out, again)
    want = hk.hlem_score_batch_ref(f, m, s, a).cpu().numpy()
    got = out.cpu().numpy()
    for i in range(b):
        mk = masks[i]
        if mk.any():
            np.testing.assert_allclose(got[i][mk], want[i][mk], rtol=RTOL,
                                       atol=ATOL)
            assert int(np.argmax(got[i])) == int(np.argmax(want[i]))
        assert bool((got[i][~mk] <= -1e37).all())
        assert torch.equal(ops.hlem_score(f, m[i], s, float(alphas[i])), out[i])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("b,n", [(2, 5000), (1, 60000)])
def test_cuda_kernel_other_widths(b, n, d):
    """Widths other than the simulator's D = 4 (8-byte copies; slices that
    stay in shared memory and one that does not)."""
    test_cuda_kernel_matches_plain_and_is_deterministic(b, n, d)


@pytest.mark.cuda
def test_cluster_size_follows_the_rule():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n in (1, 60, 1024, 1025, 2048, 2049, 4096, 4097, 8192, 8193, 12583,
              100_000):
        want = 1
        while want < 16 and want * 1024 < n:
            want *= 2
        assert hk.cluster_size(n) == want, n
    assert hk.cluster_size(12583) == 16
