"""The HLEM scoring CUDA kernel on a card, held against its plain PyTorch
version on the same device: tolerance, argmax, bit-equal reruns, and each
batch row bit-equal to the single-VM launch.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_hlem_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import hlem_score as hk
from repro_torch.kernels import ops

RTOL, ATOL = 1e-4, 1e-5   # float32 on both sides, different summation order


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1), (1, 513), (1, 12583), (8, 257),
                                 (64, 12583)])
def test_cuda_kernel_matches_plain_and_is_deterministic(b, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    free = rng.uniform(0, 100, (n, 4)).astype(np.float32)
    free[:, 3] = 42.0   # degenerate column
    masks = rng.random((b, n)) < 0.7
    if b > 1:
        masks[0] = False  # fully-masked row
    spot = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    alphas = np.linspace(-0.5, 0.5, b).astype(np.float32)
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
