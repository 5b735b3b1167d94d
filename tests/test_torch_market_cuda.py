"""The market package's device paths on a card: the float64 price paths and
price fan on CUDA against the numpy step loop (``rtol=1e-12, atol=0``, the
tolerance the reference holds its own scan to), and one volatile
``hlem-vmp-adjusted`` market run through the HLEM kernel, whose row and
event streams must equal the numpy backend's.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_market_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.api as ta
import repro_torch.market as tm
from repro_torch.api.build import event_streams
from repro_torch.kernels import hlem_score as hk

RTOL = 1e-12
UNTIL = 2400.0


def _run(backend):
    """The volatile ``hlem-vmp-adjusted`` run of the launcher's ``--market``
    grid on ``backend`` (torch: the HLEM kernel on the card): its row and
    event streams."""
    spec = ta.RunSpec(
        scenario=ta.ScenarioSpec(
            workload="market", regime="volatile", n_pools=4,
            tick_interval=60.0, from_advisor=True,
            bid=ta.BidSpec("randomized", {"lo": 0.45})),
        policy=ta.PolicySpec("hlem-vmp-adjusted",
                             {"alpha": -0.5, "backend": backend}))
    sim = ta.build(spec, 0)
    metrics = sim.run(until=UNTIL)
    return ta.collect_row(sim, metrics, spec, 0), event_streams(metrics)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("family,kwargs", [
    ("AUCTION_FAMILY", dict(shock_sigma=0.4, shock_rho=0.6, seed=3)),
    ("AUCTION_FAMILY", dict(shock_sigma=0.3, seed=5)),
    ("SMOOTHED_FAMILY", dict(alpha=0.15, max_step=0.04)),
])
@pytest.mark.parametrize("shape", [(50, 4), (240, 512, 4)])
def test_price_paths_cuda_equal_numpy(cuda, family, kwargs, shape):
    fam = getattr(tm, family)
    rng = np.random.default_rng(2)
    n = shape[-1]
    utils = rng.uniform(0.0, 1.0, (shape[0], n))
    shocks = rng.standard_normal(shape)
    p_np, s_np = tm.simulate_price_paths(fam, fam.init([kwargs] * n), utils,
                                         shocks)
    p_t, s_t = tm.simulate_price_paths(fam, fam.init([kwargs] * n), utils,
                                       shocks, backend="torch")
    if p_np.shape != p_t.shape:   # the smoothed family draws no shocks
        p_np = np.broadcast_to(p_np[:, None], p_t.shape)
    np.testing.assert_allclose(p_t, p_np, rtol=RTOL, atol=0)
    for k in s_np:
        np.testing.assert_allclose(s_t[k], np.broadcast_to(s_np[k],
                                                           s_t[k].shape),
                                   rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_price_fan_and_regime_comparison_cuda(cuda):
    eng = tm.MarketEngine(tm.make_market("volatile", n_pools=4, seed=0,
                                         from_advisor=True))

    class _Pool:   # a fixed utilization signal, ticked for a price history
        def pool_cpu_utilization(self):
            return np.array([0.3, 0.5, 0.7, 0.9])

    for k in range(30):
        eng.tick(_Pool(), 60.0 * k)
    for n_paths in (1, 64, 4096):
        want = tm.simulated_price_fan(eng, n_ticks=240, n_paths=n_paths)
        got = tm.simulated_price_fan(eng, n_ticks=240, n_paths=n_paths,
                                     backend="torch")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    claims = tm.regime_comparison(n=600, seed=0)
    scan = tm.regime_comparison(n=600, seed=0, use_scan=True)
    for k in claims:
        assert scan[k] == pytest.approx(claims[k], rel=1e-9)


@pytest.mark.cuda
def test_market_row_through_the_kernel_equals_numpy(cuda):
    hk.LAUNCHES = 0
    got = _run("torch")
    assert hk.LAUNCHES > 0 and got[0]["allocations"] > 0
    want = _run("numpy")
    assert got[0] == want[0]
    assert got[1] == want[1]
