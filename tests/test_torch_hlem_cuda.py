"""The HLEM scoring CUDA kernel (float64) on a card, held against its plain
PyTorch version on the same device: tolerance, argmax, bit-equal reruns,
and each batch row bit-equal to the single-VM launch.  A pool's device
mirror (``core/hlem.py`` ``_FleetMirror``) against the whole-fleet upload:
bit-equal scores over a stream of pool writes, and a trace replay that
places as the numpy backend does.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_hlem_cuda.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import hlem
from repro_torch.core.hosts import HostPool
from repro_torch.core.types import make_on_demand, make_spot
from repro_torch.kernels import hlem_score as hk
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]

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


# -- the device mirror against the whole-fleet upload --------------------------
BASE = np.array([1.0, 2048.0, 250.0, 25_000.0])


class _Fleet:
    """A pool of n hosts and a seeded stream of places and releases."""

    def __init__(self, n, hint, seed):
        self.rng = np.random.default_rng(seed)
        self.pool = HostPool(capacity_hint=hint)
        self.vms, self.next_id = [], 0
        self.add(n)

    def add(self, k):
        for _ in range(k):
            self.pool.add_host(float(self.rng.choice([16.0, 32.0, 64.0]))
                               * BASE)

    def step(self):
        rng, pool = self.rng, self.pool
        if self.vms and rng.random() < 0.4:
            pool.release(self.vms.pop(int(rng.integers(len(self.vms)))))
            return
        demand = float(rng.uniform(0.5, 8.0)) * BASE
        make = make_spot if rng.random() < 0.3 else make_on_demand
        vm = make(self.next_id, demand, 100.0)
        self.next_id += 1
        cand = np.flatnonzero(pool.direct_mask_into(demand))
        if cand.size:
            pool.place(vm, int(rng.choice(cand)))
            self.vms.append(vm)

    def masks(self, b):
        return self.rng.random((b, self.pool.n)) < 0.6


def _both_paths(fleet, mirror, b):
    """Scores of one call through the whole-fleet upload and through the
    mirror, on the same pool state."""
    pool, dev = fleet.pool, mirror.device
    masks = fleet.masks(b)
    alphas = np.linspace(-0.5, 0.5, b)
    free, spot = pool.free(), pool.spot_frac_view()
    if b == 1:
        f, m, s, _ = hlem.stage_to_device(dev, free, masks[0], spot)
        want = ops.hlem_score(f, m, s, -0.5)
        f, m, s, _ = mirror.stage(pool, masks[0], None)
        got = ops.hlem_score(f, m, s, -0.5)
    else:
        f, m, s, a = hlem.stage_to_device(dev, free, masks, spot, alphas)
        want = ops.hlem_score_batch(f, m, s, a)
        f, m, s, a = mirror.stage(pool, masks, alphas)
        got = ops.hlem_score_batch(f, m, s, a)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("n", [170, 12583])
def test_mirror_scores_equal_the_full_upload(n, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = hlem.resolve_device("cuda")
    fleet = _Fleet(n, hint=64, seed=n + b)
    mirror = fleet.pool.mirror = hlem._FleetMirror(dev)
    deltas = rows = 0
    for call in range(40):
        for _ in range(int(fleet.rng.integers(0, 4))):
            fleet.step()
        if call == 25:                      # past the capacity: _grow
            fleet.add(fleet.pool.total.shape[0] - fleet.pool.n + 1)
        got, want = _both_paths(fleet, mirror, b)
        assert torch.equal(got, want), call
        assert torch.equal(torch.argmax(got, dim=-1),
                           torch.argmax(want, dim=-1))
        deltas += not mirror.full
        rows += mirror.rows_sent
        # the scatter told the host that the copy is done: no wait next call
        assert int(mirror.bufs.done_np[0]) == mirror.bufs.ticket
        fleet.pool.check_invariants()
    assert deltas >= 30 and rows >= 20


def _trace_replay(backend, seed):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.drivers import trace_fill

    cell = harness.load_cell(
        "gtrace-fill",
        config_overrides={"n_machines": 2_000, "n_spot": 300,
                          "policy": {"params": {"backend": backend}}},
        traffic_overrides={"sim_days": 0.0015})
    sim = trace_fill.build(trace_fill.prepare(cell, seed), cell, "cuda",
                           traced=False)
    log = []
    place = sim.pool.place

    def logged(vm, hid, now=0.0):
        log.append((vm.id, int(hid), now))
        place(vm, hid, now=now)

    sim.pool.place = logged
    sim.run(until=trace_fill.horizon(cell))
    sim.pool.check_invariants()
    return log, sim


@pytest.mark.cuda
def test_trace_replay_through_the_mirror_places_as_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = 2**31 + 27
    hk.SCATTERS = 0
    got, sim = _trace_replay("torch", seed)
    assert isinstance(sim.pool.mirror, hlem._FleetMirror)
    assert hk.SCATTERS > 1_000
    assert not sim.pool.mirror.full
    want, _ = _trace_replay("numpy", seed)
    assert len(want) > 1_000
    assert got == want
