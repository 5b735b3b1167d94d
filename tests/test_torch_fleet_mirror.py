"""The device mirror of a ``HostPool`` (``core/hlem.py`` ``_FleetMirror``)
and the pool's log of changed rows, on the CPU: the mirror's buffers are
CPU tensors there and its upload is the plain version of the card's (a
byte copy and ``mirror_scatter_ref``), so the packing, the log and the
rule for a full upload are the ones the card runs.

A seeded stream of pool operations (``test_torch_hosts_layout``'s: spot
and on-demand place and release, host remove / reactivate / update, growth
from a hint of 4 and from 64 past 1,000 hosts, market on and off) runs
against a reader that syncs every 1st, 3rd or 17th operation.  After each
sync the mirror's planes equal ``free()`` and ``spot_frac_view()`` bit for
bit, it sent exactly the rows written since the last sync (or the whole
fleet where the rule says), and the log never holds more rows than the
pool has hosts.  ``check_invariants`` holds the mirror equal to the pool
outside the log after every operation."""
import numpy as np
import pytest
import torch

from repro_torch.core import hlem
from repro_torch.kernels import hlem_score as hk
from test_torch_hosts_layout import _Twin

CPU = torch.device("cpu")


class _Reader:
    """A mirror on the CPU and, beside it, the rows the pool wrote since its
    last sync, recorded by a wrapper of ``_refresh_row`` (the log's only
    writer)."""

    def __init__(self, pool, rng):
        self.pool, self.rng = pool, rng
        self.mirror = hlem._FleetMirror(CPU)
        pool.mirror = self.mirror
        self.written = set()
        self.syncs = self.full = 0
        refresh = pool._refresh_row

        def recorded(hid, spot_changed=True):
            self.written.add(hid)
            refresh(hid, spot_changed)

        pool._refresh_row = recorded
        self.rows = None       # the pool's capacity at the last sync

    def sync(self, b=None):
        pool = self.pool
        n = pool.n
        cap = pool.total.shape[0]
        masks = self.rng.random(n if b is None else (b, n)) < 0.5
        alphas = None if b is None else self.rng.uniform(-1, 1, b)
        k = len(self.written)
        m = self.mirror
        before = m.cap
        free_d, mask_d, spot_d, alpha_d = m.stage(pool, masks, alphas)
        # the first sync, growth, new buffers (a larger shape) or more
        # written rows than the share: the whole fleet
        expect_full = (self.rows != cap or m.cap != before
                       or k > hlem.MIRROR_FULL_SHARE * n)
        assert m.full == expect_full
        assert m.rows_sent == (0 if expect_full else k)
        if not expect_full and k:
            # the ids sent are the written rows
            key = (cap, n, 4, masks.shape, alphas is not None)
            o_ids = m.views[key][1] + 16 * k * 4
            sent = m.dev[o_ids:o_ids + 4 * k].view(torch.int32).tolist()
            assert sorted(sent) == sorted(self.written)
        assert np.array_equal(free_d.numpy(), pool.free())
        assert np.array_equal(spot_d.numpy(), pool.spot_frac_view())
        assert np.array_equal(mask_d.numpy(), masks)
        if b is not None:
            assert np.array_equal(alpha_d.numpy(), alphas)
        held = m.held(n)
        assert np.array_equal(held[0], pool.free())
        assert np.array_equal(held[1], pool.spot_frac_view())
        self.written.clear()
        self.rows = cap
        self.syncs += 1
        self.full += expect_full


def _check(twin):
    pool = twin.port
    assert len(pool._changed_rows) <= pool.n
    pool.check_invariants(twin.now)


@pytest.mark.parametrize("period", [1, 3, 17])
@pytest.mark.parametrize("market", [False, True], ids=["no-market", "market"])
@pytest.mark.parametrize("seed", range(2))
def test_mirror_follows_the_pool_from_a_hint_of_4(seed, market, period):
    twin = _Twin(200 + seed, market, hint=4)
    twin.add_hosts(6)
    if market:
        twin.enable_market()
        twin.set_prices()
    reader = _Reader(twin.port, np.random.default_rng(seed))
    reader.sync()
    for i in range(1, 201):
        twin.step()
        _check(twin)
        if i % period == 0:
            reader.sync(None if i % 2 else int(twin.rng.integers(1, 5)))
            _check(twin)
    assert twin.port.total.shape[0] > 4
    # the pool holds 20-40 hosts, so a sync with more than 2 rows written
    # (MIRROR_FULL_SHARE) sends the whole fleet: every 17th operation does
    assert reader.full > 0
    if period == 1:
        assert reader.full < reader.syncs


@pytest.mark.parametrize("period", [1, 3, 17])
@pytest.mark.parametrize("market", [False, True], ids=["no-market", "market"])
def test_mirror_follows_the_pool_past_1000_hosts(market, period):
    twin = _Twin(300 + period, market, hint=None)
    twin.add_hosts(10)
    if market:
        twin.enable_market()
        twin.set_prices()
    reader = _Reader(twin.port, np.random.default_rng(period))
    reader.sync()
    i = 0
    while twin.port.n < 1_000:
        twin.add_hosts(int(twin.rng.integers(60, 240)))
        for _ in range(3):
            twin.step()
            i += 1
            if i % period == 0:
                reader.sync()
    for _ in range(40):
        twin.place()
    for _ in range(34):
        twin.step()
        i += 1
        if i % period == 0:
            reader.sync(None if i % 2 else 64)
    _check(twin)
    reader.sync()
    assert twin.port.n >= 1_000
    assert reader.syncs - reader.full >= 2


def test_log_stays_bounded_without_a_reader():
    """A pool never scored on a card: each row enters the log once."""
    twin = _Twin(7, True, hint=4)
    twin.add_hosts(8)
    twin.enable_market()
    for _ in range(400):
        twin.step()
        _check(twin)
    pool = twin.port
    assert 0 < len(pool._changed_rows) <= pool.n
    assert pool.take_changed() is None        # never read: all stale
    assert pool.take_changed() == []
    assert not pool._changed.any()


def test_growth_marks_every_row_stale():
    twin = _Twin(4, False, hint=4)
    twin.add_hosts(4)
    pool = twin.port
    assert pool.take_changed() is None        # a new pool: all stale
    pool.update_host(2, pool.total[2] * 2.0)
    pool.update_host(0, pool.total[0] * 2.0)
    pool.update_host(2, pool.total[2] / 2.0)
    assert pool.take_changed() == [2, 0]      # first-write order, once
    twin.add_hosts(1)                         # a fifth host: it grows
    assert pool.total.shape[0] > 4
    assert pool.take_changed() is None
    twin.add_hosts(1)
    assert pool.take_changed() == [5]


def test_full_upload_rule():
    """First call, growth, and more changed rows than the share send the
    whole fleet; a share or fewer, and none, send the rows."""
    twin = _Twin(9, False, hint=64)
    twin.add_hosts(40)
    pool = twin.port
    reader = _Reader(pool, np.random.default_rng(0))
    reader.sync()
    assert reader.mirror.full
    reader.sync()
    assert not reader.mirror.full and reader.mirror.rows_sent == 0
    limit = int(hlem.MIRROR_FULL_SHARE * pool.n)
    assert limit >= 2
    for hid in range(limit):
        pool.update_host(hid, pool.total[hid] * 1.5)
    reader.sync()
    assert not reader.mirror.full and reader.mirror.rows_sent == limit
    for hid in range(limit + 1):
        pool.update_host(hid, pool.total[hid] / 1.5)
    reader.sync()
    assert reader.mirror.full
    twin.add_hosts(30)                        # grows 64 -> 128
    reader.sync()
    assert reader.mirror.full
    twin.add_hosts(1)                         # within the capacity
    reader.sync()
    assert not reader.mirror.full and reader.mirror.rows_sent == 1


def test_stager_follows_the_fleet_size_and_the_pool():
    """The pool, not its size, picks the instance: a pool's own mirror from
    one host up (made once, kept as the pool grows), the device's pool-less
    instance of the same class for a call without a pool."""
    twin = _Twin(5, False, hint=4)
    twin.add_hosts(1)
    pool = twin.port
    try:
        mirror = hlem._stager(CPU, pool)
        assert isinstance(mirror, hlem._FleetMirror)
        assert pool.mirror is mirror
        twin.add_hosts(40)
        assert hlem._stager(CPU, pool) is mirror
        st = hlem._stager(CPU, None)
        assert type(st) is hlem._FleetMirror and st is not mirror
        assert hlem._POOLLESS[CPU] is st
        assert hlem._stager(CPU, None) is st
    finally:
        hlem._POOLLESS.pop(CPU, None)


@pytest.mark.parametrize("n", [1, 3, 170])
def test_a_pool_stages_through_its_mirror_at_any_size(n):
    """A pool of any size syncs through its mirror: at a few hosts any
    written row is past the share, so those calls send the fleet."""
    twin = _Twin(11 + n, False, hint=4)
    twin.add_hosts(n)
    reader = _Reader(twin.port, np.random.default_rng(n))
    reader.sync()
    for _ in range(8):
        twin.step()
        _check(twin)
        reader.sync()
        _check(twin)
    assert reader.syncs == 9 and twin.port.mirror is reader.mirror


def test_a_failed_call_leaves_a_full_upload():
    """A call that raises after it read the log holds nothing: the next
    call sends the whole fleet, so no written row is lost."""
    twin = _Twin(13, False, hint=64)
    twin.add_hosts(20)
    pool = twin.port
    reader = _Reader(pool, np.random.default_rng(1))
    reader.sync()
    pool.update_host(3, pool.total[3] * 2.0)
    m = reader.mirror

    def broken(*a, **k):
        raise RuntimeError("upload failed")

    m._upload = broken
    with pytest.raises(RuntimeError):
        m.stage(pool, np.ones(pool.n, bool), None)
    assert pool.take_changed() == []          # the log was read
    assert m.held(pool.n) is None
    pool.check_invariants(twin.now)
    del m._upload
    reader.rows = None                        # a full upload is expected
    reader.sync()
    assert m.full


@pytest.mark.parametrize("b", [None, 1, 5])
def test_workspace_reuses_its_views(b):
    """The pool-less path on the CPU: the arrays as given, the whole fleet
    each call, and the same tensor views at the next call of the same
    shape."""
    rng = np.random.default_rng(3)
    st = hlem._FleetMirror(CPU)
    outs = []
    for _ in range(2):
        free = rng.uniform(0, 10, (37, 4))
        spot = rng.uniform(0, 1, (37, 4))
        masks = rng.random(37 if b is None else (b, 37)) < 0.5
        alphas = None if b is None else rng.uniform(-1, 1, b)
        out = st.stage(None, masks, alphas, free, spot)
        assert np.array_equal(out[0].numpy(), free)
        assert np.array_equal(out[1].numpy(), masks)
        assert np.array_equal(out[2].numpy(), spot)
        if b is not None:
            assert np.array_equal(out[3].numpy(), alphas)
        assert st.full and st.rows_sent == 0
        assert st.nbytes >= 37 * 4 * 8 * 2 + masks.size
        outs.append(out)
    assert all(x is y for x, y in zip(*outs))


def test_scatter_ref_copies_rows():
    planes = torch.zeros(2, 6, 3, dtype=torch.float64)
    src = torch.arange(12, dtype=torch.float64).view(2, 2, 3)
    hk.mirror_scatter_ref(planes, src, torch.tensor([4, 1],
                                                    dtype=torch.int32))
    assert torch.equal(planes[0, 4], src[0, 0])
    assert torch.equal(planes[1, 1], src[1, 1])
    assert planes[:, [0, 2, 3, 5]].abs().sum() == 0
