"""The port's sharding (``repro_torch.models.sharding``, the spec trees of
``models.model``, ``train.train_step`` and ``train.optimizer``) against the
reference's on the same logical names, and a sharded training step on 2
gloo ranks against the unsharded one."""
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.configs as rcfg
import repro.models.model as rmodel
import repro.models.sharding as rsharding
import repro.train.train_step as rtrain
import repro_torch.configs as tcfg
from repro.launch.specs import SHAPES as RSHAPES
from repro.launch.specs import rules_for as rrules_for
from repro_torch.configs import ARCH_IDS
from repro_torch.kernels import ops
from repro_torch.launch.mesh import fake_group, make_mesh, spawn
from repro_torch.launch.specs import SHAPES, rules_for
from repro_torch.models import sharding
from repro_torch.models.model import (Model, decode_state_specs, param_specs,
                                      shard_params)
from repro_torch.train.data import DataConfig, SyntheticDataset
from repro_torch.train.train_step import (batch_to_device, init_train_state,
                                          leaf_specs, make_train_step,
                                          train_state_specs)

MESHES = {(4, 2): ("data", "model"), (2, 4, 2): ("pod", "data", "model")}


def _norm(ax):
    """A PartitionSpec entry or a resolved axis as a tuple of axis names."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _ref_entries(p, n):
    entries = list(p) + [None] * (n - len(p))
    return [_norm(a) for a in entries[:n]]


def _axes_of(pl, mesh, ndim):
    """Per tensor dim, the mesh axes that shard it (placements -> spec)."""
    out = [()] * ndim
    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            out[p.dim] = out[p.dim] + (mesh.mesh_dim_names[j],)
    return out


@pytest.fixture(params=list(MESHES), ids=["4x2", "2x4x2"])
def meshes(request):
    """The port's fake mesh and the reference's abstract one, same shape."""
    shape, axes = request.param, MESHES[request.param]
    with fake_group(int(np.prod(shape))):
        yield make_mesh(shape, axes, device="cpu"), AbstractMesh(shape, axes)


def _rule_sets():
    out = [("default", None, None)]
    for arch in ARCH_IDS:
        for name in SHAPES:
            r = rules_for(tcfg.get_config(arch), SHAPES[name])
            assert r == rrules_for(rcfg.get_config(arch), RSHAPES[name])
            if r:
                out.append((f"{arch}-{name}", r, r))
    return out


@pytest.mark.parametrize("rules", _rule_sets(), ids=lambda r: r[0])
def test_every_logical_name_resolves_as_the_reference(meshes, rules):
    tmesh, rmesh = meshes
    assert sharding.DEFAULT_RULES == rsharding.DEFAULT_RULES
    names = list(sharding.DEFAULT_RULES) + [None]
    with sharding.use_mesh(tmesh, rules[1]), rsharding.use_mesh(rmesh, rules[2]):
        for name in names:
            want = _ref_entries(rsharding.spec(name), 1)
            assert [_norm(a) for a in sharding.resolve(name)] == want, name
            assert _axes_of(sharding.spec(name), tmesh, 1) == want, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_divisible_spec_matches_the_reference_on_production_params(arch):
    """On the (16, 16) mesh: granite's 49 155 vocab and 24 heads, hymba's
    25 heads replicate at the argument boundary, as the reference's do."""
    cfg = tcfg.get_config(arch)
    shapes = {k: tuple(p.shape) for k, p in
              Model(cfg, device="meta").named_parameters()}
    rmesh = AbstractMesh((16, 16), ("data", "model"))
    with fake_group(256):
        tmesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        with sharding.use_mesh(tmesh), rsharding.use_mesh(rmesh):
            for key, names in param_specs(cfg).items():
                shape = shapes[key]
                want = _ref_entries(
                    rsharding.divisible_spec(shape, names, rmesh), len(shape))
                got = _axes_of(sharding.divisible_spec(shape, names, tmesh),
                               tmesh, len(shape))
                assert got == want, (key, shape, names)


def _ref_flat(tree):
    """The reference's spec tree flattened to ``state_dict``-style keys."""
    out = {}

    def walk(t, prefix):
        if rsharding.is_spec_leaf(t):
            out[prefix[:-1]] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        else:
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_name_the_reference_axes(arch):
    """Per parameter, per optimizer leaf and per decode-state field; the
    port's per-layer keys map onto the reference's stacked ones."""
    rc, tc = rcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    ref = _ref_flat(rmodel.param_specs(rc))
    got = param_specs(tc)
    for key, names in got.items():
        if key.startswith("layers."):
            _, i, path = key.split(".", 2)
            want = ref[f"layers.{path}"]
            assert want[0] is None and tuple(want[1:]) == names, key
        else:
            assert ref[key] == names, key
    assert leaf_specs(tc) == ref

    rstate = rtrain.train_state_specs(rc)
    tstate = train_state_specs(tc)
    assert tstate.params == got and tstate.step == () and tstate.rng == ()
    for field in tstate.opt._fields[1:]:
        assert getattr(tstate.opt, field) == _ref_flat(getattr(rstate.opt, field))
    assert tuple(decode_state_specs(tc)) == tuple(rmodel.decode_state_specs(rc))


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "hymba_1_5b"])
def test_shard_params_places_meta_dtensors(arch):
    """Nothing allocated, every parameter a DTensor on divisible_spec."""
    cfg = tcfg.get_config(arch)
    with fake_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        model = shard_params(Model(cfg, device="meta"), mesh)
        specs = param_specs(cfg)
        with sharding.use_mesh(mesh):
            for key, p in model.named_parameters():
                assert isinstance(p, DTensor) and p.device.type == "meta"
                assert p.placements == sharding.divisible_spec(
                    tuple(p.shape), specs[key], mesh)
    lm = dict(model.named_parameters())["lm_head"]
    if arch == "granite_moe_3b_a800m":     # 49 155 vocab: not divisible by 16
        assert lm.placements == (Shard(0), Replicate())


def test_constrain_and_reshape_are_no_ops_unsharded():
    x = torch.randn(2, 6, 4)
    assert sharding.constrain(x, "batch", "seq", "heads") is x
    with fake_group(2):
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        with sharding.use_mesh(mesh):
            assert sharding.constrain(x, "batch", None, None) is x
    assert torch.equal(sharding.reshape(x, 2, 3, 8), x.reshape(2, 3, 8))


def test_constrain_tree_places_every_leaf():
    """The gradient accumulator's pin: every leaf of a tree onto its
    spec's placements (a no-op without a mesh)."""
    tree = {"w": torch.zeros(8, 4), "v": [torch.zeros(4), torch.zeros(4)]}
    specs = {"w": ("fsdp", "heads"), "v": [("ff",), ("ff",)]}
    assert sharding.constrain_tree(tree, specs) is tree
    with fake_group(8):
        mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
        with sharding.use_mesh(mesh):
            placed = sharding.attach(
                {"w": tree["w"].to("meta"), "v": [t.to("meta") for t in tree["v"]]},
                {"w": (None, None), "v": [(None,), (None,)]})
            out = sharding.constrain_tree(placed, specs)
            assert out["w"].placements == (Shard(0), Shard(1))
            assert [t.placements for t in out["v"]] == [(Replicate(), Shard(0))] * 2
            shard = sharding.tree_shardings(specs)
            assert shard["w"].placements == (Shard(0), Shard(1))


def test_meta_tensors_never_reach_a_kernel():
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.attention(q, q, q)
    x = torch.empty(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.selective_scan(x, x, torch.empty(4, 2, device="meta"),
                           torch.empty(1, 8, 2, device="meta"),
                           torch.empty(1, 8, 2, device="meta"),
                           torch.empty(4, device="meta"))


# ---------------------------------------------------------------------------
# 2 gloo ranks
# ---------------------------------------------------------------------------
ARCHS_2RANK = ("hymba_1_5b", "granite_moe_3b_a800m")


def _losses(cfg, batches, mesh=None, grad_accum=None):
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, grad_accum=grad_accum)
    out = []
    with sharding.use_mesh(mesh):
        if mesh is not None:
            state = sharding.attach(state, train_state_specs(cfg))
        for b in batches:
            b = batch_to_device(b, "cpu")
            if mesh is not None:
                b = sharding.attach(b, {k: ("batch", "seq") for k in b})
            state, m = step(state, b)
            out.append(float(sharding.full(m["loss"])))
    return out


def _two_rank(rank, world, mesh_shape, out_path):
    """Rank body: the sharded step's losses and the unsharded step's, and
    the kernel ops on DTensors split along batch and heads."""
    res = {}
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    for arch in ARCHS_2RANK:
        cfg = tcfg.get_smoke_config(arch)
        ds = SyntheticDataset(cfg, DataConfig(batch=4, seq_len=16, seed=0))
        batches = [ds.next_batch() for _ in range(2)]
        res[arch] = (_losses(cfg, batches), _losses(cfg, batches, mesh))
    # gradient accumulation: the accumulator on the parameters' placements
    res["accum"] = (_losses(cfg, batches, grad_accum=2),
                    _losses(cfg, batches, mesh, grad_accum=2))

    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(4, 4, 8, 16, generator=g) for _ in range(3))
    want = ops.attention(q, k, v, window=5)
    for dim in (0, 1):     # batch, heads
        pl = [Replicate(), Replicate()]
        pl[0 if mesh_shape[0] == 2 else 1] = Shard(dim)
        dq, dk, dv = (sharding.distribute(t, mesh, pl) for t in (q, k, v))
        got = ops.attention(dq, dk, dv, window=5)
        res[f"attention-{dim}"] = float((got.full_tensor() - want).abs().max())
    bad = [Replicate(), Replicate()]
    bad[0 if mesh_shape[0] == 2 else 1] = Shard(2)       # the sequence
    dq = sharding.distribute(q, mesh, bad)
    try:
        ops.attention(dq, dq, dq)
        res["bad"] = "no error"
    except ValueError as e:
        res["bad"] = str(e)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_sharded_train_step_matches_unsharded(mesh_shape, tmp_path):
    """Data parallel (2, 1) and tensor parallel (1, 2): the same losses as
    the unsharded step (rtol 1e-5); the attention op on DTensors split
    along batch or heads equals the unsharded op, and a split along the
    sequence raises."""
    out = tmp_path / "res.json"
    spawn(_two_rank, 2, "gloo", args=(mesh_shape, str(out)), timeout=240)
    with open(out) as f:
        res = json.load(f)
    for arch in ARCHS_2RANK + ("accum",):
        want, got = res[arch]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert res["attention-0"] < 1e-6 and res["attention-1"] < 1e-6
    assert "not local" in res["bad"] and "Shard(dim=2)" in res["bad"]
