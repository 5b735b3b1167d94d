"""The port's dry-run (``repro_torch.launch.{specs,hlo_stats,hlo_analyzer,
dryrun,reanalyze}``): the cases of the reference's
``tests/launch/test_specs.py`` and ``test_hlo_analyzer.py``'s roofline
math under the H100 constants, the dry-run machinery on small fake meshes,
and the analyzer's flops held against the reference's ``analyze`` of the
same training step."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.launch as rlaunch
import repro.train.train_step as rtrain
import repro_torch.launch as tlaunch
from repro.launch.hlo_analyzer import analyze as ranalyze
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch.hlo_analyzer import analyze
from repro_torch.launch.hlo_stats import HBM_BW, PEAK_FLOPS, roofline_terms
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.specs import (SHAPES, ShapeSpec, batch_specs,
                                      cell_supported, input_specs, rules_for)
from repro_torch.models.sharding import use_mesh
from repro_torch.train.train_step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exports_equal_the_reference():
    assert tlaunch.__all__ == rlaunch.__all__


# ---------------------------------------------------------------------------
# tests/launch/test_specs.py
# ---------------------------------------------------------------------------
def test_shapes_table():
    assert SHAPES["train_4k"].kind == "train"
    assert SHAPES["train_4k"].seq_len == 4096
    assert SHAPES["train_4k"].global_batch == 256
    assert SHAPES["prefill_32k"].kind == "prefill"
    assert SHAPES["decode_32k"].global_batch == 128
    assert SHAPES["long_500k"].seq_len == 524_288


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_500k_skip_rule(arch):
    cfg = get_config(arch)
    ok, reason = cell_supported(cfg, SHAPES["long_500k"])
    if arch in ("falcon_mamba_7b", "hymba_1_5b"):
        assert ok, (arch, reason)
    else:
        assert not ok and "quadratic" in reason


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_all_other_shapes_supported(arch):
    cfg = get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        ok, _ = cell_supported(cfg, SHAPES[name])
        assert ok


def test_batch_specs_modality():
    shapes, specs = batch_specs(get_config("phi_3_vision_4_2b"),
                                SHAPES["train_4k"])
    assert len(shapes["tokens"].shape) == 3  # precomputed embeddings
    assert shapes["tokens"].device.type == "meta"
    shapes, specs = batch_specs(get_config("deepseek_7b"), SHAPES["train_4k"])
    assert len(shapes["tokens"].shape) == 2


def test_rules_for_overrides():
    llama = get_config("llama3_405b")
    r = rules_for(llama, SHAPES["train_4k"])
    assert r["fsdp"] == ("pod", "data")
    assert r["res_seq"] == "model"
    # decode: no sequence-parallel residual
    r2 = rules_for(llama, SHAPES["decode_32k"])
    assert "res_seq" not in r2
    assert rules_for(get_config("deepseek_7b"), SHAPES["train_4k"]) == {}


# ---------------------------------------------------------------------------
# tests/launch/test_hlo_analyzer.py::test_roofline_terms_math, H100 constants
# ---------------------------------------------------------------------------
def test_roofline_terms_math():
    assert (PEAK_FLOPS, HBM_BW) == (989e12, 3.35e12)
    t = roofline_terms(flops=PEAK_FLOPS * 512, hbm_bytes=0, coll_bytes=0,
                       chips=512)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute_s"
    t2 = roofline_terms(flops=1, hbm_bytes=HBM_BW * 2, coll_bytes=0, chips=1)
    assert t2["memory_s"] == pytest.approx(2.0)
    assert t2["dominant"] == "memory_s"
    t3 = roofline_terms(flops=1, hbm_bytes=1, coll_bytes=50e9 * 3, chips=1)
    assert t3["collective_s"] == pytest.approx(3.0)
    assert t3["dominant"] == "collective_s"


# ---------------------------------------------------------------------------
# the machinery on small meshes
# ---------------------------------------------------------------------------
def _mini(cfg, mesh_shape, shape):
    with fake_group(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
        with use_mesh(mesh):
            args = input_specs(cfg, shape)
            assert all(p.device.type == "meta"
                       for p in args[0].params.parameters())
            return analyze(make_train_step(cfg), *args)


def test_dryrun_machinery_small_mesh():
    """The reference's ``tests/test_system.py::
    test_dryrun_machinery_small_mesh``: granite smoke on a (4, 2) mesh moves
    data between ranks; on (1, 1) it moves none."""
    cfg = get_smoke_config("granite_moe_3b_a800m")
    shape = ShapeSpec("mini_train", "train", 64, 8)
    ana = _mini(cfg, (4, 2), shape)
    assert ana.flops > 0 and ana.hbm_bytes > 0
    assert ana.collective_bytes > 0
    assert set(ana.collective_by_kind) <= {"all-gather", "all-reduce",
                                          "reduce-scatter", "all-to-all",
                                          "collective-permute"}
    one = _mini(cfg, (1, 1), shape)
    assert one.collective_bytes == 0 and one.flops == ana.flops * 8


def _reference_flops(arch, b, t):
    cfg = rcfg.get_smoke_config(arch)
    state = rtrain.init_train_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (b, t)),
                                   jnp.int32),
             "labels": jnp.asarray(rng.integers(0, cfg.vocab, (b, t)),
                                   jnp.int32)}
    hlo = jax.jit(rtrain.make_train_step(cfg), donate_argnums=(0,)).lower(
        state, batch).compile().as_text()
    return ranalyze(hlo).flops


REFERENCE_FLOPS = {"deepseek_7b": 241_172_480,
                   "granite_moe_3b_a800m": 108_011_520}


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 2)], ids=["1x1", "4x2"])
@pytest.mark.parametrize("arch", ["deepseek_7b", "granite_moe_3b_a800m",
                                  "hymba_1_5b"])
def test_flops_held_against_the_reference(arch, mesh_shape):
    """B = 4, T = 64: per-device flops x ranks equal the reference's
    analyze() of its jitted step on one CPU device; Hymba's exceed it by
    0.33%, the backward of the plain scan's output contraction
    (``bcdn,bcn->bcd``), a bmm here and a broadcast multiply in XLA."""
    want = _reference_flops(arch, 4, 64)
    got = _mini(get_smoke_config(arch), mesh_shape,
                ShapeSpec("mini", "train", 64, 4)).flops * int(np.prod(mesh_shape))
    if arch in REFERENCE_FLOPS:
        assert want == REFERENCE_FLOPS[arch]
        assert got == want
    else:
        assert got > want and (got - want) / want < 0.005, (got, want)


def test_depth_extrapolation_is_exact():
    """A 4-layer trace equals the count taken from depths 1 and 2."""
    cfg = get_smoke_config("hymba_1_5b").replace(n_layers=4)
    shape = ShapeSpec("mini", "train", 64, 8)
    with fake_group(8):
        mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
        with use_mesh(mesh):
            runs = {k: analyze(make_train_step(cfg.replace(n_layers=k)),
                               *input_specs(cfg.replace(n_layers=k), shape))
                    for k in (1, 2, 4)}
    ext = dryrun._extrapolate(runs[1].per_op, runs[2].per_op, 4)
    assert {k: v for k, v in ext.items() if any(v)} == runs[4].per_op


def test_run_cell_and_reanalyze(tmp_path, monkeypatch):
    """A cell's record has the reference's fields (less the compiler's);
    reanalyze recomputes its totals and roofline from the saved ops."""
    monkeypatch.setitem(dryrun.SHAPES, "mini", ShapeSpec("mini", "train", 64, 32))
    rec = dryrun.run_cell("hymba_1_5b", "mini", False, device="cpu",
                          ops_dir=str(tmp_path / "ops"),
                          cfg=get_smoke_config("hymba_1_5b"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["hlo_flops"] > 0
    for key in ("lower_s", "memory", "hlo_analysis", "model_flops",
                "useful_flops_ratio", "roofline"):
        assert key in rec
    assert "compile_s" not in rec and "cost_analysis_body_once" not in rec
    want = dict(rec)
    rec["roofline"] = {}
    rec["hlo_analysis"] = {}
    with open(tmp_path / "hymba_1_5b__mini__pod16x16.json", "w") as f:
        json.dump(rec, f)
    assert reanalyze.main(["--results", str(tmp_path)]) == 0
    with open(tmp_path / "hymba_1_5b__mini__pod16x16.json") as f:
        got = json.load(f)
    assert got["roofline"] == want["roofline"]
    assert got["hlo_analysis"] == want["hlo_analysis"]


def test_dryrun_defaults_to_the_card(tmp_path):
    args = ["--arch", "deepseek_7b", "--shape", "long_500k", "--mesh",
            "single", "--out", str(tmp_path)]
    assert dryrun.main(args) == 0     # a skipped cell builds no mesh
    if not torch.cuda.is_available():
        rec = dryrun.run_cell("deepseek_7b", "decode_32k", False)
        assert rec["status"] == "error" and "CUDA" in rec["error"]


# ---------------------------------------------------------------------------
# tests/test_system.py::test_dryrun_results_if_present
# ---------------------------------------------------------------------------
def test_dryrun_results_if_present():
    files = glob.glob(os.path.join(REPO, "results", "dryrun_torch", "*.json"))
    if not files:
        pytest.skip("run PYTHONPATH=src python -m repro_torch.launch.dryrun "
                    "--device cpu first")
    statuses = {}
    for f in files:
        with open(f) as fh:
            rec = json.load(fh)
        statuses.setdefault(rec["status"], []).append(
            (rec["arch"], rec["shape"], rec["mesh"]))
    assert "error" not in statuses, statuses.get("error")
    # 10 archs x 4 shapes x 2 meshes = 80 cells; 8 full-attention archs skip
    # long_500k on both meshes = 16 skips
    assert len(files) == 80
    assert len(statuses.get("ok", [])) == 64
    assert len(statuses.get("skipped", [])) == 16
