"""The port's training launcher (``python -m repro_torch.launch.train``)
against the reference's (``repro.launch.train``) on the CPU, at smoke size:
a plain run, a restart from its checkpoint, and ``--elastic``.

Both launchers start from the same state: the port's ``init_train_state``
is replaced by ``train_state_from_jax`` of the reference's initial state.
The printed lines are held equal, the losses (printed to 4 decimals) within
one unit in the last place, and ``s/step`` left out.
"""
import re

import jax
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.launch.train import main as rmain
from repro.train import init_train_state as rinit
import repro_torch.elastic.elastic as telastic
import repro_torch.launch.train as tlaunch
from repro_torch.models.weights import train_state_from_jax

ARCH = "hymba_1_5b"
LOSS = re.compile(r"loss (\d+\.\d{4})")


@pytest.fixture
def same_init(monkeypatch):
    """Makes the port start from the reference's initial state for
    ``--seed`` ``seed``."""
    def use(seed=0):
        jstate = jax.tree.map(np.asarray, rinit(rcfg.get_smoke_config(ARCH),
                                                jax.random.PRNGKey(seed)))

        def init(cfg, gen, device=None):
            return train_state_from_jax(cfg, jstate, device)

        monkeypatch.setattr(tlaunch, "init_train_state", init)
        monkeypatch.setattr(telastic, "init_train_state", init)
    return use


def _run(main, argv, capsys, ckpt):
    assert main(argv + ["--ckpt-dir", str(ckpt)]) == 0
    return capsys.readouterr().out.strip().splitlines()


def _both(argv, capsys, tmp_path, tag=""):
    base = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq-len", "24",
            "--log-every", "1"] + argv
    got = _run(tlaunch.main, base + ["--device", "cpu"], capsys,
               tmp_path / f"port{tag}")
    want = _run(rmain, base, capsys, tmp_path / f"ref{tag}")
    return got, want


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        lg, lw = LOSS.search(g), LOSS.search(w)
        if lw is None:
            assert g == w
            continue
        assert abs(float(lg.group(1)) - float(lw.group(1))) <= 1.5e-4, (g, w)
        strip = lambda line: LOSS.sub("", line).split(" (")[0]
        assert strip(g) == strip(w)


def test_plain_run_and_restart_match_reference(same_init, capsys, tmp_path):
    same_init()
    got, want = _both(["--steps", "4", "--checkpoint-every", "3"], capsys,
                      tmp_path)
    _same(got, want)
    assert got[-1] == "done" and got[0].startswith("step     1 loss")
    # the restart: 4 more steps from the final checkpoint of the first run
    got, want = _both(["--steps", "4"], capsys, tmp_path)
    _same(got, want)
    assert got[0] == "restored from step 4" and got[1].startswith("step     5")


def test_restart_continues_the_straight_run(same_init, capsys, tmp_path):
    same_init()
    argv = ["--steps", "6", "--device", "cpu", "--arch", ARCH, "--smoke",
            "--batch", "4", "--seq-len", "24", "--log-every", "1"]
    straight = _run(tlaunch.main, argv, capsys, tmp_path / "a")
    half = argv[:]
    half[1] = "3"
    first = _run(tlaunch.main, half, capsys, tmp_path / "b")
    second = _run(tlaunch.main, half, capsys, tmp_path / "b")
    assert second[0] == "restored from step 3"
    strip = lambda lines: [line.split(" (")[0] for line in lines]
    assert strip(first[:-1] + second[1:]) == strip(straight)


def test_elastic_matches_reference(same_init, capsys, tmp_path):
    """Seed 3 over 20 steps: two simulated interruptions at width 1."""
    same_init(3)
    got, want = _both(["--steps", "20", "--seed", "3", "--elastic"], capsys,
                      tmp_path)
    _same(got, want)
    assert got[0] == ("elastic run: steps=20 rescales=1 emergency_saves=2 "
                      "restores=0")


def test_defaults_to_cuda_and_refuses_width_above_one(capsys, tmp_path):
    args = tlaunch.parse_args(["--arch", ARCH])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.main(["--arch", ARCH, "--smoke", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="need 2 devices"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--n-data", "2", "--ckpt-dir", str(tmp_path)])
