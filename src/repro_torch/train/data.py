"""Deterministic synthetic data pipeline.

Produces reproducible token streams (text) or frame/patch embeddings
(audio/vlm backbones) with a host-side iterator that supports
checkpoint/restore of its cursor — required for exactly-once data consumption
across preemption/restart (the data cursor is part of the checkpoint).

The synthetic text stream is a mixture of Zipfian unigrams and a repeated
n-gram process so that a model can actually reduce loss on it (used by the
end-to-end example to show real learning under preemptions).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.config import ArchConfig


@dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    zipf_a: float = 1.3
    copy_period: int = 16    # repeat period -> learnable structure


class SyntheticDataset:
    """Stateful, checkpointable batch iterator."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        self.step = 0

    # -- checkpointable cursor ------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.dcfg.seed}

    def load_state_dict(self, st: Dict) -> None:
        assert st["seed"] == self.dcfg.seed, "dataset seed mismatch"
        self.step = int(st["step"])

    # -- batch generation ------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.dcfg.seed, step))

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.make_batch(self.step)
        self.step += 1
        return b

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        d, v = self.dcfg, self.cfg.vocab
        rng = self._rng(step)
        # zipf unigrams clipped to vocab
        base = rng.zipf(d.zipf_a, size=(d.batch, d.seq_len + 1))
        base = np.minimum(base - 1, v - 1).astype(np.int32)
        # overwrite half of each row with a periodic pattern (learnable)
        period = d.copy_period
        pattern = rng.integers(0, v, size=(d.batch, period))
        reps = -(-(d.seq_len + 1) // period)
        tiled = np.tile(pattern, (1, reps))[:, : d.seq_len + 1]
        use_pattern = rng.random((d.batch, 1)) < 0.5
        seq = np.where(use_pattern, tiled, base)
        out = {
            "tokens": seq[:, :-1],
            "labels": seq[:, 1:].astype(np.int32),
        }
        if self.cfg.modality != "text":
            # backbone consumes precomputed frontend embeddings
            emb = rng.normal(0, 1, (d.batch, d.seq_len, self.cfg.d_model))
            out["tokens"] = emb.astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
