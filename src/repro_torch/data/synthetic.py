"""Deterministic synthetic LM data (a numpy copy of the JAX package's
``repro.data.synthetic``, which imports only numpy).

``batch(step)`` is a pure function of (seed, step), so a restarted run
regenerates the exact batch stream; each data-parallel rank can take its
slice of rows.  Sequences follow per-dataset affine recurrences
t_{i+1} = (a·t_i + b) mod V, so small models visibly reduce the loss.
The background ``HostPrefetcher`` waits for ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["SyntheticLMConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """batch(step) -> {"tokens": (B, S) int32, "labels": (B, S) int32}."""

    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.cfg.seed, step]))

    def batch(self, step: int, *, lo: int = 0, hi: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Rows [lo, hi) of the step's global batch (shard for a DP rank)."""
        cfg = self.cfg
        hi = cfg.global_batch if hi is None else hi
        # dataset-wide affine map (depends on the seed, not the step)
        drng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xAFF1]))
        a0 = int(drng.integers(1, cfg.vocab))
        b0 = int(drng.integers(0, cfg.vocab))
        # start tokens for the whole global batch, so every rank agrees on
        # the stream however it is sliced
        t0 = self._rng(step).integers(0, cfg.vocab, size=cfg.global_batch, dtype=np.int64)[lo:hi]
        toks = np.empty((hi - lo, cfg.seq_len + 1), np.int64)
        toks[:, 0] = t0
        for i in range(cfg.seq_len):
            toks[:, i + 1] = (a0 * toks[:, i] + b0) % cfg.vocab
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
