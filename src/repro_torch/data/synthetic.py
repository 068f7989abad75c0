"""Deterministic synthetic LM data (a numpy copy of the JAX package's
``repro.data.synthetic``, which imports only numpy).

``batch(step)`` is a pure function of (seed, step), so a restarted run
regenerates the exact batch stream; each data-parallel rank can take its
slice of rows.  Sequences follow per-dataset affine recurrences
t_{i+1} = (a·t_i + b) mod V, so small models visibly reduce the loss.
``HostPrefetcher`` generates future steps on a background thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SyntheticLMConfig", "SyntheticLM", "HostPrefetcher"]


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


class HostPrefetcher:
    """Background-thread prefetch of future steps (overlaps host datagen
    with device compute; depth-bounded queue)."""

    def __init__(self, source: SyntheticLM, start_step: int, depth: int = 2, **slice_kw):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._slice_kw = slice_kw
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch(step, **self._slice_kw)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
