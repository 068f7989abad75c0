"""Serving engine: batched prefill + greedy decode with per-request deadlines
(the port's ``repro.serving.engine``).

Every projection of the model runs through the GEMM backend the engine was
built with:

  "torch"          torch.matmul + epilogue (the JAX package's "xla")
  "sfc_cuda"       the hand-written SFC fused-GEMM kernel
  "replicated"     the replicated 2.5D form: split-K partial copies, their
                   sum, the epilogue after (``fuse=False``)
  "sfc_reference"  the Listing-1 reference loop

Not ported in this slice: warmup and knob tuning (ROADMAP queue 1 item 13),
sampled ABFT verification and the self-healing retry (item 14), and the
telemetry registry (item 15); percentiles are computed with numpy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device, torch_dtype
from repro_torch.core.namespaces import BACKEND_TORCH, BACKENDS
from repro_torch.models.registry import build_model
from repro_torch.serving import backend as backend_lib

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    # per-request latency budget, seconds from submission; None = no budget.
    # Overrun waiting requests are shed before prefill; overrun live decodes
    # retire at the next step boundary.  Either way status = "timed_out".
    deadline_s: Optional[float] = None
    # filled by the engine:
    status: str = "pending"  # pending | completed | timed_out
    output: Optional[List[int]] = None
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    done_at: float = 0.0

    def past_deadline(self, now: float) -> bool:
        return (
            self.deadline_s is not None
            and now - self.submitted_at > self.deadline_s
        )


class ServingEngine:
    """Single-host batched serving of a dense decoder with a KV cache:
    equal-length prompt grouping, greedy sampling, per-request latency
    accounting."""

    def __init__(
        self,
        cfg: ArchConfig,
        params: Mapping[str, torch.Tensor],
        *,
        max_batch: int = 8,
        max_seq: int = 256,
        gemm_backend: str = BACKEND_TORCH,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``params`` is a ``DecoderLM`` state dict (``model.state_dict()``
        or `repro_torch.convert.params_from_jax`).  Tensors already on
        ``device`` in the config's type are used as they are, not copied.
        ``device`` defaults to the card and raises where CUDA is absent."""
        if gemm_backend not in BACKENDS:
            raise ValueError(f"unknown gemm backend {gemm_backend!r}; pick from {BACKENDS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.backend = gemm_backend
        dtype = torch_dtype(cfg.param_dtype)
        self.model = build_model(cfg, device="meta")
        self.model.load_state_dict(
            {k: v.to(device=self.device, dtype=dtype) for k, v in params.items()},
            assign=True,
        )
        self._uid = 0

    # ---------------- model calls ----------------

    def _prefill(self, tokens: torch.Tensor):
        with backend_lib.gemm_backend(self.backend):
            return self.model.prefill(tokens, cache_len=self.max_seq)

    def _decode(self, token: torch.Tensor, cache):
        with backend_lib.gemm_backend(self.backend):
            return self.model.decode_step(token, cache)

    # ---------------- serving loop ----------------

    def submit_many(
        self,
        prompts: List[np.ndarray],
        max_new_tokens: int = 16,
        deadline_s: Optional[float] = None,
    ) -> List[Request]:
        reqs = []
        for p in prompts:
            self._uid += 1
            reqs.append(
                Request(
                    uid=self._uid,
                    prompt=np.asarray(p, np.int32),
                    max_new_tokens=max_new_tokens,
                    submitted_at=time.perf_counter(),
                    deadline_s=deadline_s,
                )
            )
        return reqs

    def run(self, requests: List[Request], eos_id: Optional[int] = None) -> List[Request]:
        """Serve the requests in prefill groups of up to ``max_batch``
        equal-length prompts, decoding each group's live slots jointly.

        ``deadline_s`` budgets are enforced where the JAX engine enforces
        them: waiting requests past their deadline are shed before prefill,
        a group is checked again right after its prefill, and live decodes
        past their deadline retire at the next step boundary, all with
        ``status="timed_out"``.  Times are taken after the device has
        produced the tokens they stamp."""
        waiting = list(requests)
        results: List[Request] = []

        def shed_overdue() -> None:
            now = time.perf_counter()
            for r in [r for r in waiting if r.past_deadline(now)]:
                waiting.remove(r)
                r.status = "timed_out"
                r.done_at = now
                if r.output is None:
                    r.output = []
                results.append(r)

        while waiting:
            shed_overdue()
            if not waiting:
                break
            # group up to max_batch same-length prompts
            length = len(waiting[0].prompt)
            batch = [r for r in waiting if len(r.prompt) == length][: self.max_batch]
            for r in batch:
                waiting.remove(r)

            tokens = torch.from_numpy(np.stack([r.prompt for r in batch])).long().to(self.device)
            logits, cache = self._prefill(tokens)
            next_tok = logits.argmax(dim=-1)[:, None]
            ids = next_tok[:, 0].tolist()  # waits for the device
            now = time.perf_counter()
            live = []
            for i, r in enumerate(batch):
                r.output = []
                if r.past_deadline(now):
                    r.status = "timed_out"
                    r.done_at = now
                else:
                    r.first_token_at = now
                    r.output.append(ids[i])
                    live.append(i)

            steps = max(r.max_new_tokens for r in batch) - 1
            for _ in range(steps):
                now = time.perf_counter()
                for i in list(live):
                    r = batch[i]
                    if r.past_deadline(now):
                        r.status = "timed_out"
                        r.done_at = now
                        live.remove(i)
                if not live:
                    break
                logits, cache = self._decode(next_tok, cache)
                next_tok = logits.argmax(dim=-1)[:, None]
                ids = next_tok[:, 0].tolist()
                still = []
                for i in live:
                    r = batch[i]
                    tok = ids[i]
                    if len(r.output) < r.max_new_tokens:
                        r.output.append(tok)
                    finished = len(r.output) >= r.max_new_tokens or (
                        eos_id is not None and tok == eos_id
                    )
                    if finished:
                        r.status = "completed"
                        r.done_at = time.perf_counter()
                    else:
                        still.append(i)
                live = still
            now = time.perf_counter()
            for r in batch:
                if not r.done_at:
                    r.status = "completed"
                    r.done_at = now
            results.extend(batch)
        return results

    # ---------------- metrics ----------------

    @staticmethod
    def latency_report(requests: List[Request]) -> Dict[str, Any]:
        """Latency summary with the JAX engine's keys; zeros on an empty
        list.  Requests shed before serving (``first_token_at == 0``) are
        left out of the TTFT statistics and counted in ``n_timed_out``."""
        zeros = {
            "n_requests": 0,
            "n_timed_out": 0,
            "ttft_mean_s": 0.0,
            "ttft_p50_s": 0.0,
            "ttft_p95_s": 0.0,
            "ttft_p99_s": 0.0,
            "latency_mean_s": 0.0,
            "token_p50_s": 0.0,
            "token_p95_s": 0.0,
            "token_p99_s": 0.0,
            "tokens_total": 0,
            "tokens_per_s": 0.0,
        }
        if not requests:
            return zeros
        ttft, token = [], []
        for r in requests:
            if r.first_token_at > 0:
                ttft.append(r.first_token_at - r.submitted_at)
                n_out = len(r.output or [])
                if n_out > 1:
                    token.append((r.done_at - r.first_token_at) / (n_out - 1))

        def pct(vals):
            if not vals:
                return 0.0, 0.0, 0.0
            return tuple(float(x) for x in np.percentile(vals, (50, 95, 99)))

        t50, t95, t99 = pct(ttft)
        k50, k95, k99 = pct(token)
        total = [r.done_at - r.submitted_at for r in requests]
        n_tok = sum(len(r.output or []) for r in requests)
        wall = max(r.done_at for r in requests) - min(r.submitted_at for r in requests)
        return {
            "n_requests": len(requests),
            "n_timed_out": sum(1 for r in requests if r.status == "timed_out"),
            "ttft_mean_s": float(np.mean(ttft)) if ttft else 0.0,
            "ttft_p50_s": t50,
            "ttft_p95_s": t95,
            "ttft_p99_s": t99,
            "latency_mean_s": float(np.mean(total)),
            "token_p50_s": k50,
            "token_p95_s": k95,
            "token_p99_s": k99,
            "tokens_total": n_tok,
            "tokens_per_s": n_tok / wall if wall > 0 else float("inf"),
        }
