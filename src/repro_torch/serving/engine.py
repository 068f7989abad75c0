"""Serving engine: batched prefill + greedy decode with per-request deadlines
(the port's ``repro.serving.engine``).

Every projection of the model runs through the GEMM backend the engine was
built with:

  "torch"          torch.matmul + epilogue (the JAX package's "xla")
  "sfc_cuda"       the hand-written SFC fused-GEMM kernel
  "replicated"     the replicated 2.5D form: split-K partial copies, their
                   sum, the epilogue after (``fuse=False``)
  "sfc_reference"  the Listing-1 reference loop

Sampled ABFT verification (``verify_every=N``): every Nth decode step runs
under ``abft_mode("detect")`` in a step scope (`robust.abft`), so each of
its kernel launches checks its checksum lane on the device and the step
reads the verdict once, at its end.  On a detection the JAX engine
quarantines the kernel rungs and redoes the step on the healed program;
the port has no fallback ladder yet (ROADMAP queue 1 item 14), so it raises
`SdcDetected` for the step instead.  A prefill runs under the caller's
ABFT mode, eagerly: a mismatch raises there too.

Not ported in this slice: warmup and knob tuning (ROADMAP queue 1 item 13),
the self-healing retry and the health registry (item 14), and the
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
from repro_torch.robust import abft as _abft
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
        verify_every: Optional[int] = None,
    ):
        """``params`` is a ``DecoderLM`` state dict (``model.state_dict()``
        or `repro_torch.convert.params_from_jax`).  Tensors already on
        ``device`` in the config's type are used as they are, not copied.
        ``device`` defaults to the card and raises where CUDA is absent.
        ``verify_every``: run every Nth decode step under ABFT "detect"
        (None or 0: never)."""
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
        self._verify_every = verify_every
        self._decode_steps = 0
        self._verified_steps = 0
        self._sdc_detections = 0

    def degradation_report(self) -> Dict[str, Any]:
        """This engine's sampled-verification ledger, under the JAX engine's
        ``"verify"`` key (decode steps run, steps verified, detections).  The
        JAX report's health-registry part waits for the fallback ladder."""
        return {
            "verify": {
                "verify_every": self._verify_every,
                "decode_steps": self._decode_steps,
                "verified_steps": self._verified_steps,
                "sdc_detections": self._sdc_detections,
            }
        }

    # ---------------- model calls ----------------

    def _prefill(self, tokens: torch.Tensor):
        with backend_lib.gemm_backend(self.backend):
            return self.model.prefill(tokens, cache_len=self.max_seq)

    def _decode(self, token: torch.Tensor, cache):
        with backend_lib.gemm_backend(self.backend):
            return self.model.decode_step(token, cache)

    def _verified_decode(self, token: torch.Tensor, cache):
        """One decode step under ABFT "detect" in a step scope: every kernel
        launch checks its checksum on the device, and the scope reads the
        verdict once.  A detection raises `SdcDetected` for the step (the
        JAX engine redoes it on healed rungs; the port has no ladder yet),
        naming the namespaces that mismatched and, as residual over a
        tolerance of 1, the step's largest residual / tolerance."""
        self._verified_steps += 1
        with _abft.abft_mode("detect"), _abft.step_scope() as scope:
            out = self._decode(token, cache)
        if scope.detections:
            self._sdc_detections += sum(scope.detections.values())
            raise _abft.SdcDetected(", ".join(sorted(scope.detections)), scope.max_ratio, 1.0)
        return out

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
                self._decode_steps += 1
                if self._verify_every and self._decode_steps % self._verify_every == 0:
                    logits, cache = self._verified_decode(next_tok, cache)
                else:
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
