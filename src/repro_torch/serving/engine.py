"""Serving engine: batched prefill + greedy decode with per-request deadlines
(the port's ``repro.serving.engine``).

Every projection of the model runs through the GEMM backend the engine was
built with:

  "torch"          torch.matmul + epilogue (the JAX package's "xla")
  "sfc_cuda"       the hand-written SFC fused-GEMM kernel
  "replicated"     the replicated 2.5D form: split-K partial copies, their
                   sum, the epilogue after (``fuse=False``)
  "sfc_reference"  the Listing-1 reference loop

Self-healing (`_run_healed`, the JAX engine's): every op of a prefill or
decode step already degrades through its own fallback ladder
(`robust.run_with_fallback`); a classified failure that still reaches the
engine quarantines the kernel rungs of every namespace it routes
(`_LADDER_NAMESPACES`, shape None: the whole rung) and retries the call
once.  A decode step has written the KV slot and, in the hybrid and the
xLSTM, the recurrent state in place before it fails: the KV slot is
rewritten at the same index by the retry, but a recurrent state would take
the step twice, so such a step is retried only from a snapshot (below),
and otherwise re-raises after quarantining.  On the card a failure the
fault harness did not inject raises `robust.StrictFallbackError` instead
of quarantining, unless ``REPRO_ALLOW_FALLBACK=1`` allows the descent (the
ladder's own rule; ``REPRO_STRICT=1`` makes it so on the CPU too).

Sampled ABFT verification (``verify_every=N``): every Nth decode step runs
under ``abft_mode("detect")`` in a step scope (`robust.abft`), so each of
its kernel launches checks its checksum lane on the device and the step
reads the verdict once, at its end.  On a detection the engine quarantines
the kernel rungs of its namespaces and redoes the step on the healed rungs
(the GEMMs on "sfc_reference", attention on its oracle), as the JAX engine
redoes it on the healed trace.  The redo must start from the state before
the step: the dense decoders' KV slot is simply rewritten, and the
recurrent state of the hybrid and the xLSTM is restored from a snapshot
taken before each verified step (only those; its device time is in
`degradation_report()["snapshot"]`).  A prefill runs under the caller's
ABFT mode, eagerly: a mismatch raises there, and its ladders retry it.

Warmup (`ServingEngine.warmup`) runs one prefill and one decode step
before traffic and, with ``tune=True`` under "sfc_cuda", first calibrates
the device and tunes every namespace of `tune_table` (`repro_torch.tune`),
as the JAX engine does under "sfc_pallas".

Telemetry (`repro_torch.obs`, the JAX engine's series): the spans
``serving/admission``, ``serving/prefill``, ``serving/decode`` and
``serving/retire``; ``serving.requests``, ``serving.sdc_redo``, and per
retired request ``serving.completed`` / ``timed_out`` / ``shed`` /
``tokens`` and the ``serving.ttft_us``, ``e2e_us`` and ``token_us``
histograms (`_record_retired`).  The prefill and decode spans end with the
step's one host read (the tokens), so they time the device's work too;
JAX's end at the dispatch.  `latency_report` takes its percentiles from
the same `obs.metrics.Histogram`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import namespaces as ns
from repro_torch.core.device import resolve_device, torch_dtype
from repro_torch.core.namespaces import BACKEND_SFC_CUDA, BACKEND_TORCH, BACKENDS
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span
from repro_torch.robust import abft as _abft
from repro_torch.robust.inject import InjectedFault
from repro_torch.robust.ladder import (
    KERNEL_RUNGS,
    StrictFallbackError,
    classify_failure,
    get_registry,
    refuses_degradation,
)
from repro_torch.serving import backend as backend_lib

__all__ = ["Request", "ServingEngine"]


def _recurrent_state(cache) -> List[torch.Tensor]:
    """The tensors of a cache that a decode step updates in place, but the
    KV caches ("k", "v"), which a redo rewrites at the same index: the
    hybrid's SSM states and conv tails, the xLSTM's state; none for the
    dense decoders."""
    out: List[torch.Tensor] = []

    def walk(x, key):
        if isinstance(x, torch.Tensor):
            if key not in ("k", "v"):
                out.append(x)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, k)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v, key)

    walk(cache, None)
    return out


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
    """Single-host batched serving of the decoder-only models `build_model`
    returns (the dense and MoE decoders, the hybrid, the xLSTM) with their
    cache: equal-length prompt grouping, greedy sampling, per-request
    latency accounting.  The engine reads nothing of the cache; the model
    updates it in place (the hybrid's SSM states and conv tails as the KV
    caches, the xLSTM's recurrent state).  The encoder-decoder family is
    not served, as in the JAX package: drive ``EncDecLM.prefill`` and
    ``decode_step``."""

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
        """``params`` is the model's state dict (``model.state_dict()`` or
        `repro_torch.convert.params_from_jax`).  Each tensor takes the type
        of its parameter in the model (the config's type, but where the
        model keeps a parameter in f32, as the hybrid's Mamba2 mixers keep
        ``A_log``, ``D`` and ``dt_bias``); tensors already on ``device`` in
        that type are used as they are, not copied.
        ``device`` defaults to the card and raises where CUDA is absent.
        ``verify_every``: run every Nth decode step under ABFT "detect"
        (None or 0: never)."""
        if gemm_backend not in BACKENDS:
            raise ValueError(f"unknown gemm backend {gemm_backend!r}; pick from {BACKENDS}")
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name!r} is an encoder-decoder: drive EncDecLM.prefill and decode_step")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.backend = gemm_backend
        dtype = torch_dtype(cfg.param_dtype)
        self.model = build_model(cfg, device="meta")
        types = {k: v.dtype for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(
            {k: v.to(device=self.device, dtype=types.get(k, dtype)) for k, v in params.items()},
            assign=True,
        )
        self._uid = 0
        self._verify_every = verify_every
        self._decode_steps = 0
        self._verified_steps = 0
        self._sdc_detections = 0
        self._snapshots: List[Any] = []  # (start, end) CUDA events, or host seconds

    # namespaces an engine call may route through the fallback ladder: what
    # a classified failure or a detection quarantines wholesale
    _LADDER_NAMESPACES = (
        ns.NS_GEMM, ns.NS_GLU, ns.NS_GROUPED, ns.NS_GROUPED_GLU,
        ns.NS_ATTN_FWD, ns.NS_ATTN_DECODE,
    )

    def _quarantine_kernels(self, reason: str, *, injected: bool, exc: Optional[BaseException] = None) -> None:
        """Quarantine the kernel rungs of every routed namespace, or raise
        `StrictFallbackError` where no degradation is allowed (a fault not
        injected, on the card without ``REPRO_ALLOW_FALLBACK=1``, or under
        ``REPRO_STRICT=1``; `robust.ladder.refuses_degradation`)."""
        if refuses_degradation(injected, self.device.type == "cuda"):
            raise StrictFallbackError(
                f"the engine would quarantine every kernel rung ({reason}) and serve on the rungs below"
                + ("; REPRO_ALLOW_FALLBACK=1 allows it on the card" if self.device.type == "cuda" else "")
            ) from exc
        reg = get_registry()
        for namespace in self._LADDER_NAMESPACES:
            for rung in KERNEL_RUNGS:
                reg.quarantine(namespace, rung, None, reason, injected=injected, error=exc)

    def _run_healed(self, which: str, *args, restore: Optional[Callable[[], None]] = None):
        """Run ``_prefill`` or ``_decode``; on a *classified* failure
        quarantine the kernel rungs of every namespace this engine routes
        (shape ``None``: the whole rung) and retry once, so the retry walks
        the ladders to the rungs below.  ``restore`` puts a decode step's
        recurrent state back as it was before the step (a verified step's
        snapshot); a decode whose cache holds recurrent state and that has
        no ``restore`` is not retried but re-raised, since its state is
        half updated.  Unclassified errors propagate: self-healing covers
        platform breakage, not bugs."""
        try:
            return getattr(self, which)(*args)
        except Exception as exc:  # noqa: BLE001 — classified below
            kind = classify_failure(exc)
            if kind is None:
                raise
            self._quarantine_kernels(kind, injected=isinstance(exc, InjectedFault), exc=exc)
            if restore is not None:
                restore()
            elif which == "_decode" and _recurrent_state(args[1]):
                raise
            return getattr(self, which)(*args)

    def _snapshot(self, cache) -> Callable[[], None]:
        """Copy the cache's recurrent state (`_recurrent_state`) and return
        what puts it back; a no-op for the dense decoders.  The copy's
        device time is kept for `degradation_report`."""
        state = _recurrent_state(cache)
        if not state:
            return lambda: None
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            saved = [t.clone() for t in state]
            end.record()
            self._snapshots.append((start, end))
        else:
            t0 = time.perf_counter()
            saved = [t.clone() for t in state]
            self._snapshots.append(time.perf_counter() - t0)

        def restore() -> None:
            for t, c in zip(state, saved):
                t.copy_(c)

        return restore

    def degradation_report(self) -> Dict[str, Any]:
        """Health-registry summary for the namespaces this engine serves,
        plus this engine's sampled-verification ledger (decode steps run,
        steps verified, detections that forced a redo), under the JAX
        engine's keys, and the recurrent-state snapshots of its verified
        steps (``"snapshot"``: their number and device milliseconds; host
        seconds on the CPU)."""
        from repro_torch.robust import degradation_report as _report

        rep = _report(namespaces=self._LADDER_NAMESPACES)
        rep["verify"] = {
            "verify_every": self._verify_every,
            "decode_steps": self._decode_steps,
            "verified_steps": self._verified_steps,
            "sdc_detections": self._sdc_detections,
        }
        times = [s[0].elapsed_time(s[1]) if isinstance(s, tuple) else s * 1e3 for s in self._snapshots]
        rep["snapshot"] = {"count": len(times), "ms": float(sum(times))}
        return rep

    # ---------------- model calls ----------------

    def _prefill(self, tokens: torch.Tensor):
        with backend_lib.gemm_backend(self.backend):
            return self.model.prefill(tokens, cache_len=self.max_seq)

    def _decode(self, token: torch.Tensor, cache):
        with backend_lib.gemm_backend(self.backend):
            return self.model.decode_step(token, cache)

    def _verified_decode(self, token: torch.Tensor, cache):
        """One decode step under ABFT "detect" in a step scope with
        runtime-SDC handling: every kernel launch checks its checksum on the
        device, and the scope reads the verdict once.  On a detection the
        kernel rungs of every routed namespace are quarantined and the step
        is *redone* from the state before it (the recurrent state restored
        from its snapshot), so the cache never absorbs the flip."""
        self._verified_steps += 1
        restore = self._snapshot(cache)
        with _abft.abft_mode("detect"), _abft.step_scope() as scope:
            out = self._run_healed("_decode", token, cache, restore=restore)
        delta = sum(scope.detections.values())
        if not delta:
            return out
        self._sdc_detections += delta
        obs_metrics.inc("serving.sdc_redo", value=delta)
        restore()
        # the scope's detections were all the fault harness's
        self._quarantine_kernels("sdc", injected=sum(scope.injected.values()) == delta)
        return self._run_healed("_decode", token, cache, restore=restore)

    # ---------------- warmup / tuning ----------------

    def _launch_rows(self, prompt_len: int) -> int:
        """Rows of one launch of a prefill projection: the JAX engine keys a
        sequence's (its kernel's batch walks the sequences); on the card a
        shared weight's batch folds into the rows of one launch, so the
        tune cache is keyed (and its winners measured) at max_batch x
        prompt_len (`kernels.ops.sfc_matmul`)."""
        return prompt_len * (self.max_batch if self.device.type == "cuda" else 1)

    def projection_gemm_shapes(self, prompt_len: int) -> List[Tuple[str, int, int, int]]:
        """(op, M, N, K) of the dominant prefill projection GEMMs at this
        batch size, the JAX engine's table: attention / ffn projections (M
        the rows of one launch, `_launch_rows`) and the LM head (the last
        position of each sequence); "glu" for the gated up-projection,
        "gemm" otherwise."""
        d, ff, v = self.cfg.d_model, self.cfg.d_ff, self.cfg.vocab
        rows = self._launch_rows(prompt_len)
        shapes = [(ns.NS_GEMM, rows, d, d)]
        if ff:
            up_op = ns.NS_GLU if getattr(self.cfg, "gated_mlp", True) else ns.NS_GEMM
            shapes += [(up_op, rows, ff, d), (ns.NS_GEMM, rows, d, ff)]
        shapes.append((ns.NS_GEMM, self.max_batch, v, d))
        return shapes

    def tune_table(self, prompt_len: int, *, backward: bool = False,
                   update: bool = False) -> List[Tuple[str, int, int, int]]:
        """The (op, m, n, k) tune-namespace table warmup fills, the JAX
        engine's: per forward projection shape its namespace; with
        ``backward`` the two backward buckets (`perf_model.
        backward_gemm_shapes`) in the namespaces the training backward
        resolves (the dual forms for the GLU); with ``update`` the fused
        optimizer's on the TN buckets; under attn_impl "sfc" the flash
        forward (and with ``backward`` its backward) at (prompt_len,
        prompt_len, head_dim) and the decode at (heads, max_seq,
        head_dim).  On the card a training step runs the LM head at every
        row, so with ``backward`` or ``update`` the head's forward is tuned
        at `_launch_rows` too and its backward buckets derive from those
        rows (the JAX engine derives them from the serve's max_batch)."""
        from repro_torch.core.perf_model import attention_phase_shapes, backward_gemm_shapes

        rows = self._launch_rows(prompt_len)
        card = self.device.type == "cuda"
        entries: List[Tuple[str, int, int, int]] = []
        for (op, m, n, k) in self.projection_gemm_shapes(prompt_len):
            entries.append((op, m, n, k))
            if not (backward or update):
                continue
            if card and m != rows:
                m = rows
                entries.append((op, m, n, k))
            bwd = backward_gemm_shapes(m, n, k)
            dual = op == ns.NS_GLU
            if backward:
                entries.append((ns.NS_NT_DUAL if dual else ns.NS_NT, *bwd[ns.NS_NT]))
                entries.append((ns.NS_TN_DUAL if dual else ns.NS_TN, *bwd[ns.NS_TN]))
            if update:
                entries.append((ns.NS_TN_UPDATE_DUAL if dual else ns.NS_TN_UPDATE, *bwd[ns.NS_TN]))
        if getattr(self.cfg, "attn_impl", "") == "sfc":
            attn = attention_phase_shapes(prompt_len, prompt_len, self.cfg.head_dim_, n_heads=self.cfg.n_heads,
                                          cache_len=self.max_seq)
            entries.append((ns.NS_ATTN_FWD, *attn[ns.NS_ATTN_FWD]))
            if backward:
                entries.append((ns.NS_ATTN_BWD, *attn[ns.NS_ATTN_BWD]))
            entries.append((ns.NS_ATTN_DECODE, *attn[ns.NS_ATTN_DECODE]))
        return entries

    def warmup(
        self,
        prompt_len: int = 32,
        *,
        tune: bool = False,
        tune_backward: bool = False,
        tune_update: bool = False,
        tune_strategy: str = "predict",
    ) -> Optional[Dict[str, Any]]:
        """Run one prefill of ``max_batch`` x ``prompt_len`` tokens and one
        decode step before traffic arrives (first launches, task tables,
        the allocator); with ``tune=True`` under "sfc_cuda" first calibrate
        the device (`repro_torch.tune.calibrate`, once per device kind) and
        tune every namespace of `tune_table` on the engine's device, keyed
        by the parameters' type, so that the serve resolves the winners (a
        second warmup is a pure cache hit: it measures nothing).

        ``tune_backward`` adds the backward namespaces and implies ``tune``;
        ``tune_update`` adds the fused optimizer's and implies
        ``tune_backward``.  ``tune_strategy``: `tune_gemm`'s.  On the card
        an attention namespace is measured at the model's heads (max_batch,
        n_heads, kv_heads).  A failed calibration or measurement raises.

        Returns, when tuning ran, the JAX engine's stats: ``n_namespaces``,
        ``n_measured``, ``median_rel_err`` (predicted against measured over
        the measurements) and the per-measurement ``report``; else None."""
        tune_backward = tune_backward or tune_update
        tune = tune or tune_backward
        stats: Optional[Dict[str, Any]] = None
        if tune and self.backend == BACKEND_SFC_CUDA:
            from repro_torch.tune import calibrate, tune_gemm

            calibrate(device=self.device)
            dtype = torch_dtype(self.cfg.param_dtype)
            heads = (self.max_batch, self.cfg.n_heads, self.cfg.kv_heads)
            report: List[Dict[str, Any]] = []
            entries = self.tune_table(prompt_len, backward=tune_backward, update=tune_update)
            for (op, m, n, k) in entries:
                tune_gemm(m, n, k, dtype, op=op, strategy=tune_strategy, report=report, device=self.device,
                          heads=heads if op in ns.ATTN_OPS else None)
            errs = [abs(r["measured_s"] - r["predicted_s"]) / r["measured_s"]
                    for r in report if r.get("predicted_s") and r["measured_s"] > 0]
            stats = {
                "n_namespaces": len(entries),
                "n_measured": len(report),
                "median_rel_err": float(np.median(errs)) if errs else None,
                "report": report,
            }
        tokens = torch.zeros((self.max_batch, prompt_len), dtype=torch.long, device=self.device)
        logits, cache = self._prefill(tokens)
        self._decode(logits.argmax(dim=-1)[:, None], cache)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return stats

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
        obs_metrics.inc("serving.requests", value=len(requests))

        def shed_overdue() -> None:
            now = time.perf_counter()
            for r in [r for r in waiting if r.past_deadline(now)]:
                waiting.remove(r)
                r.status = "timed_out"
                r.done_at = now
                if r.output is None:
                    r.output = []
                self._record_retired(r)
                results.append(r)

        while waiting:
            with span("serving/admission"):
                shed_overdue()
                if not waiting:
                    break
                # group up to max_batch same-length prompts
                length = len(waiting[0].prompt)
                batch = [r for r in waiting if len(r.prompt) == length][: self.max_batch]
                for r in batch:
                    waiting.remove(r)

            tokens = torch.from_numpy(np.stack([r.prompt for r in batch])).long().to(self.device)
            with span("serving/prefill", batch=len(batch)):
                logits, cache = self._run_healed("_prefill", tokens)
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
                with span("serving/decode", step=self._decode_steps):
                    if self._verify_every and self._decode_steps % self._verify_every == 0:
                        logits, cache = self._verified_decode(next_tok, cache)
                    else:
                        logits, cache = self._run_healed("_decode", next_tok, cache)
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
            with span("serving/retire"):
                now = time.perf_counter()
                for r in batch:
                    if not r.done_at:
                        r.status = "completed"
                        r.done_at = now
                    self._record_retired(r)
                results.extend(batch)
        return results

    # ---------------- metrics ----------------

    @staticmethod
    def _record_retired(r: Request) -> None:
        """Emit one request's lifecycle into the obs registry: the
        quantities `latency_report` summarises (TTFT, end-to-end latency,
        per-decoded-token latency) as histograms, as the JAX engine does."""
        obs_metrics.inc("serving." + ("timed_out" if r.status == "timed_out" else "completed"))
        n_tok = len(r.output or [])
        if n_tok:
            obs_metrics.inc("serving.tokens", value=n_tok)
        if r.first_token_at > 0:
            obs_metrics.observe("serving.ttft_us", (r.first_token_at - r.submitted_at) * 1e6)
        else:
            obs_metrics.inc("serving.shed")
        if r.done_at > 0:
            obs_metrics.observe("serving.e2e_us", (r.done_at - r.submitted_at) * 1e6)
        if r.first_token_at > 0 and n_tok > 1:
            obs_metrics.observe("serving.token_us", (r.done_at - r.first_token_at) / (n_tok - 1) * 1e6)

    @staticmethod
    def latency_report(requests: List[Request]) -> Dict[str, Any]:
        """Latency summary with the JAX engine's keys; zeros on an empty
        list.  Requests shed before serving (``first_token_at == 0``) are
        left out of the TTFT statistics and counted in ``n_timed_out``.
        The p50 / p95 / p99 tails come from `obs.metrics.Histogram`, the
        class (and the sample definitions, `_record_retired`) behind the
        ``serving.ttft_us`` / ``serving.token_us`` series."""
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
        hist = obs_metrics.Histogram("latency_report")
        for r in requests:
            if r.first_token_at > 0:
                hist.observe(r.first_token_at - r.submitted_at, kind="ttft")
                n_out = len(r.output or [])
                if n_out > 1:
                    hist.observe((r.done_at - r.first_token_at) / (n_out - 1), kind="token")
        ttft = hist.summary(kind="ttft")
        token = hist.summary(kind="token")
        total = [r.done_at - r.submitted_at for r in requests]
        n_tok = sum(len(r.output or []) for r in requests)
        wall = max(r.done_at for r in requests) - min(r.submitted_at for r in requests)
        return {
            "n_requests": len(requests),
            "n_timed_out": sum(1 for r in requests if r.status == "timed_out"),
            "ttft_mean_s": ttft["mean"],
            "ttft_p50_s": ttft["p50"],
            "ttft_p95_s": ttft["p95"],
            "ttft_p99_s": ttft["p99"],
            "latency_mean_s": float(np.mean(total)),
            "token_p50_s": token["p50"],
            "token_p95_s": token["p95"],
            "token_p99_s": token["p99"],
            "tokens_total": n_tok,
            "tokens_per_s": n_tok / wall if wall > 0 else float("inf"),
        }
