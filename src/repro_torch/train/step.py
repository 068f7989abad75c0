"""Train-step builder: loss -> gradients -> AdamW, with microbatch gradient
accumulation (the port's ``repro.train.step``, unfused branch).

``gemm_backend="sfc_cuda"`` runs the whole step on the SFC kernels: the
forward projections on the fused GEMM and, through `kernels.ops`'s
autograd Function, the backward GEMMs on the NT (dA) and TN (dW) kernels;
``attn_impl="sfc"`` runs attention on the band flash forward and its
backward (dQ, dK/dV).  The step sets both for the calls it makes, as the
JAX step pins them at trace time.

The JAX step is a pure function returning new parameters; here the model
holds its parameters and the step updates them, and the optimizer state,
in place (`optim.adamw.adamw_apply`).  ``fused_optimizer=True`` builds the
grad-and-update step (`_make_fused_train_step`): AdamW of every routed
projection weight runs in the TN kernel's flush, and of every routed MoE
expert stack in the grouped TN kernel's (K10).

ABFT (``BackendConfig(abft=)``, `robust.abft`): a step runs its forward,
backward and update inside the mode's context and a step scope, the port's
stand-in for JAX's traced step, so every kernel launch of the step, the
backward and the fused update included, checks its checksum without a host
read, and nothing raises for a mismatch: the caller reads
``runtime_sdc_total()`` after the step, as the JAX package's ``TrainLoop``
does (its rollback is ROADMAP queue 1 item 14).

Remat (``remat``, `models.remat`): the JAX package's default, "dots",
recomputes each layer (each group of the hybrid and xLSTM families) in the
backward, keeping its input and the products of plain torch ops; every
SFC kernel call is recomputed.  The recompute runs in the forward's
context (backends, ABFT state, the fused step's tape), so the fused step's
recomputed projections reuse their slots and each routed weight is
updated once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.attention_backend import attention_backend as _attn_backend_ctx
from repro_torch.core.gemm_backend import gemm_backend as _gemm_backend_ctx
from repro_torch.models.remat import check_policy
from repro_torch.optim import fused as _fused
from repro_torch.optim.adamw import (
    HYP_LR,
    AdamWConfig,
    adamw_apply,
    adamw_update,
    clip_scale,
    lr_at,
    pack_adamw_hyper,
)
from repro_torch.robust.abft import abft_mode, step_scope

__all__ = ["BackendConfig", "make_train_step", "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Every backend decision of a train/eval step, in one value.

    gemm_backend: projection-GEMM backend pin ("torch" | "sfc_cuda" |
        "sfc_reference"); None inherits the caller's `gemm_backend()`.
    attn_impl: attention backend pin ("blockwise" | "flash_pallas" |
        "sfc"), overriding the model config's value; None inherits.
    fused_optimizer: fuse AdamW into the backward for every routed 2-D
        projection weight and (E, K, N) expert stack: the TN kernel's (or
        K10's) flush updates W and its f32 master / mu / nu in place, and
        dW never exists in device memory.
        Requires ``microbatches == 1``.
    stochastic_round: stochastically round bf16 weights in the fused
        flush (ignored unless ``fused_optimizer``).
    abft: ABFT checksum mode pin for the step ("off" | "detect" |
        "strict"); None inherits the caller's `robust.abft.abft_mode`.
        Under "detect" every SFC kernel launch of the step checks its
        checksum (the forward, the NT / TN backward and the fused update
        flush); detections land in the runtime counters at the step's end.
    """

    gemm_backend: Optional[str] = None
    attn_impl: Optional[str] = None
    fused_optimizer: bool = False
    stochastic_round: bool = True
    abft: Optional[str] = None


def _backend_ctx(gemm_backend: Optional[str], attn_impl: Optional[str], abft: Optional[str] = None):
    """Stacked backend pins (each may be None = inherit)."""
    ctx = contextlib.ExitStack()
    if gemm_backend is not None:
        ctx.enter_context(_gemm_backend_ctx(gemm_backend))
    if attn_impl is not None:
        ctx.enter_context(_attn_backend_ctx(attn_impl))
    if abft is not None:
        ctx.enter_context(abft_mode(abft))
    return ctx


def _step_ctx(abft: Optional[str]):
    """A train step's ABFT context, around its forward, backward and update:
    the mode pin (None inherits) and a step scope."""
    ctx = contextlib.ExitStack()
    if abft is not None:
        ctx.enter_context(abft_mode(abft))
    ctx.enter_context(step_scope())
    return ctx


# the batch axis of each batch entry: 0, except the VLM's M-RoPE positions (3, B, S)
_BATCH_AXIS = {"mrope_positions": 1}


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    """``k`` row slices of the batch, each entry cut on its batch axis
    (`_BATCH_AXIS`).  The JAX package cuts an entry on axis 0 where k
    divides it, so there the (3, B, S) positions' (t, h, w) axis when k is
    3; the port always cuts their batch axis."""
    for n, x in batch.items():
        axis = _BATCH_AXIS.get(n, 0)
        if x.ndim <= axis or x.shape[axis] % k:
            raise ValueError(f"cannot microbatch {n} of shape {tuple(x.shape)} by {k}")
    return [{n: x.chunk(k, dim=_BATCH_AXIS.get(n, 0))[i] for n, x in batch.items()} for i in range(k)]


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    *,
    remat: str = "dots",
    microbatches: int = 1,
    backend: Optional[BackendConfig] = None,
    fused_filter: Optional[Callable[[str, torch.Tensor], bool]] = None,
    nonfinite_guard: bool = True,
) -> Callable:
    """Returns ``train_step(opt_state, batch, *, lr_scale=None) ->
    (opt_state, metrics)``, which updates ``model``'s parameters in place.

    ``batch`` holds (B, S) ``tokens`` and ``labels`` on the model's device.
    With ``microbatches > 1`` the batch is cut into that many row slices,
    whose gradients are summed in f32 and averaged, as is the loss.  A
    nonfinite global gradient norm skips the update exactly (the scale-0
    sentinel of `optim.adamw.clip_scale`); as in the JAX package's unfused
    step, ``nonfinite_guard`` only matters to the fused step.
    ``lr_scale`` (None = 1) multiplies the schedule's lr.  ``remat`` is
    the loss's remat policy (`models.remat`; "dots", the JAX package's
    default).

    ``backend.fused_optimizer`` builds the grad-and-update step instead
    (`_make_fused_train_step`); ``fused_filter(name, param) -> bool``
    overrides its routing candidates.
    """
    check_policy(remat)
    cfg = backend if backend is not None else BackendConfig()
    if cfg.fused_optimizer:
        if microbatches != 1:
            raise ValueError(
                "fused_optimizer requires microbatches=1: the in-kernel update applies on every backward "
                "pass, which would run once per microbatch"
            )
        return _make_fused_train_step(model, opt_cfg, remat=remat, cfg=cfg, fused_filter=fused_filter,
                                      nonfinite_guard=nonfinite_guard)
    del nonfinite_guard  # the unfused step always guards
    params = dict(model.named_parameters())

    def loss_fn(batch):
        with _backend_ctx(cfg.gemm_backend, cfg.attn_impl, cfg.abft):
            return model.loss(batch, remat=remat)

    def grads_of(batch):
        for p in params.values():
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in params.items()}

    def train_step(opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor], *, lr_scale=None):
        with _step_ctx(cfg.abft):
            return step(opt_state, batch, lr_scale=lr_scale)

    def step(opt_state, batch, *, lr_scale):
        if microbatches == 1:
            loss, grads = grads_of(batch)
        else:
            loss = 0.0
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
            for mb in _split_microbatches(batch, microbatches):
                l, g = grads_of(mb)
                loss = loss + l
                for n in grads:
                    grads[n] += g[n]
            loss = loss / microbatches
            grads = {n: g / microbatches for n, g in grads.items()}
        for p in params.values():
            p.grad = None  # ``grads`` holds them until the update is done
        _, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state, params, lr_scale=lr_scale)
        del grads
        return opt_state, {"loss": loss, **opt_metrics}

    return train_step


def _make_fused_train_step(model, opt_cfg: AdamWConfig, *, remat: str, cfg: BackendConfig, fused_filter,
                           nonfinite_guard: bool) -> Callable:
    """The grad-and-update step (the JAX package's ``_make_fused_train_step``).

    Routing is probed once, here (`optim.fused.probe_routed`).  Each step
    runs ONE forward and ONE backward with a `FusedSession` active: every
    routed projection's backward launches the NT kernel for dA and records
    ``(a, dh, dg)`` on the session's tape, and no routed weight gets a
    ``.grad``.  Clip-by-global-norm is exact, in two phases as in JAX:

      1. in the backward, the TN kernel's norm mode gives each routed
         weight's ``sum(dW²)``; with the unrouted leaves' raw gradients
         that is the global norm, and ``clip_scale`` (with the non-finite
         guard) the scale;
      2. after the backward, the TN kernel's update mode runs over the tape
         with that scale, and `adamw_apply` updates the unrouted leaves with
         the same scale.

    The JAX step traces the backward a second time for phase 2 and lets
    ``jit`` drop the repeated forward and NT chain; eager torch would run
    them again, so the tape keeps what the update needs instead.  With an
    infinite ``clip_norm`` and the guard off there is one phase: the update
    runs at scale 1 and its norms give ``grad_norm``.

    Expert stacks (the MoE family) take K10 instead of K8: its norm mode
    in phase 1 and its update mode in phase 2, over the (E, K, N) stacks.
    """
    routed = _fused.probe_routed(model, fused_filter=fused_filter)
    params = dict(model.named_parameters())
    unrouted = {n: p for n, p in params.items() if n not in routed}
    two_phase = math.isfinite(opt_cfg.clip_norm) or nonfinite_guard
    device = next(iter(params.values())).device

    def train_step(opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor], *, lr_scale=None):
        with _step_ctx(cfg.abft):
            return fused_step(opt_state, batch, lr_scale=lr_scale)

    def fused_step(opt_state, batch, *, lr_scale):
        step = opt_state["step"] + 1
        session = _fused.FusedSession(routed, params, opt_state, two_phase=two_phase)
        for p in params.values():
            p.grad = None
        with _backend_ctx(cfg.gemm_backend, cfg.attn_impl, cfg.abft), _fused.fused_session(session):
            loss = model.loss(batch, remat=remat)
        loss.backward()
        session.check_complete()
        grads = {n: p.grad for n, p in unrouted.items()}
        for p in unrouted.values():
            p.grad = None  # ``grads`` holds them until the update is done
        zero = torch.zeros((), dtype=torch.float32, device=device)
        unrouted_sq = sum((torch.sum(torch.square(g.float())) for g in grads.values()), zero)
        if two_phase:
            gnorm = torch.sqrt(session.phase1_sq() + unrouted_sq)
            scale = clip_scale(opt_cfg, gnorm, guard_nonfinite=nonfinite_guard)
        else:
            scale = torch.ones((), dtype=torch.float32, device=device)
        hyper = pack_adamw_hyper(opt_cfg, step, scale)
        if lr_scale is not None:
            hyper[HYP_LR] *= torch.as_tensor(lr_scale, dtype=torch.float32)
        with _fused.fused_update_config(_fused.FusedUpdateConfig(stochastic_round=cfg.stochastic_round)):
            routed_sq = session.apply(hyper) + zero
        if not two_phase:
            gnorm = torch.sqrt(routed_sq + unrouted_sq)
        _, slots = adamw_apply(opt_cfg, grads, opt_state, unrouted, scale=scale, step=step, lr_scale=lr_scale)
        del grads
        new_state = {"step": step, **slots}
        if "gnorm" in opt_state:
            new_state["gnorm"] = gnorm  # informational, as in the JAX package
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr_at(opt_cfg, step)}

    return train_step


def make_eval_step(model, *, remat: str = "dots", backend: Optional[BackendConfig] = None) -> Callable:
    """Returns ``eval_step(batch) -> loss``, run without gradients (so
    ``remat`` changes nothing)."""
    cfg = backend if backend is not None else BackendConfig()

    @torch.no_grad()
    def eval_step(batch):
        with _backend_ctx(cfg.gemm_backend, cfg.attn_impl, cfg.abft):
            return model.loss(batch, remat=remat)

    return eval_step
