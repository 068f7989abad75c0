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
in place (`optim.adamw.adamw_apply`).  Left out: the fused optimizer
(``fused_optimizer=True``, ROADMAP queue 1 item 10), the ABFT lane (item
14) and remat other than "none" (item 18); each raises
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.attention_backend import attention_backend as _attn_backend_ctx
from repro_torch.core.gemm_backend import gemm_backend as _gemm_backend_ctx
from repro_torch.optim.adamw import AdamWConfig, adamw_update

__all__ = ["BackendConfig", "make_train_step", "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Every backend decision of a train/eval step, in one value.

    gemm_backend: projection-GEMM backend pin ("torch" | "sfc_cuda" |
        "sfc_reference"); None inherits the caller's `gemm_backend()`.
    attn_impl: attention backend pin ("blockwise" | "flash_pallas" |
        "sfc"), overriding the model config's value; None inherits.
    fused_optimizer: the fused AdamW flush (item 10); True raises.
    abft: ABFT checksum mode pin (item 14); anything but None or "off"
        raises.
    """

    gemm_backend: Optional[str] = None
    attn_impl: Optional[str] = None
    fused_optimizer: bool = False
    abft: Optional[str] = None


def _backend_ctx(gemm_backend: Optional[str], attn_impl: Optional[str], abft: Optional[str] = None):
    """Stacked backend pins (each may be None = inherit)."""
    if abft not in (None, "off"):
        raise NotImplementedError("the ABFT checksum lane is not ported: ROADMAP queue 1 item 14")
    ctx = contextlib.ExitStack()
    if gemm_backend is not None:
        ctx.enter_context(_gemm_backend_ctx(gemm_backend))
    if attn_impl is not None:
        ctx.enter_context(_attn_backend_ctx(attn_impl))
    return ctx


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    for x in batch.values():
        if x.ndim < 1 or x.shape[0] % k:
            raise ValueError(f"cannot microbatch shape {tuple(x.shape)} by {k}")
    return [{n: x.chunk(k, dim=0)[i] for n, x in batch.items()} for i in range(k)]


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    *,
    remat: str = "none",
    microbatches: int = 1,
    backend: Optional[BackendConfig] = None,
    nonfinite_guard: bool = True,
) -> Callable:
    """Returns ``train_step(opt_state, batch, *, lr_scale=None) ->
    (opt_state, metrics)``, which updates ``model``'s parameters in place.

    ``batch`` holds (B, S) ``tokens`` and ``labels`` on the model's device.
    With ``microbatches > 1`` the batch is cut into that many row slices,
    whose gradients are summed in f32 and averaged, as is the loss.  A
    nonfinite global gradient norm skips the update exactly (the scale-0
    sentinel of `optim.adamw.clip_scale`); as in the JAX package's unfused
    step, ``nonfinite_guard`` only matters to the fused step (item 10).
    ``lr_scale`` (None = 1) multiplies the schedule's lr.
    """
    cfg = backend if backend is not None else BackendConfig()
    if cfg.fused_optimizer:
        raise NotImplementedError(
            "fused_optimizer (AdamW in the TN kernel's flush) is not ported: ROADMAP queue 1 item 10"
        )
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


def make_eval_step(model, *, remat: str = "none", backend: Optional[BackendConfig] = None) -> Callable:
    """Returns ``eval_step(batch) -> loss``, run without gradients."""
    cfg = backend if backend is not None else BackendConfig()

    @torch.no_grad()
    def eval_step(batch):
        with _backend_ctx(cfg.gemm_backend, cfg.attn_impl, cfg.abft):
            return model.loss(batch, remat=remat)

    return eval_step
