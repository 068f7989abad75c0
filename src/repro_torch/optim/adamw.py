"""AdamW with f32 master weights, global-norm clipping and LR schedules (the
port's ``repro.optim.adamw``).

The state mirrors the parameters by name: ``{"step": int32 scalar, "mu",
"nu", "master": {name: f32 tensor}}``.  The update is split as in the JAX
package, with its expression order:

  * `adamw_scalars`     — the per-step scalars (lr, bias corrections);
  * `adamw_leaf_update` — the pure elementwise core for one leaf;
  * `adamw_apply`       — that core over every leaf;
  * `adamw_update`      — the global-norm pass, `clip_scale`, `adamw_apply`.

Unlike the JAX package, which returns new arrays, `adamw_apply` writes the
moments, the master weights and the parameters **in place**, leaf by leaf
and in slices of at most ``_CHUNK`` elements: at full width the f32 state
alone is three times the size of the parameters in f32, and a temporary per
leaf of the 389 M-element embedding would be 1.56 GB each.  The
``HYP_*`` lane constants give the layout of the (12,) f32 hyper vector that
the fused TN-update kernel reads (`pack_adamw_hyper`, built on the device
from the step and the clip scale, so no step waits on the host).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Tuple, Union

import torch

__all__ = [
    "HYPER_LEN",
    "AdamWConfig",
    "seed_to_lane",
    "seed_from_lane",
    "pack_adamw_hyper",
    "lr_at",
    "adamw_init",
    "global_norm",
    "clip_scale",
    "adamw_scalars",
    "adamw_leaf_update",
    "adamw_apply",
    "adamw_update",
]

# layout of the fused-update hyperparameter vector (f32 (12,)):
# [lr, b1, 1-b1, b2, 1-b2, eps, weight_decay, b1c, b2c, grad_scale,
#  seed (the int32 step's bit pattern in an f32 lane), salt]
HYPER_LEN = 12
(
    HYP_LR,
    HYP_B1,
    HYP_1MB1,
    HYP_B2,
    HYP_1MB2,
    HYP_EPS,
    HYP_WD,
    HYP_B1C,
    HYP_B2C,
    HYP_SCALE,
    HYP_SEED,
    HYP_SALT,
) = range(HYPER_LEN)

# elements per slice of the in-place update
_CHUNK = 1 << 24

Scalar = Union[torch.Tensor, float]


def seed_to_lane(seed) -> torch.Tensor:
    """int32 seed -> f32 lane of the hyper vector (bit pattern, not value)."""
    return torch.as_tensor(seed).to(torch.int32).view(torch.float32)


def seed_from_lane(lane: torch.Tensor) -> torch.Tensor:
    """f32 hyper lane -> int32 seed (inverse of `seed_to_lane`)."""
    return lane.view(torch.int32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The scheduled learning rate at ``step``, f32: linear warm-up, then
    cosine or linear decay to ``min_lr_ratio`` of ``lr`` (or constant)."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - frac
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def adamw_init(params: Mapping[str, torch.Tensor], *, with_gnorm: bool = False) -> Dict[str, Any]:
    """Zero moments and an f32 copy of every parameter, step 0.  With
    ``with_gnorm`` the state also carries the last global gradient norm
    (f32 scalar): informational only, as in the JAX package, whose fused
    step clips exactly and no longer reads it."""
    device = next(iter(params.values())).device
    with torch.no_grad():
        state = {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()},
            "nu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()},
            "master": {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()},
        }
        if with_gnorm:
            state["gnorm"] = torch.zeros((), dtype=torch.float32, device=device)
    return state


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


def clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor, *, guard_nonfinite: bool = True) -> torch.Tensor:
    """min(1, clip_norm / gnorm), the clip-by-global-norm gradient scale.

    With ``guard_nonfinite`` a NaN/Inf norm binds the scale to exactly 0,
    the skip-update sentinel `adamw_leaf_update` honours; a finite norm
    never gives 0 (clip_norm > 0 and the 1e-9 floor)."""
    s = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    if not guard_nonfinite:
        return s
    return torch.where(torch.isfinite(gnorm), s, torch.zeros_like(s))


def adamw_scalars(cfg: AdamWConfig, step) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lr_t, b1c, b2c) at ``step`` (the post-increment step index)."""
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** _f32(step)
    b2c = 1 - cfg.b2 ** _f32(step)
    return lr, b1c, b2c


def adamw_leaf_update(
    g: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    master: torch.Tensor,
    *,
    lr: Scalar,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    b1c: Scalar,
    b2c: Scalar,
    scale: Scalar,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pure elementwise AdamW core for one leaf -> (mu', nu', master').

    ``scale == 0`` is the skip-update sentinel (`clip_scale`): the incoming
    state comes back bitwise unchanged through a select, so a NaN/Inf
    gradient cannot leak into the moments or the master."""
    skip = torch.as_tensor(scale, device=g.device) == 0.0
    g = g.float() * scale
    mu_n = b1 * mu + (1 - b1) * g
    nu_n = b2 * nu + (1 - b2) * torch.square(g)
    mhat = mu_n / b1c
    nhat = nu_n / b2c
    step_v = mhat / (torch.sqrt(nhat) + eps) + weight_decay * master
    master_n = master - lr * step_v
    # select, not arithmetic: under skip the NaN branch is discarded
    mu_n = torch.where(skip, mu, mu_n)
    nu_n = torch.where(skip, nu, nu_n)
    master_n = torch.where(skip, master, master_n)
    return mu_n, nu_n, master_n


def pack_adamw_hyper(cfg: AdamWConfig, step: torch.Tensor, scale) -> torch.Tensor:
    """(12,) f32 hyper vector of the fused TN-update kernel, on ``step``'s
    device, from tensors only: ``step`` is the post-increment int32 step
    (the bias corrections and the stochastic-rounding seed derive from it;
    the seed lane holds its bit pattern), ``scale`` the gradient scale
    (the clip factor, a device tensor that depends on the global norm).
    The salt lane is 0: each routed weight's salt is an argument of its
    launch (`optim.fused`)."""
    step = torch.as_tensor(step)
    lr, b1c, b2c = adamw_scalars(cfg, step)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=step.device)  # noqa: E731
    return torch.stack([
        f32(lr), f32(cfg.b1), f32(1 - cfg.b1), f32(cfg.b2), f32(1 - cfg.b2), f32(cfg.eps),
        f32(cfg.weight_decay), f32(b1c), f32(b2c), f32(scale).reshape(()),
        seed_to_lane(step.to(torch.int32)), seed_to_lane(torch.zeros((), dtype=torch.int32, device=step.device)),
    ])


@torch.no_grad()
def adamw_apply(
    cfg: AdamWConfig,
    grads: Mapping[str, torch.Tensor],
    state: Dict[str, Any],
    params: Mapping[str, torch.Tensor],
    *,
    scale: Scalar,
    step,
    lr_scale=None,
) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any]]:
    """Elementwise-only AdamW over every leaf with a precomputed gradient
    scale.  Writes ``state``'s mu, nu and master and the parameters in
    place (each parameter gets its new master cast to its type) and
    returns (params, {mu, nu, master}).  ``lr_scale`` multiplies the
    schedule's lr."""
    lr, b1c, b2c = adamw_scalars(cfg, step)
    if lr_scale is not None:
        lr = lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    for name, p in params.items():
        dev = p.device
        hyp = dict(lr=lr.to(dev), b1c=b1c.to(dev), b2c=b2c.to(dev), scale=torch.as_tensor(scale).to(dev), **kw)
        flat = [x.reshape(-1) for x in (grads[name], state["mu"][name], state["nu"][name], state["master"][name])]
        pf = p.view(-1)
        for lo in range(0, pf.numel(), _CHUNK):
            g, mu, nu, mst = (x[lo:lo + _CHUNK] for x in flat)
            mu_n, nu_n, mst_n = adamw_leaf_update(g, mu, nu, mst, **hyp)
            mu.copy_(mu_n)
            nu.copy_(nu_n)
            mst.copy_(mst_n)
            pf[lo:lo + _CHUNK].copy_(mst_n.to(p.dtype))
    return params, {k: state[k] for k in ("mu", "nu", "master")}


def adamw_update(
    cfg: AdamWConfig,
    grads: Mapping[str, torch.Tensor],
    state: Dict[str, Any],
    params: Mapping[str, torch.Tensor],
    *,
    lr_scale=None,
) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, new_state, {"grad_norm", "lr"}).  Params
    keep their type while the update runs on the f32 masters; a nonfinite
    global norm skips the update exactly (scale-0 sentinel)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = clip_scale(cfg, gnorm)
    params, slots = adamw_apply(cfg, grads, state, params, scale=scale, step=step, lr_scale=lr_scale)
    new_state = {"step": step, **slots}
    if "gnorm" in state:
        new_state["gnorm"] = gnorm
    return params, new_state, {"grad_norm": gnorm, "lr": lr_at(cfg, step)}
