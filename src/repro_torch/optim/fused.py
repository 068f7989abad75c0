"""Grad-and-update fusion: route projection weights into the TN kernel's
update flush, and MoE expert stacks into the grouped TN kernel's (K10),
(the port's ``repro.optim.fused``).

The fused optimizer never writes a routed weight's gradient to device
memory: the TN kernel (K8, or K10 for an (E, K, N) expert stack) computes
dW in its f32 accumulator and applies AdamW in its flush, writing W,
master, mu and nu in place.  The JAX package
threads the optimizer state into the backward pass inside a ``FusedParam``
pytree node and returns the applied update through the cotangent slots.
torch has no cotangent slot to return state through, so here:

  * **routing** is decided by parameter identity: `probe_routed` runs a
    forward of one token under ``torch.no_grad()`` on the "torch" backend
    and counts which ``nn.Parameter`` objects reach `core.gemm_backend`'s
    ``matmul`` / ``glu_matmul`` (op "matmul" / "glu") or ``grouped_matmul``
    / ``grouped_glu_matmul`` (op "grouped" / "grouped_glu") as ``w``
    exactly once with no ``out_scale`` or ``residual`` (the JAX package's
    ``probe_routed``).  A tied head reaches the call site as the view
    ``embed.T``, not as the parameter, so it stays unrouted, as in JAX;
  * **the step's tape** (`FusedSession`) is active while the step's forward
    runs: each routed projection goes through `kernels.ops`'s
    `_UpdateCore` (an expert stack: `_GroupedUpdateCore`; the oracle under
    "torch" / "sfc_reference"), whose backward hands its ``(a, dh, dg)``
    (and the group sizes; oracle: dW) to a `_Slot` of the tape and returns
    no weight gradient.  In the first phase of the exact clip the slot
    launches the TN kernel's (or K10's) norm mode; after the backward,
    `FusedSession.apply` launches its update mode with the exact scale.

ABFT: the norm launch of the first phase and the update launch of the
second run inside the train step's ABFT mode and step scope, so under
"detect" both carry K8's checksum lane (the JAX package checks the update
flush of both of its phases); K10's have no lane, as in JAX.

Self-healing: each norm and update launch runs through the fallback ladder
under ``NS_TN_UPDATE`` (``NS_GROUPED_TN_UPDATE`` for an expert stack), the
kernel, then the JAX package's oracle (dW in plain torch with an f32
accumulator, `kernels.ops.plain_update`).  The update writes W, master,
mu and nu in place, so once it has run nothing is retried or handed to
the oracle (``in_place=True``; the oracle would apply AdamW a second
time): a detection, or any failure after the launch, goes up to the step,
whose rollback restores the state (`train.fault_tolerance.CorruptionPolicy`).

Salts follow the JAX package's ``wrap_routed``: ``(index of the weight's
JAX path in sorted(routed paths) + 1) << 16``, plus the layer index for
the scan-stacked ``layers/...`` leaves, so the port's ``layers.{i}.attn.wq``
salts as JAX's ``layers/attn/wq`` row ``i`` (`convert.jax_leaf_path`), and
``layers.{i}.moe.w_in`` as JAX's (L, E, K, N) ``layers/moe/w_in`` row ``i``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.convert import jax_leaf_path
from repro_torch.kernels.entry import recomputing

__all__ = [
    "FusedUpdateConfig",
    "fused_update_config",
    "current_update_config",
    "default_fused_filter",
    "RoutedLeaf",
    "probe_routed",
    "FusedSession",
    "fused_session",
    "current_session",
    "current_probe",
]


@dataclasses.dataclass(frozen=True)
class FusedUpdateConfig:
    """Settings of the fused update path (contextvar-carried)."""

    stochastic_round: bool = True  # bf16 W write-back rounds stochastically


_UPDATE_CFG: contextvars.ContextVar[Optional[FusedUpdateConfig]] = contextvars.ContextVar(
    "fused_update_config", default=None
)


@contextlib.contextmanager
def fused_update_config(cfg: FusedUpdateConfig):
    tok = _UPDATE_CFG.set(cfg)
    try:
        yield
    finally:
        _UPDATE_CFG.reset(tok)


def current_update_config() -> FusedUpdateConfig:
    return _UPDATE_CFG.get() or FusedUpdateConfig()


def default_fused_filter(name: str, param: torch.Tensor) -> bool:
    """Routing candidates: 2-D weights and 3-D expert stacks not named like
    embeddings (the JAX package's filter, whose 3-D and 4-D scan stacks are
    per-layer 2-D weights and (E, K, N) stacks here); the probe keeps those
    consumed once at a projection call site.  The MoE router stays
    unrouted, as in JAX, whose probe drops it because ``moe_forward`` reads
    its shape outside a call site: its AdamW is the eager one, and the
    other leaves keep JAX's salts."""
    low = name.lower()
    return param.ndim in (2, 3) and "embed" not in low and not low.endswith(".router")


@dataclasses.dataclass(frozen=True)
class RoutedLeaf:
    """Probe verdict for one routed weight."""

    name: str  # the port's parameter name
    path: str  # the JAX package's leaf path ("layers/attn/wq", "head")
    layer: Optional[int]  # the row of a scan-stacked JAX leaf
    op: str  # "matmul" | "glu" | "grouped" | "grouped_glu"
    salt: int


class _Probe:
    """Counts the consumptions of each parameter at the projection call
    sites during the probe forward."""

    def __init__(self):
        self.count: Dict[int, int] = {}
        self.op: Dict[int, str] = {}

    def observe(self, w: torch.Tensor, op: str) -> None:
        self.count[id(w)] = self.count.get(id(w), 0) + 1
        self.op[id(w)] = op


_PROBE: contextvars.ContextVar[Optional[_Probe]] = contextvars.ContextVar("fused_probe", default=None)
_SESSION: contextvars.ContextVar[Optional["FusedSession"]] = contextvars.ContextVar("fused_session", default=None)


def current_probe() -> Optional[_Probe]:
    return _PROBE.get()


def current_session() -> Optional["FusedSession"]:
    return _SESSION.get()


@torch.no_grad()
def probe_routed(
    model: torch.nn.Module,
    *,
    fused_filter: Optional[Callable[[str, torch.Tensor], bool]] = None,
) -> Dict[str, RoutedLeaf]:
    """{name: RoutedLeaf} for every candidate parameter of ``model`` that a
    one-token forward (an encoder-decoder's over one stub frame) brings to a
    projection call site exactly once (a weight consumed twice would need
    two updates).  The forward runs on the "torch" backend with blockwise
    attention, so it launches no kernel."""
    from repro_torch.core.attention_backend import attention_backend
    from repro_torch.core.gemm_backend import gemm_backend

    fused_filter = fused_filter or default_fused_filter
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    one = torch.zeros((1, 1), dtype=torch.long, device=device)
    batch = {"tokens": one, "labels": one}
    cfg = getattr(model, "cfg", None)
    if cfg is not None and cfg.is_encoder_decoder:  # one stub frame for the encoder
        batch["src_embeds"] = torch.zeros((1, 1, cfg.d_model), device=device)
    probe = _Probe()
    tok = _PROBE.set(probe)
    try:
        with gemm_backend("torch"), attention_backend("blockwise"):
            model.loss(batch)
    finally:
        _PROBE.reset(tok)
    chosen = {n: p for n, p in params.items() if fused_filter(n, p) and probe.count.get(id(p)) == 1}
    paths = {n: jax_leaf_path(n) for n in chosen}
    salt_base = {path: (i + 1) << 16 for i, path in enumerate(sorted({path for path, _ in paths.values()}))}
    return {
        n: RoutedLeaf(name=n, path=path, layer=layer, op=probe.op[id(chosen[n])],
                      salt=salt_base[path] + (layer or 0))
        for n, (path, layer) in paths.items()
    }


class _Slot:
    """The tape's record of one routed projection: its weights (one, or
    the GLU's value and gate; 2-D, or (E, K, N) expert stacks) and, after
    the backward, what their update needs: ``(a, dh, dg, group_sizes)`` for
    the kernel (group sizes None for a 2-D weight), or the raw dW for the
    oracle."""

    def __init__(self, session: "FusedSession", leaves: List[RoutedLeaf]):
        self.session = session
        self.leaves = leaves
        self.kernel_args = None
        self.dws: List[Optional[torch.Tensor]] = [None] * len(leaves)
        self.norm_sq: Optional[torch.Tensor] = None

    # the fused path: `_UpdateCore.backward` / `_GroupedUpdateCore.backward`
    # call the slot itself
    def __call__(self, a2d, dh, dg, group_sizes=None) -> None:
        from repro_torch.kernels.ops import sfc_grouped_matmul_tn_norm, sfc_matmul_tn_norm

        self.kernel_args = (a2d, dh, dg, group_sizes)
        if self.session.two_phase:
            def kernel():
                if group_sizes is None:
                    norms = sfc_matmul_tn_norm(a2d, dh, dg)
                else:
                    norms = sfc_grouped_matmul_tn_norm(a2d, dh, group_sizes, dg)
                return norms if dg is None else norms[0] + norms[1]

            def oracle():
                return sum(torch.sum(torch.square(d)) for d in _oracle_dws(a2d, dh, dg, group_sizes))

            self.norm_sq = _update_ladder(kernel, oracle, a2d, dh, group_sizes, in_place=False)

    # the oracle: `_RoutedWeight.backward` of weight ``i`` calls this
    def dw_sink(self, i: int):
        def sink(dw: torch.Tensor) -> None:
            self.dws[i] = dw
        return sink

    def complete(self) -> bool:
        return self.kernel_args is not None or all(d is not None for d in self.dws)

    def phase1_sq(self) -> torch.Tensor:
        if self.kernel_args is None:  # the oracle's norm is its dW's
            return sum(torch.sum(torch.square(d.float())) for d in self.dws)
        return self.norm_sq

    @torch.no_grad()
    def apply(self, hyper: torch.Tensor, stochastic_round: bool) -> torch.Tensor:
        from repro_torch.kernels.ops import plain_update, sfc_grouped_matmul_tn_update, sfc_matmul_tn_update

        state = self.session.state
        params = self.session.params
        sets = [(params[x.name], state["master"][x.name], state["mu"][x.name], state["nu"][x.name])
                for x in self.leaves]
        # the GLU's pair shares the value weight's salt (the JAX package
        # passes w_val.hyper for both); the kernel salts the gate's set once more
        salt = self.leaves[0].salt
        def oracle(dws):
            return sum(plain_update(dw, mst, mu, nu, w, hyper, salt=salt, stochastic_round=stochastic_round)
                       for dw, (w, mst, mu, nu) in zip(dws, sets))

        if self.kernel_args is not None:
            a2d, dh, dg, group_sizes = self.kernel_args
            (w, mst, mu, nu), *rest = sets
            extra = dict(w=w, salt=salt, stochastic_round=stochastic_round)
            if rest:
                w2, mst2, mu2, nu2 = rest[0]
                extra.update(dy2=dg, master2=mst2, mu2=mu2, nu2=nu2, w2=w2)

            def kernel():
                if group_sizes is None:
                    norms = sfc_matmul_tn_update(a2d, dh, mst, mu, nu, hyper, **extra)
                else:
                    norms = sfc_grouped_matmul_tn_update(a2d, dh, group_sizes, mst, mu, nu, hyper, **extra)
                return norms if not rest else norms[0] + norms[1]

            sq = _update_ladder(kernel, lambda: oracle(_oracle_dws(a2d, dh, dg, group_sizes)), a2d, dh,
                                group_sizes, in_place=True)
        else:
            sq = oracle(self.dws)
        self.kernel_args, self.dws = None, [None] * len(self.leaves)
        return sq


def _oracle_dws(a2d, dh, dg, group_sizes) -> List[torch.Tensor]:
    """The f32 dW of each set (the value's, then the gate's) in plain
    torch: the oracle rung of a norm or update flush."""
    from repro_torch.kernels.ops import _torch_grouped_tn, _torch_tn

    dws = _torch_tn(a2d, dh, dg) if group_sizes is None else _torch_grouped_tn(a2d, dh, group_sizes, dg)
    return [dws] if dg is None else list(dws)


def _update_ladder(kernel, oracle, a2d, dh, group_sizes, *, in_place: bool):
    """A norm or update flush under its ladder: ``NS_TN_UPDATE`` (an expert
    stack: ``NS_GROUPED_TN_UPDATE``), the kernel, then the oracle."""
    from repro_torch.core.namespaces import NS_GROUPED_TN_UPDATE, NS_TN_UPDATE, RUNG_SFC_CUDA, RUNG_TORCH
    from repro_torch.kernels.ops import bwd_shape_key
    from repro_torch.robust.ladder import run_with_fallback

    ns = NS_TN_UPDATE if group_sizes is None else NS_GROUPED_TN_UPDATE
    return run_with_fallback(
        ns, ((RUNG_SFC_CUDA, kernel), (RUNG_TORCH, oracle)),
        shape_key=lambda: bwd_shape_key(a2d.shape[-1], dh.shape[-1], a2d.shape[0], a2d.dtype),
        in_place=in_place,
    )


class FusedSession:
    """The tape of one fused train step.  ``routed`` is `probe_routed`'s
    verdict, ``params`` the model's parameters by name, ``state`` the AdamW
    state whose master / mu / nu the updates write.  ``two_phase``: launch
    the norm mode in the backward (the exact clip and the non-finite guard
    need the norm before the update)."""

    def __init__(self, routed: Dict[str, RoutedLeaf], params: Dict[str, torch.Tensor], state, *, two_phase: bool):
        self.routed = routed
        self.params = params
        self.state = state
        self.two_phase = two_phase
        self._by_id = {id(params[n]): leaf for n, leaf in routed.items()}
        self.slots: List[_Slot] = []
        self._slot_of: Dict[str, _Slot] = {}

    def lookup(self, w: torch.Tensor) -> Optional[RoutedLeaf]:
        leaf = self._by_id.get(id(w))
        return leaf if leaf is not None and self.params[leaf.name] is w else None

    def slot(self, *leaves: RoutedLeaf) -> _Slot:
        """The tape's slot of a routed projection.  A remat unit's recomputed
        forward (`kernels.entry.recomputing`) reaches each of its projections
        a second time: it gets the slot the forward's call took, with its
        salts, and adds none (the backward of the forward's graph hands
        ``(a, dh, dg)`` to that slot once)."""
        names = [leaf.name for leaf in leaves]
        if recomputing():
            s = self._slot_of.get(names[0])
            if s is None or [leaf.name for leaf in s.leaves] != names:
                raise RuntimeError(f"a recomputed forward reached routed weights {names} that its forward did not")
            return s
        for name in names:
            if name in self._slot_of:
                raise RuntimeError(f"routed weight {name} reached a projection twice in one step: "
                                   "its update would apply twice")
        s = _Slot(self, list(leaves))
        self.slots.append(s)
        self._slot_of.update((name, s) for name in names)
        return s

    def check_complete(self) -> None:
        """Every routed weight was consumed and its backward reached."""
        done = {leaf.name for s in self.slots if s.complete() for leaf in s.leaves}
        missing = sorted(set(self.routed) - done)
        if missing:
            raise RuntimeError(f"routed weights without an update this step: {missing}")

    def phase1_sq(self) -> torch.Tensor:
        """The routed weights' share of the squared global norm."""
        return sum(s.phase1_sq() for s in self.slots)

    def apply(self, hyper: torch.Tensor) -> torch.Tensor:
        """Launch every slot's update (W, master, mu, nu in place) and free
        its tape; returns the routed share of the squared norm."""
        sr = current_update_config().stochastic_round
        total = sum(s.apply(hyper, sr) for s in self.slots)
        self.slots = []
        return total


@contextlib.contextmanager
def fused_session(session: FusedSession):
    """Route the projections of the routed weights through ``session``
    for the calls made inside the block (the step's forward)."""
    tok = _SESSION.set(session)
    try:
        yield session
    finally:
        _SESSION.reset(tok)
