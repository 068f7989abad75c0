"""Public wrappers around the SFC GEMM kernels (the port's
``repro.kernels.ops``: the forward, the NT/TN backward entry points and the
custom VJP that joins them).

`sfc_matmul` accepts ``(M, K) @ (K, N)``, ``(..., M, K) @ (K, N)`` (shared
weights) and ``(..., M, K) @ (..., K, N)``, validates the operands and the
epilogue, folds the leading dims into one batch axis and launches **one**
fused-epilogue kernel: ``C = act(A@B + bias) * out_scale + residual`` on the
f32 accumulator, one write of C.  `sfc_glu_matmul` is the dual-B gated form
(``act(A@Wg + gate_bias) * (A@Wv + bias)``, one traversal of A).

Ragged M/N/K need no padding here: the CUDA kernels mask their edge tiles
and the plain versions clip them.  Knobs (`resolve_knobs`): on the CPU the
JAX package's order, the tune cache (`repro_torch.tune`) and then
`pick_blocks` with the perf model's ``choose_knobs_analytical``; on the
card the kernels' compiled tile, the K knobs from the cache or 1, and the
launch the cache holds for the namespace (``Knobs.launch``, keyed by the
rows the kernel runs: a shared weight's batch folded in) in place of the
kernel's rule; `knob_defaults` fills the K knobs for a block of calls.
The fused kernel
loops over the whole K range inside one CTA, so its plan always fits: the
JAX package's VMEM check (``ensure_fused_fits``) and the fallback it
guards have no counterpart here.

The replicated 2.5D form.  ``fuse=False`` is the JAX package's unfused
path, the paper's own scheme: `sfc_gemm_replicated` (K4, K5 for a batched
A) writes the (k_layers, M, N) partial copies of A @ B, one per layer's K
slab, in the output type; `add_reduce` (K6) sums them in f32 when
``k_layers > 1`` (copy 0 is the result otherwise, and K6 is not launched);
the epilogue then runs in f32 on the result and casts once
(`_replicated_impl`, JAX: ``_epilogue_jnp``).  The GLU is two such
products with f32 copies, then ``act(gate + gate_bias) * (val + bias)``
in f32.  On the card the layers are split-K across the SMs.  Its backward
is the fused form's (the NT/TN kernels), as in the JAX package.

Training.  When grad mode is on and an input needs a gradient,
`sfc_matmul` and `sfc_glu_matmul` run through `_MatmulCore`, a
``torch.autograd.Function`` (JAX: ``_matmul_core``'s custom VJP).  Its
forward is JAX's training forward: a linear epilogue is the one fused
launch; an activation is a linear launch, then the activation in f32; a GLU
is one ``preact`` launch (both biased pre-activations), then ``act(g)·h``
in f32.  Its backward computes the f32 epilogue cotangents
(`_epilogue_cotangents`), casts them to the compute type, and launches the
NT kernel for dA (`sfc_matmul_nt`, dual for the GLU) and the TN kernel for
dW (`sfc_matmul_tn`, dual for the GLU); bias gradients are sums, the
residual's passes straight through.  Under ``torch.no_grad`` (serving) the
calls keep the single fused launch with the activation in the flush.  On
CPU tensors every launch is its kernel's plain version, so the CPU runs the
same NT/TN structure as the card.

The fused optimizer.  `sfc_matmul_tn_update` is the TN kernel in its update
mode (dW and AdamW in one flush, the weight and its f32 state written in
place) and `sfc_matmul_tn_norm` in its norm mode.  `_UpdateCore` is the
autograd Function of a projection whose weight the fused optimizer routes
(JAX: ``_update_core``): its forward is `_MatmulCore`'s; its backward runs
the NT kernel for dA, hands ``(a, dh, dg)`` to the step's tape (which runs
the norm mode in the first phase of the exact clip and the update mode
after the backward) and returns no weight gradient.  Under the "torch" and
"sfc_reference" backends a routed weight takes the JAX package's oracle
instead (`fused_update_matmul(..., fused=False)`): plain autograd dW, handed
to the tape through `_RoutedWeight`, then the same AdamW program
(`plain_update`).

The grouped (MoE expert) forms.  `sfc_grouped_matmul` and
`sfc_grouped_glu_matmul` run every expert's ``epilogue(a[rows of e] @
b[e])`` in one launch of the grouped kernel (K3), the rows of each expert
packed and unpadded; `sfc_grouped_matmul_nt` (K9) and
`sfc_grouped_matmul_tn` (K10) are their dA and dW.  `_GroupedCore` is the
grouped autograd Function (JAX: ``_grouped_core``), built as `_MatmulCore`
is: the GLU forward in ``preact`` mode, the backward on K9 and K10, bias
gradients as per-expert sums.  The fused optimizer's grouped forms follow
the dense ones: `sfc_grouped_matmul_tn_update` / `_norm` are K10's update
and norm modes over (E, K, N) stacks, `_GroupedUpdateCore` hands ``(a, dh,
dg, group_sizes)`` to the step's tape, and `fused_update_grouped_matmul` /
`fused_update_grouped_glu_matmul` keep the JAX package's oracle
(``fused=False``) for the other backends.

ABFT (`robust.abft`).  Every entry point checks its product against the
operand-side checksum when its namespace's mode is not "off" (an explicit
``abft`` pins it; None resolves it from the ambient `abft_mode`, the
namespace the JAX package's): the fused forward (``NS_GEMM`` / ``NS_GLU``,
``preact`` and batched included), the grouped forward (``NS_GROUPED`` /
``NS_GROUPED_GLU``), TN (``NS_TN(_DUAL)``) and TN update (``NS_TN_UPDATE
(_DUAL)``, its norm mode, the first phase of the fused step's clip, too,
as JAX's first phase is an update flush) run their kernel's checksum lane;
the replicated form and NT (K7) have no lane, so their check is op-level,
on the sum of the output they cast (``cast_dtype``: the port's NT writes
the compute type, JAX's f32, so bf16's rounding enters its tolerance).
K9, K10 and the add-reduce of the unfused GLU have no check, as in JAX.
`_VjpCfg.abft` pins the forward only; the backward launches resolve from
the ambient mode of the forward, which the autograd Functions carry to
their backward (on the card autograd runs it on a thread of its own).
Self-healing.  The backward launches run at backward time, far from the
forward's ladder in `core.gemm_backend`, so a failure there degrades here,
as in the JAX package: each NT, TN, grouped NT and grouped TN launch of
the autograd Functions has a two-rung ladder (`robust.run_with_fallback`),
the kernel, then a plain torch contraction with an f32 accumulator, the
math the kernel performs (`_nt_with_fallback`, `_tn_with_fallback`,
`_grouped_nt_with_fallback`, `_grouped_tn_with_fallback`).  The fused
optimizer's norm and update flushes have theirs in `optim.fused` (the
oracle: `_torch_tn` dW and `plain_update`).  A mismatch outside a step
scope raises `SdcDetected`, which these ladders retry once on the kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.namespaces import (
    NS_GEMM,
    NS_GLU,
    NS_GROUPED,
    NS_GROUPED_GLU,
    NS_GROUPED_NT,
    NS_GROUPED_TN,
    NS_NT,
    NS_NT_DUAL,
    NS_TN,
    NS_TN_DUAL,
    NS_TN_UPDATE,
    NS_TN_UPDATE_DUAL,
    RUNG_SFC_CUDA,
    RUNG_TORCH,
)
from repro_torch.kernels.sfc_gemm import (
    _epilogue,
    activation_fn,
    add_reduce,
    check_preact,
    grouped_tn_row_block,
    kernel_tile,
    sfc_gemm_fused,
    sfc_gemm_replicated,
    sfc_gemm_grouped,
    sfc_gemm_grouped_nt,
    sfc_gemm_grouped_tn,
    sfc_gemm_nt,
    sfc_gemm_tn,
    stochastic_round_to,
    tile_random_bits,
)
from repro_torch.robust import abft as _abft
from repro_torch.robust.ladder import run_with_fallback
from repro_torch.tune.tuner import default_cache, lookup_knobs

__all__ = [
    "sfc_matmul",
    "sfc_glu_matmul",
    "sfc_matmul_nt",
    "sfc_matmul_tn",
    "sfc_matmul_tn_norm",
    "sfc_matmul_tn_update",
    "plain_update",
    "fused_update_matmul",
    "fused_update_glu_matmul",
    "sfc_grouped_matmul",
    "sfc_grouped_glu_matmul",
    "sfc_grouped_matmul_nt",
    "sfc_grouped_matmul_tn",
    "sfc_grouped_matmul_tn_norm",
    "sfc_grouped_matmul_tn_update",
    "fused_update_grouped_matmul",
    "fused_update_grouped_glu_matmul",
    "bwd_shape_key",
    "pick_blocks",
    "knob_defaults",
    "ResolvedKnobs",
    "resolve_knobs",
    "reference_knobs",
    "chunk_gemm_plan",
]


def pick_blocks(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """(bm, bn, bk): the largest of 256, 128, ..., 8 that divides each
    extent, else the extent itself."""

    def pick(dim: int) -> int:
        for cand in (256, 128, 64, 32, 16, 8):
            if dim % cand == 0:
                return cand
        return dim

    return pick(m), pick(n), pick(k)


_KNOB_DEFAULTS: contextvars.ContextVar[Tuple[Optional[int], Optional[int]]] = contextvars.ContextVar(
    "sfc_knob_defaults", default=(None, None)
)


@contextlib.contextmanager
def knob_defaults(*, k_layers: Optional[int] = None, k_block_factor: Optional[int] = None):
    """Values for the K knobs that the calls inside the block leave unset
    (a call's own knobs win, and these win over the tune cache): how a
    caller runs, say, every product of a serve on the replicated backend at
    ``k_layers=8``."""
    for name, val in (("k_layers", k_layers), ("k_block_factor", k_block_factor)):
        if val is not None and val < 1:
            raise ValueError(f"{name} must be at least 1, got {val}")
    tok = _KNOB_DEFAULTS.set((k_layers, k_block_factor))
    try:
        yield
    finally:
        _KNOB_DEFAULTS.reset(tok)


class ResolvedKnobs(tuple):
    """A resolver's knobs, equal to the JAX package's tuple (`resolve_knobs`'
    ``(bm, bn, k_layers, k_block_factor)``, `resolve_attn_knobs`'
    ``(q_chunk, k_chunk)``), and ``launch``: the launch configuration the
    card's kernel takes in place of its rule (None: the rule's)."""

    def __new__(cls, values, launch: Optional[dict] = None):
        self = super().__new__(cls, values)
        self.launch = launch
        return self


def resolve_knobs(
    m: int,
    n: int,
    k: int,
    device,
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    dtype=None,
    op: str = NS_GEMM,
) -> ResolvedKnobs:
    """(bm, bn, k_layers, k_block_factor) for one launch of namespace
    ``op`` (the JAX package's ``resolve_knobs``), with ``.launch``.

    A call's own knobs win, then `knob_defaults`' K knobs; when one is
    still unset and ``dtype`` is given, the tune cache's entry for the
    shape bucket (`repro_torch.tune.lookup_knobs`, backend "cpu" or "gpu"
    by ``device``; a failed lookup raises).  On the CPU the rest is the JAX
    package's fallback: `pick_blocks` and ``choose_knobs_analytical(...,
    hw=TPU_V5E)`` for one worker, so the knobs equal the JAX package's for
    every shape.  On a CUDA device the tile is the kernels' compiled one
    (an explicit other ``bm``/``bn`` is an error), unset K knobs are 1, and
    ``.launch`` is the cache entry's: the kernel wrappers take it over
    their rules (the wgmma tile and worker group, the cluster kernel's K
    layers, the TN group), and with no entry every launch is the rule's.
    The fused kernels ignore the K knobs on the card; the replicated form's
    grid is ``k_layers`` times its tile count.

    A call that leaves every knob to the cache is answered once per exact
    (m, n, k, dtype, op, device) and cache state (`KnobCache.resolved`)."""
    d_layers, d_kbf = _KNOB_DEFAULTS.get()
    cache = None
    if dtype is not None and bm is None and bn is None and k_layers is None and k_block_factor is None:
        cache = default_cache()
        if d_layers is None and d_kbf is None:
            memo = (m, n, k, dtype, op, device)
            hit = cache.resolved.get(memo)
            if hit is None:
                hit = cache.resolved[memo] = _resolve_knobs(m, n, k, device, None, None, None, None, dtype, op,
                                                            cache)
            return hit
    elif dtype is not None and None in (bm, bn, k_layers or d_layers, k_block_factor or d_kbf):
        cache = default_cache()
    return _resolve_knobs(m, n, k, device, bm, bn, k_layers or d_layers, k_block_factor or d_kbf, dtype, op, cache)


def _resolve_knobs(m, n, k, device, bm, bn, k_layers, k_block_factor, dtype, op, cache) -> ResolvedKnobs:
    """`resolve_knobs` past the defaults; ``cache`` None: no lookup."""
    cached = None
    if cache is not None and None in (bm, bn, k_layers, k_block_factor):
        cached = lookup_knobs(m, n, k, dtype, cache=cache, op=op, device=device)
    if torch.device(device).type == "cuda":
        tile = kernel_tile()
        if (bm or tile[0], bn or tile[1]) != tile:
            raise ValueError(f"the CUDA kernel is compiled for (bm, bn)={tile}, got {(bm, bn)}")
        launch = None
        if cached is not None:
            k_layers, k_block_factor = k_layers or cached.k_layers, k_block_factor or cached.k_block_factor
            launch = cached.launch
        return ResolvedKnobs((*tile, k_layers or 1, k_block_factor or 1), launch)
    if cached is not None:
        bm, bn = bm or cached.bm, bn or cached.bn
        k_layers, k_block_factor = k_layers or cached.k_layers, k_block_factor or cached.k_block_factor
    if bm is None or bn is None:
        pbm, pbn, _ = pick_blocks(m, n, k)
        bm = bm or pbm
        bn = bn or pbn
    if k_layers is None or k_block_factor is None:
        # one worker: the JAX package's kernel runs on one TensorCore
        from repro_torch.core.perf_model import TPU_V5E, choose_knobs_analytical

        c, kbf = choose_knobs_analytical(max(m, bm), max(n, bn), max(k, 1), 1, bm=bm, bn=bn, hw=TPU_V5E)
        k_layers, k_block_factor = k_layers or c, k_block_factor or kbf
    return ResolvedKnobs((bm, bn, k_layers, k_block_factor))


def chunk_gemm_plan(m: int, n: int, k: int, dtype, *, device=None):
    """Tune namespace and knobs of one batched intra-chunk GEMM (the
    chunked-recurrence einsums of `core.gemm_backend.chunk_einsum`; the JAX
    package's ``kernels.ops.chunk_gemm_plan``): ``(namespace, knobs)``.

    The namespace is the base "gemm" qualified by the compiled
    ``gemm_spec(mb, nb, k_layers)`` key of the padded tile grid that the
    host's knobs fix (`resolve_knobs` on the CPU under "gemm": the tune
    cache, else `pick_blocks` and the analytical model, as the JAX
    package's), through `namespaces.schedule_namespace`: ``"gemm@<key>"``,
    the JAX package's string for every shape.  The namespace names the tile
    space, not the device, so it is the same for a call on the card.  The
    knobs then re-resolve under it (a winner in the schedule's own bucket
    overrides the base choice): ``bm``/``bn``/``k_layers``/
    ``k_block_factor`` for `sfc_matmul` on ``device`` (the CPU when None;
    on the card the kernels' compiled tile, and the launch their rules
    choose, since the knobs are explicit)."""
    from repro_torch.core.namespaces import schedule_namespace
    from repro_torch.core.schedule import compile_schedule, gemm_spec

    bm, bn, kl, kbf = resolve_knobs(m, n, k, torch.device("cpu"), dtype=dtype)
    sched = compile_schedule(gemm_spec(math.ceil(m / bm), math.ceil(n / bn), kl))
    namespace = schedule_namespace(NS_GEMM, sched.key)
    bm, bn, kl, kbf = resolve_knobs(m, n, k, torch.device("cpu" if device is None else device), dtype=dtype,
                                    op=namespace)
    return namespace, dict(bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf)


@functools.lru_cache(maxsize=4096)
def bwd_shape_key(m: int, n: int, k: int, dtype) -> str:
    """The shape class of a GEMM launch (the JAX package's
    ``_bwd_shape_key``, and its ``gemm_backend._shape_key``, the same
    formula: its ladder's quarantine key): the tune cache's bucket of (M,
    N, K), each at least 1, and the dtype's name.  Memoised."""
    from repro_torch.tune.cache import dtype_name, shape_bucket

    bm_, bn_, bk_ = shape_bucket(max(m, 1), max(n, 1), max(k, 1))
    return f"{bm_}x{bn_}x{bk_}|{dtype_name(dtype)}"


def _divisor_block(dim: int, cap: int) -> int:
    """Largest aligned block <= cap that divides dim, else the dim itself
    (the reference loop does not pad)."""
    for cand in (256, 128, 64, 32, 16, 8):
        if cand <= cap and dim % cand == 0:
            return cand
    return dim


def reference_knobs(m: int, n: int, k: int, dtype=None, op: str = NS_GEMM) -> Tuple[int, int, int, int, int]:
    """(bm, bn, bk, k_layers, k_block_factor) for `sfc_ca_gemm_reference`,
    the JAX package's: the knobs `resolve_knobs` gives on the CPU (the tune
    cache under ``op`` when ``dtype`` is given, else `pick_blocks` and the
    analytical model), each block clipped to a divisor of its extent, and
    the K knobs dropped to (1, 1) when K's block count cannot hold them."""
    bm, bn, k_layers, k_block_factor = resolve_knobs(m, n, k, torch.device("cpu"), dtype=dtype, op=op)
    bm, bn = _divisor_block(m, bm), _divisor_block(n, bn)
    _, _, bk = pick_blocks(m, n, k)
    if max(k // bk, 1) % (k_layers * k_block_factor):
        k_layers = k_block_factor = 1
    return bm, bn, bk, k_layers, k_block_factor


def _mode(abft: Optional[str], namespace: str) -> str:
    """The ABFT mode of a call: its own ``abft``, else the ambient one of its
    namespace."""
    return abft if abft is not None else _abft.current_mode(namespace)


def _matmul_impl(
    a: torch.Tensor,
    b: torch.Tensor,
    b_gate: Optional[torch.Tensor],
    *,
    bias: Optional[torch.Tensor],
    gate_bias: Optional[torch.Tensor],
    residual: Optional[torch.Tensor],
    activation: Optional[str],
    out_scale: Optional[float],
    bm: Optional[int],
    bn: Optional[int],
    k_layers: Optional[int],
    k_block_factor: Optional[int],
    out_dtype: Optional[torch.dtype],
    fuse: Optional[bool] = None,
    preact: bool = False,
    abft: Optional[str] = None,
) -> torch.Tensor:
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"sfc_matmul needs matrices, got {tuple(a.shape)} @ {tuple(b.shape)}")

    glu = b_gate is not None
    lead = tuple(a.shape[:-2])
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    b_batched = b.ndim > 2
    if b_batched and tuple(b.shape[:-2]) != lead:
        raise ValueError(f"batch dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if glu:
        if b_gate.ndim != 2 or tuple(b_gate.shape) != tuple(b.shape[-2:]):
            raise ValueError(
                f"GLU gate weights must be (K, N)={tuple(b.shape[-2:])}, got {tuple(b_gate.shape)}"
            )
        if b_batched:
            raise ValueError("GLU form requires shared 2-D value weights")
    for name, vec in (("bias", bias), ("gate_bias", gate_bias)):
        if vec is not None and tuple(vec.shape) not in ((n,), (1, n)):
            raise ValueError(f"{name} must be (N,) or (1, N) with N={n}, got {tuple(vec.shape)}")
    if residual is not None and tuple(residual.shape) != (*lead, m, n):
        raise ValueError(f"residual shape {tuple(residual.shape)} != output {(*lead, m, n)}")

    op = NS_GLU if glu else NS_GEMM
    bsz = math.prod(lead)
    # On the card a shared weight's batch folds into the rows of one launch
    # (`sfc_gemm_fused`), and the tune cache is keyed, and its winners
    # measured, by the rows the kernel runs; a per-batch weight walks its
    # batch as a grid axis, a launch the tuner does not time, so it keeps
    # the rule.  On the CPU the key is the JAX package's, M a batch element.
    rows, tuned = m, True
    if a.device.type == "cuda" and lead:
        rows, tuned = (m, bsz == 1) if b_batched else (bsz * m, True)
    resolved = resolve_knobs(rows, n, k, a.device, bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
                             dtype=a.dtype if tuned else None, op=op)
    bm, bn, k_layers, k_block_factor = resolved
    gate = None if b_gate is None else b_gate.contiguous()
    vecs = [None if v is None else v.contiguous() for v in (bias, gate_bias)]
    # fold leading dims into one batch axis for the kernel grid
    a_run = a.reshape(bsz, m, k).contiguous() if lead else a.contiguous()
    b_run = b.reshape(bsz, k, n).contiguous() if b_batched else b.contiguous()
    res_run = None if residual is None else residual.reshape(a_run.shape[:-1] + (n,)).contiguous()
    knobs = dict(bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor)
    mode = _mode(abft, op)
    if fuse is False:
        check_preact(preact, b_gate, activation, out_scale, residual)
        out = _replicated_impl(a_run, b_run, gate, *vecs, res_run, activation=activation, out_scale=out_scale,
                               knobs=knobs, out_dtype=out_dtype or a.dtype, preact=preact, mode=mode)
    else:
        out = sfc_gemm_fused(a_run, b_run, gate, *vecs, res_run, activation=activation, out_scale=out_scale,
                             out_dtype=out_dtype, preact=preact, abft=mode != "off", launch=resolved.launch, **knobs)
        if mode != "off":
            *outs, chk = out
            out = tuple(outs) if preact else outs[0]
            ref, mag = _abft.gemm_checksum_ref(a_run, b_run, gate)
            out = _abft.verify(op, out, chk, ref, mag, contract_dim=k, mode=mode)
    if preact:
        return tuple(o.reshape(*lead, m, n) for o in out)
    return out.reshape(*lead, m, n)


def _replicated_impl(a, b, b_gate, bias, gate_bias, residual, *, activation, out_scale, knobs, out_dtype, preact,
                     mode="off"):
    """The JAX package's ``fuse=False`` branch of ``_matmul_impl`` on the
    kernel's operands (``a`` (M, K) or (B, M, K), folded and contiguous):
    the partial copies (K4 / K5) in ``out_dtype``, their sum (K6) when
    ``k_layers > 1``, then the epilogue in f32 and one cast.  The GLU is two
    products with f32 copies and its epilogue (``preact``: the two biased
    pre-activations, each cast to ``out_dtype``).  ``knobs`` are resolved.
    ABFT (``mode``): the op-level check of each product under ``NS_GEMM``,
    the f32 sum of its reduced copies (the raw accumulator cast to the
    copies' type, before the epilogue) against the operand checksum, with
    that type's rounding in the tolerance, as in JAX."""
    if b_gate is not None:
        val, gate = (_replicated_impl(a, w, None, None, None, None, activation=None, out_scale=None, knobs=knobs,
                                      out_dtype=torch.float32, preact=False, mode=mode) for w in (b, b_gate))
        if preact:
            if bias is not None:
                val = val + bias.reshape(-1).float()
            if gate_bias is not None:
                gate = gate + gate_bias.reshape(-1).float()
            return val.to(out_dtype), gate.to(out_dtype)
        return _epilogue(val, gate, bias, gate_bias, residual, activation, out_scale).to(out_dtype)
    copies = sfc_gemm_replicated(a, b, out_dtype=out_dtype, **knobs)
    c = add_reduce(copies) if knobs["k_layers"] > 1 else copies.select(-3, 0)
    if bias is None and activation is None and out_scale is None and residual is None:
        res = c  # no epilogue term: its f32 round trip of the copies' type is exact
    else:
        res = _epilogue(c.float(), None, bias, None, residual, activation, out_scale).to(out_dtype)
    if mode != "off":
        ref, mag = _abft.gemm_checksum_ref(a, b)
        res = _abft.verify(NS_GEMM, res, c.sum(dtype=torch.float32), ref, mag, contract_dim=a.shape[-1], mode=mode,
                           cast_dtype=out_dtype)
    return res


# ---------------------------------------------------------------------------
# backward (NT / TN) entry points
# ---------------------------------------------------------------------------


def sfc_matmul_nt(
    a: torch.Tensor,  # (..., M, K)
    b: torch.Tensor,  # (N, K): consumed as bᵀ, no transposed copy
    a2: Optional[torch.Tensor] = None,  # (..., M, K) second addend
    b2: Optional[torch.Tensor] = None,  # (N, K)
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    abft: Optional[str] = None,
) -> torch.Tensor:
    """C = A @ Bᵀ (+ A2 @ B2ᵀ) through the SFC NT kernel: the dA backward
    GEMM (``dA = dC @ Wᵀ``; the dual form is the GLU's ``dg·Wgᵀ + dh·Wvᵀ``
    in one traversal).  Leading batch dims of ``a`` fold into M (the (N, K)
    operand is shared); ragged shapes are masked by the kernel and clipped
    by its plain version, not padded.  Knobs resolve as `resolve_knobs`
    does for the forward.  ABFT: an op-level check under ``NS_NT(_DUAL)``
    (K7 has no lane), the f32 sum of the output against the operand
    checksum, the output type's rounding in the tolerance."""
    if a.ndim < 2 or b.ndim != 2 or a.shape[-1] != b.shape[-1]:
        raise ValueError(f"sfc_matmul_nt needs a (..., M, K) and b (N, K); got {tuple(a.shape)}, {tuple(b.shape)}")
    if (a2 is None) != (b2 is None) or (a2 is not None and tuple(a2.shape) != tuple(a.shape)):
        raise ValueError("the dual form needs a2 shaped like a and b2 shaped like b")
    lead = tuple(a.shape[:-2])
    a2d = a.reshape(-1, a.shape[-1]).contiguous()
    a22d = None if a2 is None else a2.reshape(-1, a2.shape[-1]).contiguous()
    m, k = a2d.shape
    n = b.shape[0]
    ns = NS_NT if a2 is None else NS_NT_DUAL
    resolved = resolve_knobs(m, n, k, a.device, bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
                             dtype=a.dtype, op=ns)
    bm, bn, kl, kbf = resolved
    out = sfc_gemm_nt(a2d, b.contiguous(), a22d, None if b2 is None else b2.contiguous(),
                      bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf, out_dtype=out_dtype, launch=resolved.launch)
    res = out.reshape(*lead, a.shape[-2], n)
    mode = _mode(abft, ns)
    if mode != "off":
        ref, mag = _abft.nt_checksum_ref(a2d, b)
        if a2 is not None:
            r2, m2 = _abft.nt_checksum_ref(a22d, b2)
            ref, mag = ref + r2, mag + m2
        res = _abft.verify(ns, res, out.sum(dtype=torch.float32), ref, mag, contract_dim=k, mode=mode,
                           cast_dtype=out.dtype)
    return res


def sfc_matmul_tn(
    a: torch.Tensor,  # (..., M, K): consumed as aᵀ, no transposed copy
    b: torch.Tensor,  # (..., M, N)
    b2: Optional[torch.Tensor] = None,  # (..., M, N) second operand
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    abft: Optional[str] = None,
):
    """C = Aᵀ @ B (and Aᵀ @ B2) through the SFC TN kernel: the dW backward
    GEMM (``dW = Aᵀ @ dC``); with ``b2`` one traversal of the activations
    flushes both weight grads (the GLU's dWv, dWg pair).  Leading batch
    dims fold into the contraction (the weight grad sums over them).
    Returns (K, N), or a pair with ``b2``.  ABFT under ``NS_TN(_DUAL)``: the
    kernel's checksum lane, one check per operand set."""
    a2d, b2d, b22d = _tn_operands(a, b, b2)
    m, k = a2d.shape
    # the output is (K, N); the contraction runs over M
    ns = NS_TN if b2 is None else NS_TN_DUAL
    resolved = resolve_knobs(k, b2d.shape[1], m, a.device, bm=bm, bn=bn, k_layers=k_layers,
                             k_block_factor=k_block_factor, dtype=a.dtype, op=ns)
    bm, bn, kl, kbf = resolved
    mode = _mode(abft, ns)
    out = sfc_gemm_tn(a2d, b2d, b22d, bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf, out_dtype=out_dtype,
                      abft=mode != "off", launch=resolved.launch)
    if mode == "off":
        return out
    *outs, chk = out
    return _verify_tn(ns, tuple(outs) if b2 is not None else outs[0], chk, a2d, b2d, b22d, mode)


def _verify_tn(ns, res, chk, a2d, b2d, b22d, mode):
    """The TN lane's checks, one per operand set: ``chk`` (n_sets, 1)
    against ``Aᵀ @ B``'s (and ``Aᵀ @ B2``'s) operand checksum."""
    for s, bs in enumerate((b2d,) if b22d is None else (b2d, b22d)):
        ref, mag = _abft.tn_checksum_ref(a2d, bs)
        res = _abft.verify(ns, res, chk[s, 0], ref, mag, contract_dim=a2d.shape[0], mode=mode)
    return res


def _tn_operands(a, dy, dy2):
    """The TN operands as 2-D contiguous matrices, leading dims folded into
    the contraction's M rows."""
    a2d = a.reshape(-1, a.shape[-1]).contiguous()
    b2d = dy.reshape(-1, dy.shape[-1]).contiguous()
    b22d = None if dy2 is None else dy2.reshape(-1, dy2.shape[-1]).contiguous()
    if b2d.shape[0] != a2d.shape[0] or (b22d is not None and b22d.shape != b2d.shape):
        raise ValueError(f"TN row mismatch: {tuple(a.shape)}, {tuple(dy.shape)}")
    return a2d, b2d, b22d


def sfc_matmul_tn_norm(
    a: torch.Tensor,  # (..., M, K) forward activations (leading dims fold)
    dy: torch.Tensor,  # (..., M, N) output cotangent
    dy2: Optional[torch.Tensor] = None,  # (..., M, N) second cotangent (GLU)
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
):
    """``sum(dW²)`` of ``dW = Aᵀ @ dY`` (and of ``Aᵀ @ dY2``) from the TN
    kernel's norm mode: dW stays in the f32 accumulator.  The first phase
    of the fused step's exact clip (the JAX package runs the update flush at
    scale 1 and keeps only its norm tokens).  Returns an f32 scalar, or a
    pair with ``dy2``.  ABFT: the kernel's checksum lane, checked under
    ``NS_TN_UPDATE(_DUAL)``, as the JAX package checks its first phase's
    update flush."""
    a2d, b2d, b22d = _tn_operands(a, dy, dy2)
    m, k = a2d.shape
    ns = NS_TN_UPDATE if dy2 is None else NS_TN_UPDATE_DUAL
    resolved = resolve_knobs(k, b2d.shape[1], m, a.device, bm=bm, bn=bn, k_layers=k_layers,
                             k_block_factor=k_block_factor, dtype=a.dtype, op=ns)
    bm, bn, kl, kbf = resolved
    mode = _mode(None, ns)
    norms = sfc_gemm_tn(a2d, b2d, b22d, norm=True, bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf,
                        abft=mode != "off", launch=resolved.launch)
    if mode != "off":
        norms, chk = norms
        norms = _verify_tn(ns, norms, chk, a2d, b2d, b22d, mode)
    return norms[0] if dy2 is None else (norms[0], norms[1])


def sfc_matmul_tn_update(
    a: torch.Tensor,  # (..., M, K) forward activations (leading dims fold)
    dy: torch.Tensor,  # (..., M, N) output cotangent
    master: torch.Tensor,  # (K, N) f32 master weights, updated in place
    mu: torch.Tensor,  # (K, N) f32, in place
    nu: torch.Tensor,  # (K, N) f32, in place
    hyper: torch.Tensor,  # (12,) f32 `optim.adamw.pack_adamw_hyper` vector
    dy2: Optional[torch.Tensor] = None,  # (..., M, N) second cotangent (GLU)
    master2: Optional[torch.Tensor] = None,
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    *,
    w: torch.Tensor,  # (K, N) the weight, in a's type, written in place
    w2: Optional[torch.Tensor] = None,
    salt: int = 0,
    stochastic_round: bool = False,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    abft: Optional[str] = None,
):
    """Fused dW-and-AdamW: one TN launch computes ``dW = Aᵀ @ dY`` in the
    f32 accumulator and applies the update in its flush, writing W (and
    its f32 master, mu and nu) in place; dW never reaches device memory.
    Returns ``sum(dW²)`` before the scale (an f32 scalar, or a pair with
    ``dy2``, whose set is (w2, master2, mu2, nu2)).  The JAX package's
    ``sfc_matmul_tn_update`` returns the new arrays instead; its hyper
    vector carries the salt, here ``salt`` does.

    ABFT under ``NS_TN_UPDATE(_DUAL)``: the kernel's checksum lane, the raw
    dW taken before the scale and AdamW consume it, one check per set;
    "strict" in a step scope poisons the written W, master, mu and nu in
    place as well as the norms."""
    a2d, b2d, b22d = _tn_operands(a, dy, dy2)
    m, k = a2d.shape
    ns = NS_TN_UPDATE if dy2 is None else NS_TN_UPDATE_DUAL
    resolved = resolve_knobs(k, b2d.shape[1], m, a.device, bm=bm, bn=bn, k_layers=k_layers,
                             k_block_factor=k_block_factor, dtype=a.dtype, op=ns)
    bm, bn, kl, kbf = resolved
    mode = _mode(abft, ns)
    norms = sfc_gemm_tn(a2d, b2d, b22d, master, mu, nu, master2, mu2, nu2, hyper, w=w, w2=w2, salt=salt,
                        stochastic_round=stochastic_round, bm=bm, bn=bn, k_layers=kl, k_block_factor=kbf,
                        abft=mode != "off", launch=resolved.launch)
    if mode != "off":
        norms, chk = norms
        state = [x for x in (w, master, mu, nu, w2, master2, mu2, nu2) if x is not None]
        norms, *checked = _verify_tn(ns, (norms, *state), chk, a2d, b2d, b22d, mode)
        for dst, src in zip(state, checked):
            if src is not dst:  # "strict" in a step scope: the poisoned state, written back in place
                dst.copy_(src)
    return norms[0] if dy2 is None else (norms[0], norms[1])


@torch.no_grad()
def plain_update(dw, master, mu, nu, w, hyper, *, salt: int, stochastic_round: bool) -> torch.Tensor:
    """The oracle backends' AdamW step from the hyper vector (the JAX
    package's ``_jnp_update``): `optim.adamw.adamw_leaf_update` on the raw
    dW, written in place, W stochastically rounded (bf16) with ONE hash over
    the whole leaf seeded ``seed ^ salt * 0x85EB`` (not per tile, so its
    bits differ from the kernel's by design).  A 2-D weight or an (E, K, N)
    expert stack (the grouped form: the hash runs over its (E·K, N) rows, as
    JAX's does).  Returns ``sum(dW²)``."""
    from repro_torch.optim import adamw as opt

    g0 = dw.float()
    sq = torch.sum(g0 * g0)
    h = hyper
    mu_n, nu_n, mst_n = opt.adamw_leaf_update(
        g0, mu, nu, master, lr=h[opt.HYP_LR], b1=h[opt.HYP_B1], b2=h[opt.HYP_B2], eps=h[opt.HYP_EPS],
        weight_decay=h[opt.HYP_WD], b1c=h[opt.HYP_B1C], b2c=h[opt.HYP_B2C], scale=h[opt.HYP_SCALE],
    )
    if stochastic_round and w.dtype == torch.bfloat16:
        flat = mst_n.reshape(-1, mst_n.shape[-1])
        seed = (opt.seed_from_lane(h[opt.HYP_SEED]).to(torch.int64) ^ (salt * 0x85EB)) & 0xFFFFFFFF
        w_sr = stochastic_round_to(flat, tile_random_bits(flat.shape, seed), w.dtype).reshape(mst_n.shape)
        w_n = torch.where(h[opt.HYP_SCALE] == 0.0, mst_n.to(w.dtype), w_sr)
    else:
        w_n = mst_n.to(w.dtype)
    mu.copy_(mu_n)
    nu.copy_(nu_n)
    master.copy_(mst_n)
    w.copy_(w_n)
    return sq


# ---------------------------------------------------------------------------
# backward self-healing: fallback-ladder rungs for the NT / TN launches
# ---------------------------------------------------------------------------


def _torch_nt(dh, b, dg=None, b_gate=None) -> torch.Tensor:
    """The torch rung of `sfc_matmul_nt`: dh (..., M, N) @ b (K, N)ᵀ (+ the
    dual pair) in f32."""
    out = torch.einsum("...mn,kn->...mk", dh.float(), b.float())
    if dg is not None:
        out = out + torch.einsum("...mn,kn->...mk", dg.float(), b_gate.float())
    return out


def _torch_tn(a2d, dh2, dg2=None):
    """The torch rung of `sfc_matmul_tn`: a (M, K)ᵀ @ dh (M, N) in f32 (dual:
    a pair)."""
    at = a2d.float().t()
    db = at @ dh2.float()
    return db if dg2 is None else (db, at @ dg2.float())


def _torch_grouped_nt(dh, b, group_sizes, dg=None, b_gate=None) -> torch.Tensor:
    """The torch rung of `sfc_grouped_matmul_nt`, expert by expert."""
    parts = torch.split(dh, list(group_sizes))
    gparts = torch.split(dg, list(group_sizes)) if dg is not None else [None] * len(parts)
    return torch.cat([_torch_nt(p, b[e], gp, None if gp is None else b_gate[e])
                      for e, (p, gp) in enumerate(zip(parts, gparts))])


def _torch_grouped_tn(a, dh, group_sizes, dg=None):
    """The torch rung of `sfc_grouped_matmul_tn`: (E, K, N) dW stack(s)."""
    sizes = list(group_sizes)
    a_p, dh_p = torch.split(a, sizes), torch.split(dh, sizes)
    db = torch.stack([_torch_tn(x, y) for x, y in zip(a_p, dh_p)])
    if dg is None:
        return db
    return db, torch.stack([_torch_tn(x, y) for x, y in zip(a_p, torch.split(dg, sizes))])


def _nt_with_fallback(dh_c, b, dg_c, b_gate):
    m = math.prod(dh_c.shape[:-1])
    return run_with_fallback(
        NS_NT,
        ((RUNG_SFC_CUDA, lambda: sfc_matmul_nt(dh_c, b, dg_c, b_gate)),
         (RUNG_TORCH, lambda: _torch_nt(dh_c, b, dg_c, b_gate))),
        shape_key=lambda: bwd_shape_key(m, b.shape[0], dh_c.shape[-1], dh_c.dtype),
    )


def _tn_with_fallback(a2d, dh2, dg2):
    def kernel():
        return sfc_matmul_tn(a2d, dh2) if dg2 is None else sfc_matmul_tn(a2d, dh2, dg2)

    return run_with_fallback(
        NS_TN,
        ((RUNG_SFC_CUDA, kernel), (RUNG_TORCH, lambda: _torch_tn(a2d, dh2, dg2))),
        shape_key=lambda: bwd_shape_key(a2d.shape[-1], dh2.shape[-1], a2d.shape[0], a2d.dtype),
    )


def _grouped_nt_with_fallback(dh_c, b, gs, dg_c, b_gate):
    return run_with_fallback(
        NS_GROUPED_NT,
        ((RUNG_SFC_CUDA, lambda: sfc_grouped_matmul_nt(dh_c, b, gs, dg_c, b_gate)),
         (RUNG_TORCH, lambda: _torch_grouped_nt(dh_c, b, gs, dg_c, b_gate))),
        shape_key=lambda: bwd_shape_key(dh_c.shape[0], b.shape[-2], dh_c.shape[-1], dh_c.dtype),
    )


def _grouped_tn_with_fallback(a, dh_c, gs, dg_c):
    def kernel():
        return sfc_grouped_matmul_tn(a, dh_c, gs) if dg_c is None else sfc_grouped_matmul_tn(a, dh_c, gs, dg_c)

    return run_with_fallback(
        NS_GROUPED_TN,
        ((RUNG_SFC_CUDA, kernel), (RUNG_TORCH, lambda: _torch_grouped_tn(a, dh_c, gs, dg_c))),
        shape_key=lambda: bwd_shape_key(a.shape[-1], dh_c.shape[-1], a.shape[0], a.dtype),
    )


# ---------------------------------------------------------------------------
# the custom VJP: the backward pass is itself SFC GEMMs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _VjpCfg:
    glu: bool
    activation: Optional[str]
    out_scale: Optional[float]
    bm: Optional[int]
    bn: Optional[int]
    k_layers: Optional[int]
    k_block_factor: Optional[int]
    out_dtype: Optional[torch.dtype]
    fuse: Optional[bool]
    abft: Optional[str] = None


def _activation_grad(name: str, x: torch.Tensor) -> torch.Tensor:
    """d act / dx in f32, for the activations of `activation_fn`."""
    if name == "silu":
        s = torch.sigmoid(x)
        return s + x * s * (1.0 - s)
    if name == "gelu":  # the tanh form
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (x + 0.044715 * x**3))
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3.0 * 0.044715 * x * x)
    if name == "relu":
        return (x > 0).to(x.dtype)
    raise ValueError(f"unknown activation {name!r}")


def _epilogue_cotangents(glu, activation, out_scale, h_pre, g_pre, dy):
    """(dh, dg) f32 cotangents of the biased pre-activations given dy: the
    epilogue-derivative prelude of the backward."""
    dyf = dy.float()
    if out_scale is not None:
        dyf = dyf * out_scale
    if glu:
        g = g_pre.float()
        dh = dyf * activation_fn(activation)(g)
        dg = dyf * h_pre.float() * _activation_grad(activation, g)
    elif activation is not None:
        dh, dg = dyf * _activation_grad(activation, h_pre.float()), None
    else:
        dh, dg = dyf, None
    return dh, dg


def _training_forward(cfg: _VjpCfg, a, b, b_gate, bias, gate_bias, residual):
    """JAX's training forward of ``_matmul_core``: (out, h_pre, g_pre), the
    pre-activations kept for the backward (None for a linear epilogue)."""
    out_dtype = cfg.out_dtype or a.dtype
    kw = dict(bm=cfg.bm, bn=cfg.bn, k_layers=cfg.k_layers, k_block_factor=cfg.k_block_factor,
              fuse=cfg.fuse, abft=cfg.abft)
    h_pre = g_pre = None
    if cfg.glu:
        h_pre, g_pre = _matmul_impl(a, b, b_gate, bias=bias, gate_bias=gate_bias, residual=None,
                                    activation=None, out_scale=None, out_dtype=None, preact=True, **kw)
        y = activation_fn(cfg.activation)(g_pre.float()) * h_pre.float()
    elif cfg.activation is not None:
        h_pre = _matmul_impl(a, b, None, bias=bias, gate_bias=None, residual=None,
                             activation=None, out_scale=None, out_dtype=None, **kw)
        y = activation_fn(cfg.activation)(h_pre.float())
    else:
        # linear epilogue: the fully fused path is the training forward too
        out = _matmul_impl(a, b, None, bias=bias, gate_bias=None, residual=residual,
                           activation=None, out_scale=cfg.out_scale, out_dtype=cfg.out_dtype, **kw)
        return out, None, None
    if cfg.out_scale is not None:
        y = y * cfg.out_scale
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype), h_pre, g_pre


def _compute_cotangents(cfg: _VjpCfg, a, h_pre, g_pre, dy):
    """(dh, dg) in f32 and (dh_c, dg_c) in the compute type: the backward
    kernels run in the forward's compute type."""
    dh, dg = _epilogue_cotangents(cfg.glu, cfg.activation, cfg.out_scale, h_pre, g_pre, dy)
    return dh, dg, dh.to(a.dtype), None if dg is None else dg.to(a.dtype)


def _in_forward_abft_state(backward):
    """Run an autograd Function's backward in the ABFT state (mode and step
    scope) its forward saw, ``ctx.abft``: on the card autograd runs the
    backward on a device thread where the step's context variables are
    unset, and JAX checks the backward's launches under the step's mode."""

    @functools.wraps(backward)
    def run(ctx, *grads):
        with _abft.restored(ctx.abft):
            return backward(ctx, *grads)

    return run


def _bias_grads(dh, dg, bias, gate_bias):
    lead_axes = tuple(range(dh.ndim - 1))
    dbias = None if bias is None else dh.sum(dim=lead_axes).reshape(bias.shape).to(bias.dtype)
    dgbias = None if gate_bias is None else dg.sum(dim=lead_axes).reshape(gate_bias.shape).to(gate_bias.dtype)
    return dbias, dgbias


class _MatmulCore(torch.autograd.Function):
    """``_matmul_core`` of the JAX package: the training forward on the
    forward kernel, the backward on the NT/TN kernels."""

    @staticmethod
    def forward(ctx, cfg: _VjpCfg, a, b, b_gate, bias, gate_bias, residual):
        out, h_pre, g_pre = _training_forward(cfg, a, b, b_gate, bias, gate_bias, residual)
        ctx.cfg, ctx.abft = cfg, _abft.capture()
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(a, b, b_gate, h_pre, g_pre, bias, gate_bias)
        return out

    @staticmethod
    @_in_forward_abft_state
    def backward(ctx, dy):
        a, b, b_gate, h_pre, g_pre, bias, gate_bias = ctx.saved_tensors
        cfg = ctx.cfg
        need_a, need_b, need_bg = ctx.needs_input_grad[1:4]
        dh, dg, dh_c, dg_c = _compute_cotangents(cfg, a, h_pre, g_pre, dy)
        da = db = dbg = None
        if b.ndim > 2:
            # per-batch weights (no model call site; the forward refuses a
            # GLU): the forward kernel on transposed copies, as in JAX
            if need_a:
                da = sfc_matmul(dh_c, b.transpose(-1, -2))
            if need_b:
                db = sfc_matmul(a.transpose(-1, -2), dh_c)
        else:
            if need_a:
                da = _nt_with_fallback(dh_c, b, dg_c, b_gate if dg_c is not None else None)
            if need_b or need_bg:
                n = b.shape[-1]
                a2d = a.reshape(-1, a.shape[-1])
                if dg_c is not None:
                    db, dbg = _tn_with_fallback(a2d, dh_c.reshape(-1, n), dg_c.reshape(-1, n))
                else:
                    db = _tn_with_fallback(a2d, dh_c.reshape(-1, n), None)
        dbias, dgbias = _bias_grads(dh, dg, bias, gate_bias)
        dres = None if ctx.res_dtype is None else dy.to(ctx.res_dtype)
        return (
            None,
            None if da is None else da.to(a.dtype),
            None if db is None else db.to(b.dtype),
            None if dbg is None else dbg.to(b_gate.dtype),
            dbias,
            dgbias,
            dres,
        )


class _UpdateCore(torch.autograd.Function):
    """``_update_core`` of the JAX package (its fused branch) for a
    projection whose weight the fused optimizer routes: the forward is
    `_MatmulCore`'s; the backward computes the epilogue cotangents, runs the
    NT kernel for dA, hands ``(a (M, K), dh (M, N), dg)`` in the compute
    type to ``sink`` (the step's tape, which launches the TN kernel's norm
    and update modes) and returns no gradient for the weights, so dW never
    exists."""

    @staticmethod
    def forward(ctx, cfg: _VjpCfg, a, b, b_gate, bias, gate_bias, sink):
        out, h_pre, g_pre = _training_forward(cfg, a, b, b_gate, bias, gate_bias, None)
        ctx.cfg, ctx.sink, ctx.abft = cfg, sink, _abft.capture()
        ctx.save_for_backward(a, b, b_gate, h_pre, g_pre, bias, gate_bias)
        return out

    @staticmethod
    @_in_forward_abft_state
    def backward(ctx, dy):
        a, b, b_gate, h_pre, g_pre, bias, gate_bias = ctx.saved_tensors
        dh, dg, dh_c, dg_c = _compute_cotangents(ctx.cfg, a, h_pre, g_pre, dy)
        da = None
        if ctx.needs_input_grad[1]:
            da = _nt_with_fallback(dh_c, b, dg_c, b_gate if dg_c is not None else None).to(a.dtype)
        n = b.shape[-1]
        ctx.sink(a.reshape(-1, a.shape[-1]), dh_c.reshape(-1, n), None if dg_c is None else dg_c.reshape(-1, n))
        dbias, dgbias = _bias_grads(dh, dg, bias, gate_bias)
        return None, da, None, None, dbias, dgbias, None


class _RoutedWeight(torch.autograd.Function):
    """Identity on a routed weight whose gradient goes to ``sink`` and not
    to the weight: the oracle backends' way to take plain-autograd dW
    without a ``.grad`` (the JAX package's oracle returns its update through
    the cotangent slot, which torch has no counterpart of)."""

    @staticmethod
    def forward(ctx, w, sink):
        ctx.sink = sink
        return w.view_as(w)

    @staticmethod
    def backward(ctx, dw):
        ctx.sink(dw)
        return None, None


def fused_update_matmul(x, w, sink, *, bias=None, activation=None, fused: bool = True) -> torch.Tensor:
    """Projection of a routed weight (JAX: ``fused_update_matmul``):
    ``epilogue(x @ w)`` whose backward hands the weight's share to ``sink``
    instead of a gradient.  ``fused``: `_UpdateCore` (the SFC kernels;
    ``sink(a, dh, None)``); else the oracle, ``x @ w`` in plain torch with
    ``sink(dw)``."""
    if fused:
        cfg = _VjpCfg(glu=False, activation=activation, out_scale=None, bm=None, bn=None, k_layers=None,
                      k_block_factor=None, out_dtype=None, fuse=None)
        return _UpdateCore.apply(cfg, x, w, None, bias, None, sink)
    y = x @ _RoutedWeight.apply(w, sink)
    if bias is not None:
        y = y + bias
    return activation_fn(activation)(y) if activation is not None else y


def fused_update_glu_matmul(x, w_gate, w_val, sink, *, activation="silu", bias=None, gate_bias=None,
                            fused: bool = True) -> torch.Tensor:
    """Gated projection of a routed (gate, value) pair (JAX:
    ``fused_update_glu_matmul``): one dual TN update flush serves both.
    ``fused``: `_UpdateCore`, ``sink(a, dh, dg)``; else the oracle, with
    ``sink`` a pair of callables taking dW of the value and of the gate."""
    if fused:
        cfg = _VjpCfg(glu=True, activation=activation, out_scale=None, bm=None, bn=None, k_layers=None,
                      k_block_factor=None, out_dtype=None, fuse=None)
        return _UpdateCore.apply(cfg, x, w_val, w_gate, bias, gate_bias, sink)
    sink_val, sink_gate = sink
    g = x @ _RoutedWeight.apply(w_gate, sink_gate)
    if gate_bias is not None:
        g = g + gate_bias
    h = x @ _RoutedWeight.apply(w_val, sink_val)
    if bias is not None:
        h = h + bias
    return activation_fn(activation)(g) * h


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def sfc_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    fuse: Optional[bool] = None,
    abft: Optional[str] = None,
) -> torch.Tensor:
    """C = epilogue(A @ B) through the SFC fused kernel, any leading batch
    dims on A.

    ``a``: (..., M, K); ``b``: (K, N) shared across the batch, or
    (..., K, N) with leading dims matching ``a``'s.  The epilogue — ``bias``
    (N,), ``activation`` in {"silu", "gelu", "relu"}, ``out_scale`` (a
    Python float) and ``residual`` (..., M, N) — runs in the kernel's flush:
    ``C = act(A@B + bias) * out_scale + residual`` on the f32 accumulator.
    Differentiable: with an input that needs a gradient it runs through
    `_MatmulCore` (the NT/TN kernels in the backward).
    """
    if _needs_grad(a, b, bias, residual):
        cfg = _VjpCfg(glu=False, activation=activation, out_scale=out_scale, bm=bm, bn=bn, k_layers=k_layers,
                      k_block_factor=k_block_factor, out_dtype=out_dtype, fuse=fuse, abft=abft)
        return _MatmulCore.apply(cfg, a, b, None, bias, None, residual)
    return _matmul_impl(
        a, b, None,
        bias=bias, gate_bias=None, residual=residual,
        activation=activation, out_scale=out_scale,
        bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
        out_dtype=out_dtype, fuse=fuse, abft=abft,
    )


def sfc_glu_matmul(
    a: torch.Tensor,
    b_gate: torch.Tensor,
    b_val: torch.Tensor,
    *,
    activation: str = "silu",
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    out_scale: Optional[float] = None,
    residual: Optional[torch.Tensor] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_layers: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    fuse: Optional[bool] = None,
    abft: Optional[str] = None,
) -> torch.Tensor:
    """Gated-MLP projection ``act(A@Wg + gate_bias) * (A@Wv + bias)`` in one
    SFC traversal of A (dual-B kernel: two weight panels, two f32
    accumulators, one C write).  Weights are shared 2-D (K, N).
    Differentiable as `sfc_matmul` is; the forward then flushes both
    pre-activations (``preact``) and the backward runs the dual NT/TN
    forms."""
    if _needs_grad(a, b_gate, b_val, bias, gate_bias, residual):
        cfg = _VjpCfg(glu=True, activation=activation, out_scale=out_scale, bm=bm, bn=bn, k_layers=k_layers,
                      k_block_factor=k_block_factor, out_dtype=out_dtype, fuse=fuse, abft=abft)
        return _MatmulCore.apply(cfg, a, b_val, b_gate, bias, gate_bias, residual)
    return _matmul_impl(
        a, b_val, b_gate,
        bias=bias, gate_bias=gate_bias, residual=residual,
        activation=activation, out_scale=out_scale,
        bm=bm, bn=bn, k_layers=k_layers, k_block_factor=k_block_factor,
        out_dtype=out_dtype, fuse=fuse, abft=abft,
    )


# ---------------------------------------------------------------------------
# grouped (MoE expert) GEMMs: K3 forward, K9 dA, K10 dW, and their VJP
# ---------------------------------------------------------------------------


def _grouped_knobs(max_rows: int, n: int, k: int, device, bm, bn) -> Tuple[int, int]:
    """(bm, bn) of a grouped launch: the kernel's tile on the card; on the
    CPU the JAX package's choice, `pick_blocks` over the largest expert's
    rows with bm at most 128."""
    if torch.device(device).type == "cuda":
        bm, bn, _, _ = resolve_knobs(max_rows, n, k, device, bm=bm, bn=bn)
        return bm, bn
    pbm, pbn, _ = pick_blocks(max(max_rows, 1), n, k)
    return bm or min(pbm, 128), bn or pbn


def _grouped_impl(
    a: torch.Tensor,  # (T, K) rows sorted by expert
    b: torch.Tensor,  # (E, K, N) per-expert weights
    b_gate: Optional[torch.Tensor],  # (E, K, N) per-expert gate weights
    group_sizes,
    *,
    bias: Optional[torch.Tensor],
    gate_bias: Optional[torch.Tensor],
    activation: Optional[str],
    out_scale: Optional[float],
    bm: Optional[int],
    bn: Optional[int],
    k_block_factor: Optional[int],
    out_dtype: Optional[torch.dtype],
    preact: bool = False,
):
    """One launch of the grouped kernel (the JAX package's ``_grouped_impl``
    less its row padding: the kernel masks each expert's last row block).
    ABFT under ``NS_GROUPED`` / ``NS_GROUPED_GLU``: the kernel's checksum
    lane against the sum of every expert's operand checksum (each expert's
    rows against its own weight slab)."""
    if a.ndim != 2 or b.ndim != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(f"grouped matmul needs a (T, K) and b (E, K, N); got {tuple(a.shape)}, {tuple(b.shape)}")
    e_cnt, k, n = b.shape
    for name, vec in (("bias", bias), ("gate_bias", gate_bias)):
        if vec is not None and tuple(vec.shape) != (e_cnt, n):
            raise ValueError(f"{name} must be (E, N)=({e_cnt},{n}), got {tuple(vec.shape)}")
    gs = tuple(int(g) for g in group_sizes)
    bm, bn = _grouped_knobs(max(gs, default=1), n, k, a.device, bm, bn)
    vecs = [None if v is None else v.contiguous() for v in (bias, gate_bias)]
    ns = NS_GROUPED if b_gate is None else NS_GROUPED_GLU
    mode = _mode(None, ns)
    out = sfc_gemm_grouped(
        a.contiguous(), b.contiguous(), None if b_gate is None else b_gate.contiguous(), *vecs,
        group_sizes=gs, activation=activation, out_scale=out_scale, bm=bm, bn=bn,
        k_block_factor=k_block_factor or 1, out_dtype=out_dtype, preact=preact, abft=mode != "off",
    )
    if mode == "off":
        return out
    *outs, chk = out
    ref, mag = _abft.grouped_checksum_ref(a, b, b_gate, gs)
    return _abft.verify(ns, tuple(outs) if preact else outs[0], chk, ref, mag, contract_dim=k, mode=mode)


def sfc_grouped_matmul_nt(
    a: torch.Tensor,  # (T, K) rows sorted by expert (the dC rows)
    b: torch.Tensor,  # (E, N, K) per-expert operand, consumed as b[e]ᵀ
    group_sizes,
    a2: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Grouped NT: ``out[rows of e] = a[rows of e] @ b[e]ᵀ`` (+ ``a2 @
    b2[e]ᵀ``), the grouped dA (per-expert weights read as stored) through
    K9.  Knobs as in the JAX package's ``sfc_grouped_matmul_nt``."""
    gs = tuple(int(g) for g in group_sizes)
    bm, bn = _grouped_knobs(max(gs, default=1), b.shape[-2], a.shape[-1], a.device, bm, bn)
    return sfc_gemm_grouped_nt(
        a.contiguous(), b.contiguous(), None if a2 is None else a2.contiguous(),
        None if b2 is None else b2.contiguous(),
        group_sizes=gs, bm=bm, bn=bn, k_block_factor=k_block_factor or 1, out_dtype=out_dtype,
    )


def sfc_grouped_matmul_tn(
    a: torch.Tensor,  # (T, K) rows sorted by expert (the forward activations)
    b: torch.Tensor,  # (T, N) rows sorted by expert (the dC rows)
    group_sizes,
    b2: Optional[torch.Tensor] = None,  # (T, N) second dC (the GLU's gate grad)
    *,
    row_block: Optional[int] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """Grouped TN: ``dW[e] = a[rows of e]ᵀ @ b[rows of e]`` for every
    expert in one K10 launch; with ``b2`` the activations stream once for
    both weight-grad stacks (a pair).  Knobs as in the JAX package's
    ``sfc_grouped_matmul_tn`` (the output tile from `pick_blocks`, at most
    128, the contraction chunk from the largest expert's rows)."""
    gs = tuple(int(g) for g in group_sizes)
    bm, bn = _grouped_tn_knobs(a, b, bm, bn)
    return sfc_gemm_grouped_tn(
        a.contiguous(), b.contiguous(), None if b2 is None else b2.contiguous(),
        group_sizes=gs, bm=bm, bn=bn, row_block=row_block or grouped_tn_row_block(gs), out_dtype=out_dtype,
    )


def _grouped_tn_knobs(a, b, bm, bn) -> Tuple[int, int]:
    """(bm, bn) of a grouped TN launch over (T, K) activations and (T, N)
    cotangents: the kernel's tile on the card; on the CPU the JAX
    package's, `pick_blocks` with each at most 128."""
    k, n = a.shape[-1], b.shape[-1]
    if torch.device(a.device).type == "cuda":
        bm, bn, _, _ = resolve_knobs(k, n, a.shape[0], a.device, bm=bm, bn=bn)
    elif bm is None or bn is None:
        pbm, pbn, _ = pick_blocks(k, n, max(a.shape[0], 1))
        bm, bn = bm or min(pbm, 128), bn or min(pbn, 128)
    return bm, bn


def sfc_grouped_matmul_tn_norm(
    a: torch.Tensor,  # (T, K) rows sorted by expert (the forward activations)
    dy: torch.Tensor,  # (T, N) rows sorted by expert (the output cotangent)
    group_sizes,
    dy2: Optional[torch.Tensor] = None,  # (T, N) second cotangent (the GLU's gate)
    *,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
):
    """``sum(dW²)`` over every expert of ``dW[e] = a[rows of e]ᵀ @ dy[rows
    of e]`` (and of ``dy2``'s) from K10's norm mode: the expert weight-grad
    stack stays in the f32 accumulators.  The first phase of the fused
    step's exact clip.  Returns an f32 scalar, or a pair with ``dy2``."""
    gs = tuple(int(g) for g in group_sizes)
    bm, bn = _grouped_tn_knobs(a, dy, bm, bn)
    norms = sfc_gemm_grouped_tn(a.contiguous(), dy.contiguous(), None if dy2 is None else dy2.contiguous(),
                                group_sizes=gs, norm=True, bm=bm, bn=bn)
    return norms[0] if dy2 is None else (norms[0], norms[1])


def sfc_grouped_matmul_tn_update(
    a: torch.Tensor,  # (T, K) rows sorted by expert (the forward activations)
    dy: torch.Tensor,  # (T, N) rows sorted by expert (the output cotangent)
    group_sizes,
    master: torch.Tensor,  # (E, K, N) f32 master weights, updated in place
    mu: torch.Tensor,  # (E, K, N) f32, in place
    nu: torch.Tensor,  # (E, K, N) f32, in place
    hyper: torch.Tensor,  # (12,) f32 `optim.adamw.pack_adamw_hyper` vector
    dy2: Optional[torch.Tensor] = None,  # (T, N) second cotangent (the GLU's gate)
    master2: Optional[torch.Tensor] = None,
    mu2: Optional[torch.Tensor] = None,
    nu2: Optional[torch.Tensor] = None,
    *,
    w: torch.Tensor,  # (E, K, N) the expert stack, in a's type, written in place
    w2: Optional[torch.Tensor] = None,
    salt: int = 0,
    stochastic_round: bool = False,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    row_block: Optional[int] = None,
):
    """Grouped grad-and-update: per-expert ``dW[e] = a[rows of e]ᵀ @
    dy[rows of e]`` in K10's f32 accumulators and AdamW in its flush over
    the (E, K, N) stacks, W, master, mu and nu written in place; the expert
    weight-grad stack never exists.  An expert with no rows, and a dispatch
    with no rows at all, runs the g = 0 update in the same launch.  Returns
    ``sum(dW²)`` before the scale (a pair with ``dy2``, whose set is (w2,
    master2, mu2, nu2)).  The JAX package's ``sfc_grouped_matmul_tn_update``
    returns the new stacks instead; its hyper vector carries the salt, here
    ``salt`` does."""
    gs = tuple(int(g) for g in group_sizes)
    bm, bn = _grouped_tn_knobs(a, dy, bm, bn)
    norms = sfc_gemm_grouped_tn(a.contiguous(), dy.contiguous(), None if dy2 is None else dy2.contiguous(),
                                master, mu, nu, master2, mu2, nu2, hyper, group_sizes=gs, w=w, w2=w2, salt=salt,
                                stochastic_round=stochastic_round, bm=bm, bn=bn,
                                row_block=row_block or grouped_tn_row_block(gs))
    return norms[0] if dy2 is None else (norms[0], norms[1])


@dataclasses.dataclass(frozen=True)
class _GroupedVjpCfg:
    group_sizes: Tuple[int, ...]
    glu: bool
    activation: Optional[str]
    out_scale: Optional[float]
    bm: Optional[int]
    bn: Optional[int]
    k_block_factor: Optional[int]
    out_dtype: Optional[torch.dtype]


def _grouped_training_forward(cfg: _GroupedVjpCfg, a, b, b_gate, bias, gate_bias):
    """JAX's ``_grouped_core_fwd``: (out, h_pre, g_pre)."""
    out_dtype = cfg.out_dtype or a.dtype
    kw = dict(bm=cfg.bm, bn=cfg.bn, k_block_factor=cfg.k_block_factor)
    h_pre = g_pre = None
    if cfg.glu:
        h_pre, g_pre = _grouped_impl(a, b, b_gate, cfg.group_sizes, bias=bias, gate_bias=gate_bias,
                                     activation=None, out_scale=None, out_dtype=None, preact=True, **kw)
        y = activation_fn(cfg.activation)(g_pre.float()) * h_pre.float()
    elif cfg.activation is not None:
        h_pre = _grouped_impl(a, b, None, cfg.group_sizes, bias=bias, gate_bias=None,
                              activation=None, out_scale=None, out_dtype=None, **kw)
        y = activation_fn(cfg.activation)(h_pre.float())
    else:
        out = _grouped_impl(a, b, None, cfg.group_sizes, bias=bias, gate_bias=None,
                            activation=None, out_scale=cfg.out_scale, out_dtype=cfg.out_dtype, **kw)
        return out, None, None
    if cfg.out_scale is not None:
        y = y * cfg.out_scale
    return y.to(out_dtype), h_pre, g_pre


def _segment_sums(x: torch.Tensor, group_sizes) -> torch.Tensor:
    """(E, N) f32 per-expert sums of the rows of ``x`` (T, N), each in its
    own reduction: no atomics."""
    parts = torch.split(x.float(), list(group_sizes))
    return torch.stack([p.sum(dim=0) for p in parts])


class _GroupedCore(torch.autograd.Function):
    """``_grouped_core`` of the JAX package: the training forward on K3
    (the GLU in ``preact`` mode), the backward on K9 (dA) and K10 (dW)."""

    @staticmethod
    def forward(ctx, cfg: _GroupedVjpCfg, a, b, b_gate, bias, gate_bias):
        out, h_pre, g_pre = _grouped_training_forward(cfg, a, b, b_gate, bias, gate_bias)
        ctx.cfg = cfg
        ctx.save_for_backward(a, b, b_gate, h_pre, g_pre, bias, gate_bias)
        return out

    @staticmethod
    def backward(ctx, dy):
        a, b, b_gate, h_pre, g_pre, bias, gate_bias = ctx.saved_tensors
        gs = ctx.cfg.group_sizes
        need_b, need_bg = ctx.needs_input_grad[2:4]
        dh_c, dg_c, da, dbias, dgbias = _grouped_backward(ctx, a, b, b_gate, h_pre, g_pre, bias, gate_bias, dy)
        db = dbg = None
        if need_b or need_bg:
            if dg_c is not None:
                db, dbg = _grouped_tn_with_fallback(a, dh_c, gs, dg_c)
            else:
                db = _grouped_tn_with_fallback(a, dh_c, gs, None)
        return (
            None,
            da,
            None if db is None else db.to(b.dtype),
            None if dbg is None else dbg.to(b_gate.dtype),
            dbias,
            dgbias,
        )


def _grouped_backward(ctx, a, b, b_gate, h_pre, g_pre, bias, gate_bias, dy):
    """The part of the grouped backward both Functions share: the epilogue
    cotangents (and in the compute type), dA on K9 where asked for, and the
    per-expert bias sums.  Returns (dh_c, dg_c, da, dbias, dgbias)."""
    cfg = ctx.cfg
    gs = cfg.group_sizes
    dh, dg = _epilogue_cotangents(cfg.glu, cfg.activation, cfg.out_scale, h_pre, g_pre, dy)
    dh_c = dh.to(a.dtype)
    dg_c = None if dg is None else dg.to(a.dtype)
    da = None
    if ctx.needs_input_grad[1]:
        # (E, K, N) weights as stored are the NT kernel's (E, N', K') operand
        da = _grouped_nt_with_fallback(dh_c, b, gs, dg_c, b_gate if dg_c is not None else None).to(a.dtype)
    dbias = None if bias is None else _segment_sums(dh, gs).to(bias.dtype)
    dgbias = None if gate_bias is None else _segment_sums(dg, gs).to(gate_bias.dtype)
    return dh_c, dg_c, da, dbias, dgbias


class _GroupedUpdateCore(torch.autograd.Function):
    """``_grouped_update_core`` of the JAX package (its fused branch) for
    expert stacks that the fused optimizer routes: the forward is
    `_GroupedCore`'s; the backward runs K9 for dA, hands ``(a (T, K), dh (T,
    N), dg, group_sizes)`` in the compute type to ``sink`` (the step's tape,
    which launches K10's norm and update modes) and returns no gradient for
    the stacks.  Per-expert bias gradients stay autograd gradients."""

    @staticmethod
    def forward(ctx, cfg: _GroupedVjpCfg, a, b, b_gate, bias, gate_bias, sink):
        out, h_pre, g_pre = _grouped_training_forward(cfg, a, b, b_gate, bias, gate_bias)
        ctx.cfg, ctx.sink = cfg, sink
        ctx.save_for_backward(a, b, b_gate, h_pre, g_pre, bias, gate_bias)
        return out

    @staticmethod
    def backward(ctx, dy):
        a, b, b_gate, h_pre, g_pre, bias, gate_bias = ctx.saved_tensors
        dh_c, dg_c, da, dbias, dgbias = _grouped_backward(ctx, a, b, b_gate, h_pre, g_pre, bias, gate_bias, dy)
        ctx.sink(a, dh_c, dg_c, ctx.cfg.group_sizes)
        return None, da, None, None, dbias, dgbias, None


def _grouped_oracle(x, w, group_sizes):
    """``x[rows of e] @ w[e]`` per expert in plain torch: the oracle's
    product, differentiable in both."""
    parts = torch.split(x, list(group_sizes))
    return torch.cat([p @ w[e] for e, p in enumerate(parts)])


def fused_update_grouped_matmul(x, w, group_sizes, sink, *, bias=None, activation=None,
                                fused: bool = True) -> torch.Tensor:
    """Expert projection of a routed (E, K, N) stack (JAX:
    ``fused_update_grouped_matmul``): ``epilogue(x[rows of e] @ w[e])``
    whose backward hands the stack's share to ``sink`` instead of a
    gradient.  ``fused``: `_GroupedUpdateCore` (K3, K9; ``sink(a, dh, None,
    group_sizes)``); else the oracle, the product in plain torch with
    ``sink(dw)``."""
    gs = tuple(int(g) for g in group_sizes)
    if fused:
        cfg = _GroupedVjpCfg(group_sizes=gs, glu=False, activation=activation, out_scale=None, bm=None, bn=None,
                             k_block_factor=None, out_dtype=None)
        return _GroupedUpdateCore.apply(cfg, x, w, None, bias, None, sink)
    y = _grouped_oracle(x, _RoutedWeight.apply(w, sink), gs)
    if bias is not None:
        y = y + torch.repeat_interleave(bias, torch.tensor(gs, device=bias.device), dim=0)
    return activation_fn(activation)(y) if activation is not None else y


def fused_update_grouped_glu_matmul(x, w_gate, w_val, group_sizes, sink, *, activation="silu",
                                    fused: bool = True) -> torch.Tensor:
    """Gated expert MLP of a routed (gate, value) stack pair (JAX:
    ``fused_update_grouped_glu_matmul``): one dual K10 update flush serves
    both.  ``fused``: `_GroupedUpdateCore`, ``sink(a, dh, dg, group_sizes)``;
    else the oracle, with ``sink`` a pair of callables taking dW of the
    value and of the gate stack."""
    gs = tuple(int(g) for g in group_sizes)
    if fused:
        cfg = _GroupedVjpCfg(group_sizes=gs, glu=True, activation=activation, out_scale=None, bm=None, bn=None,
                             k_block_factor=None, out_dtype=None)
        return _GroupedUpdateCore.apply(cfg, x, w_val, w_gate, None, None, sink)
    sink_val, sink_gate = sink
    g = _grouped_oracle(x, _RoutedWeight.apply(w_gate, sink_gate), gs)
    h = _grouped_oracle(x, _RoutedWeight.apply(w_val, sink_val), gs)
    return activation_fn(activation)(g) * h


def sfc_grouped_matmul(
    a: torch.Tensor,  # (T, K) rows sorted by expert
    b: torch.Tensor,  # (E, K, N) per-expert weights
    group_sizes,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Ragged grouped GEMM: ``out[rows of e] = epilogue(a[rows of e] @
    b[e])`` for every expert in one launch of K3, the epilogue (per-expert
    ``bias`` (E, N), ``activation``, ``out_scale``) in its flush.
    ``group_sizes`` are the experts' row counts (zero is legal), summing to
    ``a``'s rows.  Differentiable: with an input that needs a gradient it
    runs through `_GroupedCore` (K9 and K10 in the backward)."""
    cfg = _GroupedVjpCfg(group_sizes=tuple(int(g) for g in group_sizes), glu=False, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)
    if _needs_grad(a, b, bias):
        return _GroupedCore.apply(cfg, a, b, None, bias, None)
    return _grouped_impl(a, b, None, cfg.group_sizes, bias=bias, gate_bias=None, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)


def sfc_grouped_glu_matmul(
    a: torch.Tensor,  # (T, K) rows sorted by expert
    b_gate: torch.Tensor,  # (E, K, N) per-expert gate weights
    b_val: torch.Tensor,  # (E, K, N) per-expert value weights
    group_sizes,
    *,
    activation: str = "silu",
    bias: Optional[torch.Tensor] = None,
    gate_bias: Optional[torch.Tensor] = None,
    out_scale: Optional[float] = None,
    bm: Optional[int] = None,
    bn: Optional[int] = None,
    k_block_factor: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Ragged grouped gated MLP ``act(a@b_gate[e] + gate_bias[e]) *
    (a@b_val[e] + bias[e])`` per expert in one dual-B launch of K3: each
    dispatched row slab is read once for both weight stacks.
    Differentiable through `_GroupedCore` (the dual K9 and K10 forms)."""
    cfg = _GroupedVjpCfg(group_sizes=tuple(int(g) for g in group_sizes), glu=True, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)
    if _needs_grad(a, b_gate, b_val, bias, gate_bias):
        return _GroupedCore.apply(cfg, a, b_val, b_gate, bias, gate_bias)
    return _grouped_impl(a, b_val, b_gate, cfg.group_sizes, bias=bias, gate_bias=gate_bias, activation=activation,
                         out_scale=out_scale, bm=bm, bn=bn, k_block_factor=k_block_factor, out_dtype=out_dtype)
