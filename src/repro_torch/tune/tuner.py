"""Empirical SFC knob tuner (paper §III-C method (1), made persistent): the
port's ``repro.tune.tuner``.

The tuner:

  1. seeds a candidate set: on the CPU the JAX package's exactly, (bm, bn)
     from the alignment rule and its ×2 / ÷2 neighbours around the
     analytical (k_layers, k_block_factor); on the card the launch
     configurations its kernels accept (`candidate_knobs`), the kernel's
     own rule first;
  2. ranks every candidate with the calibrated performance model
     (`predict_candidate`) and measures only the best-ranked few
     (``strategy="predict"``, the default; ``"exhaustive"`` measures every
     one);
  3. persists the winner in a `KnobCache` keyed by (shape bucket, dtype,
     backend, device kind); `lookup_knobs`, the measurement-free consult of
     `kernels.ops.resolve_knobs` and `core.attention_backend.
     resolve_attn_knobs`, returns it for every shape of the bucket.

Where it differs from the JAX module:

* **What a knob is on the card.**  The kernels are compiled for fixed
  tiles, so a card candidate is a launch configuration in ``Knobs.launch``:
  the wgmma kernels' C tile and worker group (K2 and K1 past 16 rows under
  "gemm" / "glu", K7 under "nt" / "nt_dual"), K8's worker group ("tn*"),
  the cluster kernel's K layers (K1 at M <= 16), K11's W ("attn_fwd"),
  K13's C ("attn_bwd"), K14's S ("attn_decode").  Candidate 0 is the rule's
  launch and always survives clipping; it is always measured, so a winner
  has beaten the rule on the card, and when it wins the entry holds no
  launch (the rule's, at every shape of the bucket).  A call or a
  namespace whose kernel has nothing to choose at a shape (the 64 x 64 tile
  kernels: f32 or ragged rows) caches that seed with ``source=
  "analytical"`` and measures nothing, as the JAX module does when it
  cannot measure.
* **Measurement.**  On the card a candidate is timed as the kernels are in
  ``chip_smoke.py``: CUDA events around a captured graph of 20 or more
  calls, each on its own set of inputs, the sets rotated past the L2
  (`tune.timing`), the call resolving the candidate's launch from a
  scratch in-memory cache, as a serve resolves a winner.  The card's
  buckets are keyed by the rows a launch runs (`ServingEngine.tune_table`).  On the CPU the score is the JAX module's simulator
  path (``_measure_simulated``, its own last fallback); its HLO walk
  (``_measure_hlo_cost``, a cost model over XLA's compiled text) has no
  counterpart here.
* **Nothing is swallowed.**  A candidate that fails to build, launch or
  be predicted raises; so does a failed cache lookup.  (The JAX module
  skips such candidates.)
* A confirmed winner (measured or predicted, not the analytical seed)
  lifts its namespace's ladder quarantines and persists the lift, as in
  the JAX module.  Left to item 15: the drift monitor and the tuner's spans
  and counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.namespaces import (
    ATTN_OPS,
    NS_ATTN_BWD,
    NS_ATTN_DECODE,
    NS_ATTN_FWD,
    NS_GEMM,
    NS_GLU,
    NS_NT,
    NS_NT_DUAL,
    NS_TN,
    NS_TN_DUAL,
    NS_TN_UPDATE,
    NS_TN_UPDATE_DUAL,
    TUNE_OPS,
    base_namespace,
)
from repro_torch.core.perf_model import (
    H100_SMS,
    TPU_V5E,
    HardwareModel,
    choose_knobs_analytical,
    optimizer_update_bytes,
    simulate_decode_attention,
    simulate_flash_attention,
    simulate_gemm,
)
from repro_torch.tune.cache import KnobCache, Knobs, dtype_name, shape_bucket

__all__ = [
    "TUNE_OPS",
    "candidate_knobs",
    "default_cache",
    "using_cache",
    "lookup_knobs",
    "measure_candidate",
    "predict_candidate",
    "rule_launch",
    "tune_gemm",
]

_DEFAULT_CACHE: Optional[KnobCache] = None

Device = Union[str, torch.device, None]


def default_cache() -> KnobCache:
    """Process-wide cache (path from ``$REPRO_TORCH_SFC_TUNE_CACHE``)."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = KnobCache()
    return _DEFAULT_CACHE


@contextlib.contextmanager
def using_cache(cache: KnobCache):
    """Make ``cache`` the process-wide cache inside the block (every thread
    sees it: the card runs autograd's backward on a thread of its own)."""
    global _DEFAULT_CACHE
    before = _DEFAULT_CACHE
    _DEFAULT_CACHE = cache
    try:
        yield cache
    finally:
        _DEFAULT_CACHE = before


def _device(device: Device) -> torch.device:
    """The device a tuner entry point works for: the card unless the
    caller names another (`core.device.resolve_device`)."""
    from repro_torch.core.device import resolve_device

    return resolve_device(device)


def _backend_name(device: Device = "cpu") -> str:
    """The backend of a device's keys: "gpu" for the card (the JAX
    package's name for it), "cpu" for the CPU."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def _on_card(device: Device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _is_bf16(dtype) -> bool:
    return dtype_name(dtype) == "bfloat16"


def _dtype_bytes(dtype) -> int:
    return 2 if _is_bf16(dtype) else np.dtype(dtype_name(dtype)).itemsize


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype_name(dtype))


def _block_candidates(dim: int, seed: int) -> List[int]:
    cands = {seed}
    if seed * 2 <= max(dim, seed):
        cands.add(seed * 2)
    if seed >= 16:
        cands.add(seed // 2)
    return sorted(cands)


def _host_candidates(m: int, n: int, k: int, dtype_bytes: int, max_candidates: int) -> List[Knobs]:
    """The JAX module's candidate list: the analytical seed plus a ×2/÷2
    neighbourhood in each knob, clipped (the seed first)."""
    from repro_torch.kernels.ops import pick_blocks

    bm0, bn0, _ = pick_blocks(m, n, k)
    c0, kbf0 = choose_knobs_analytical(
        max(m, bm0), max(n, bn0), max(k, 1), 1, bm=bm0, bn=bn0, hw=TPU_V5E, dtype_bytes=dtype_bytes,
    )
    seed = Knobs(bm=bm0, bn=bn0, k_layers=c0, k_block_factor=kbf0)
    out: List[Knobs] = [seed]
    seen = {(seed.bm, seed.bn, seed.k_layers, seed.k_block_factor)}
    for bm in _block_candidates(m, bm0):
        for bn in _block_candidates(n, bn0):
            for c in sorted({c0, 1, c0 * 2}):
                if c < 1 or k // c < 1:
                    continue
                for kbf in sorted({kbf0, max(1, kbf0 // 2), kbf0 * 2}):
                    tup = (bm, bn, c, kbf)
                    if tup in seen:
                        continue
                    seen.add(tup)
                    out.append(Knobs(bm=bm, bn=bn, k_layers=c, k_block_factor=kbf))
    return out[:max_candidates]


# ---------------------------------------------------------------------------
# the card: which kernel a namespace's call takes, and its launch choices
# ---------------------------------------------------------------------------

_DUAL = (NS_GLU, NS_NT_DUAL, NS_TN_DUAL, NS_TN_UPDATE_DUAL)
_TN_OPS = (NS_TN, NS_TN_DUAL, NS_TN_UPDATE, NS_TN_UPDATE_DUAL)


def card_route(op: str, m: int, n: int, k: int, dtype) -> str:
    """The kernel the measured call of namespace ``op`` takes on the card at
    bucket (m, n, k) (operands as `_op_operand_shapes` lays them out, fresh
    allocations, so 16-byte aligned): "cluster" (K1 at M <= 16), "wgmma"
    (K2, K1 past 16 rows, K7), "tn" (K8's wgmma kernel), "attn" (K11,
    K12 / K13, K14 at head dims 64 and 128), or "tile" (the 64 x 64 tile
    kernels, nothing to choose)."""
    from repro_torch.kernels import build

    op = base_namespace(op)
    bf16 = _is_bf16(dtype)
    if op in ATTN_OPS:
        return "attn" if bf16 and k in build.ATTN_HEAD_DIMS else "tile"
    if not bf16:
        return "tile"
    if op in (NS_GEMM, NS_GLU):
        if 1 <= m <= build.SPLIT_MAX_ROWS:
            return "cluster"
        return "wgmma" if k % 8 == 0 and n % 8 == 0 else "tile"
    if op in (NS_NT, NS_NT_DUAL):
        return "wgmma" if k % 8 == 0 else "tile"
    return "tn" if k >= 1 and m % 8 == 0 and n % 8 == 0 else "tile"


def _heads(heads: Optional[Tuple[int, int, int]]) -> Tuple[int, int, int]:
    """(batch, q heads, kv heads) of an attention candidate: the caller's,
    else one of each (the JAX module's operands)."""
    return tuple(heads) if heads else (1, 1, 1)


def rule_launch(op: str, m: int, n: int, k: int, dtype, *, sms: int = H100_SMS,
                heads: Optional[Tuple[int, int, int]] = None) -> Optional[Dict[str, int]]:
    """The launch the card's rule takes for the measured call of ``op`` at
    (m, n, k), as a ``Knobs.launch`` dict; None where the call takes a tile
    kernel (nothing to choose)."""
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk

    route = card_route(op, m, n, k, dtype)
    op = base_namespace(op)
    if route == "cluster":
        return {"layers": tk.cluster_layers(k, n, sms)}
    if route == "wgmma":
        cfg = tk.wgmma_launch(m, n, sms, op == NS_GLU)
        return {"wide": int(cfg.wide), "group": cfg.group}
    if route == "tn":
        cfg = tk.tn_wgmma_launch(m, n, sms, op in _DUAL, 1, op in (NS_TN_UPDATE, NS_TN_UPDATE_DUAL))
        return {"group": cfg.group}
    if route == "attn":
        b, h, hkv = _heads(heads)
        if op == NS_ATTN_FWD:
            return {"warpgroups": tsa.fwd_wgmma_grid(b, m, n, h, hkv, sms)[1]}
        if op == NS_ATTN_BWD:
            return {"cluster": tsa.bwd_wgmma_grid("dkv", b, m, n, h, hkv, sms)[1]}
        return {"splits": tsa.decode_splits(b, hkv, n, sms)}
    return None


def _card_tile(op: str, route: str, launch: Optional[Dict[str, int]]) -> Tuple[int, int]:
    """(bm, bn) a card candidate records: the C tile its kernel runs."""
    from repro_torch.kernels import build

    op = base_namespace(op)
    if route == "wgmma":
        bm, bn = build.WGMMA_TILE
        return bm, bn * (2 if launch.get("wide") else 1) // (2 if op == NS_GLU else 1)
    if route == "tn":
        bm, bn = build.WGMMA_TILE
        return bm, bn // 2 if op == NS_TN_UPDATE_DUAL else bn
    if route == "attn":
        return (build.ATTN_TILE[0], build.DECODE_CHUNK) if op == NS_ATTN_DECODE else build.ATTN_TILE
    return build.TILE


def _card_launches(op: str, m: int, n: int, k: int, dtype, sms: int,
                   heads: Optional[Tuple[int, int, int]]) -> List[Dict[str, int]]:
    """Every launch the card's kernel accepts for the measured call, the
    rule's first; equivalent launches (a group the CTAs clip to the same
    one) appear once."""
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk

    seed = rule_launch(op, m, n, k, dtype, sms=sms, heads=heads)
    if seed is None:
        return []
    route = card_route(op, m, n, k, dtype)
    base = base_namespace(op)
    out, seen = [seed], set()

    def add(launch, effective):
        if effective not in seen:
            seen.add(effective)
            if launch != seed:
                out.append(launch)

    if route == "cluster":
        seen.add(seed["layers"])
        for layers in (1, 2, 4, 8):
            if tk.forced_cluster_layers(k, layers) == layers:
                add({"layers": layers}, layers)
    elif route == "wgmma":
        glu = base == NS_GLU
        cfg = tk.wgmma_launch(m, n, sms, glu, 1, seed)
        seen.add(cfg)
        for wide in (0, 1):
            for group in (1, 2, 4, 8):
                cfg = tk.wgmma_launch(m, n, sms, glu, 1, {"wide": wide, "group": group})
                if group > 1 and cfg.mb * cfg.nb <= sms:
                    continue  # one task a CTA: no worker to group
                add({"wide": wide, "group": cfg.group}, cfg)
    elif route == "tn":
        dual, update = base in _DUAL, base in (NS_TN_UPDATE, NS_TN_UPDATE_DUAL)
        cfg = tk.tn_wgmma_launch(m, n, sms, dual, 1, update, seed["group"])
        seen.add(cfg)
        for group in (1, 2, 4, 8):
            cfg = tk.tn_wgmma_launch(m, n, sms, dual, 1, update, group)
            if group > 1 and cfg.mb * cfg.nb <= sms:
                continue
            add({"group": cfg.group}, cfg)
    else:
        b, h, hkv = _heads(heads)
        key, sizes = {NS_ATTN_FWD: ("warpgroups", tsa.fwd_warpgroup_sizes(h, hkv)),
                      NS_ATTN_BWD: ("cluster", tsa.dkv_cluster_sizes(h, hkv)),
                      NS_ATTN_DECODE: ("splits", tsa.decode_split_sizes(n))}[base]
        seen.add(seed[key])
        for size in sizes:
            add({key: size}, size)
    return out


def candidate_knobs(
    m: int,
    n: int,
    k: int,
    *,
    dtype_bytes: int = 4,
    max_candidates: int = 12,
    op: str = NS_GEMM,
    dtype=None,
    device: Device = "cpu",
    heads: Optional[Tuple[int, int, int]] = None,
) -> List[Knobs]:
    """Candidate sweep, the seed first (it always survives clipping).

    On the CPU: the JAX module's list exactly (``op``, ``dtype``, ``heads``
    unused).  On the card (``device`` cuda): one `Knobs` per launch the
    namespace's kernel accepts at this bucket (`card_route`), the rule's
    first, bm / bn the C tile it runs, k_layers and k_block_factor 1; just
    the seed, with no launch, where a tile kernel takes the call.
    ``dtype`` (the card's route depends on it) defaults to bfloat16 there;
    ``heads`` (batch, q heads, kv heads) places an attention candidate."""
    if not _on_card(device):
        return _host_candidates(m, n, k, dtype_bytes, max_candidates)
    dtype = torch.bfloat16 if dtype is None else dtype
    from repro_torch.core.device import sm_count

    route = card_route(op, m, n, k, dtype)
    launches = _card_launches(op, m, n, k, dtype, sm_count(torch.device(device)), heads)
    if not launches:
        bm, bn = _card_tile(op, route, None)
        return [Knobs(bm=bm, bn=bn, k_layers=1, k_block_factor=1)]
    return [Knobs(*_card_tile(op, route, launch), 1, 1, launch=launch) for launch in launches][:max_candidates]


# ---------------------------------------------------------------------------
# prediction: the perf model, per launch on the card
# ---------------------------------------------------------------------------


def _simulate_host(m, n, k, dtype, knobs: Knobs, op: str, hw: HardwareModel) -> Dict[str, float]:
    """The JAX module's ``_simulate_candidate``: one TPU worker team per K
    layer, serialized."""
    dtype_bytes = _dtype_bytes(dtype)
    op = base_namespace(op)
    if op in ATTN_OPS:
        if op == NS_ATTN_DECODE:
            r = simulate_decode_attention(1, max(m, 1), 1, n, k, hw=hw, dtype_bytes=dtype_bytes)
        else:
            r = simulate_flash_attention(
                1, 1, m, n, k, q_chunk=min(knobs.bm, m), k_chunk=min(knobs.bn, n), causal=True,
                phase="bwd" if op == NS_ATTN_BWD else "fwd", hw=hw, dtype_bytes=dtype_bytes,
            )
        return {"time_s": float(r["time_s"]), "n_flushes": 0.0, "flush_bytes": 0.0, "reuse_deficit_bytes": 0.0}
    mp = ((m + knobs.bm - 1) // knobs.bm) * knobs.bm
    np_ = ((n + knobs.bn - 1) // knobs.bn) * knobs.bn
    dual = op in _DUAL
    r = simulate_gemm(
        mp, np_, max(k, 1),
        n_workers=knobs.k_layers, k_layers=knobs.k_layers, k_block_factor=knobs.k_block_factor,
        bm=knobs.bm, bn=knobs.bn, hw=hw, dtype_bytes=dtype_bytes, n_b_mats=2 if dual else 1,
    )
    # each extra serialized layer repeats the traversal, its drains and its
    # first step's drain bytes
    t = float(r["time_s"]) + (knobs.k_layers - 1) * (
        float(r["gemm_time_s"]) + float(r["flush_time_s"]) + float(r["reuse_time_s"])
        + float(r["drain_time_s"]) + hw.drain_byte_s * float(r["drain_step_bytes"])
    )
    if op in (NS_TN_UPDATE, NS_TN_UPDATE_DUAL):
        sets = 2 if dual else 1
        t += sets * optimizer_update_bytes(mp, np_, fused=True, param_bytes=dtype_bytes) * hw.beta
    tiles = (mp // knobs.bm) * (np_ // knobs.bn)
    n_flushes = float(tiles * knobs.k_layers * knobs.k_block_factor)
    return {
        "time_s": t,
        "n_flushes": n_flushes,
        "flush_bytes": max(0.0, n_flushes - 1.0) * float(r["drain_step_bytes"]),
        "reuse_deficit_bytes": knobs.k_layers * float(r["reuse_deficit_bytes"]),
    }


def _worker_model(hw: HardwareModel, sms: int, workers: int, sms_a_worker: int) -> HardwareModel:
    """One of ``workers`` workers of ``sms_a_worker`` SMs each, all
    streaming at once: its share of the card's throughput and of its HBM
    rate, and ``sms_a_worker`` SMs' share of the L2 (``hw`` is a whole
    card's model, its fast memory one SM's)."""
    return dataclasses.replace(
        hw,
        gamma=hw.gamma * sms / max(sms_a_worker, 1),
        beta=hw.beta * max(workers, 1),
        fast_bytes=hw.fast_bytes * max(sms_a_worker, 1),
    )


def _simulate_card(m, n, k, dtype, knobs: Knobs, op: str, hw: HardwareModel, sms: int,
                   heads: Optional[Tuple[int, int, int]]) -> Dict[str, float]:
    """The perf model of one launch on the card.

    GEMMs: `simulate_gemm` over the launch's C tiles, split blockwise along
    the curve over its workers (a wgmma or TN worker is ``group`` CTAs, one
    an SM; the cluster kernel's L layers are the paper's K layers, one CTA
    an SM), each worker with its share of the card (`_worker_model`), so the
    wave count, the tile width's panel traffic and a group's shared panels
    enter the time.  Attention: the flash / decode census at the launch's
    effective kv re-reads (K11 reads k / v once per W q heads), its compute
    stretched by the idle SMs of its last wave (ceil(CTAs / SMs) x SMs /
    CTAs).  Returns the features `_simulate_host` returns."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sfc_gemm as tk

    launch = knobs.launch
    base = base_namespace(op)
    dtype_bytes = _dtype_bytes(dtype)
    route = card_route(op, m, n, k, dtype)
    if route == "attn":
        b, h, hkv = _heads(heads)
        groups = max(h // max(hkv, 1), 1)
        qc, kc = build.ATTN_TILE
        if base == NS_ATTN_DECODE:
            splits = launch["splits"]
            r = simulate_decode_attention(b, h, hkv, n, k, hw=hw, dtype_bytes=dtype_bytes)
            ctas = b * hkv * splits
            t = r["bytes"] * hw.beta * max(1.0, sms / ctas) + hw.launch_overhead_s
        else:
            if base == NS_ATTN_FWD:
                parts = groups // launch["warpgroups"]
                ctas = math.ceil(m / qc) * b * hkv * parts
                eff_kv = hkv * parts
            else:
                ctas = math.ceil(n / kc) * launch["cluster"] * b * hkv
                eff_kv = hkv
            r = simulate_flash_attention(b, h, m, n, k, q_chunk=qc, k_chunk=kc, causal=True,
                                         phase="bwd" if base == NS_ATTN_BWD else "fwd", hkv=eff_kv, hw=hw,
                                         dtype_bytes=dtype_bytes)
            stretch = math.ceil(ctas / sms) * sms / ctas
            t = max(r["flops"] * hw.gamma * stretch, r["bytes"] * hw.beta) + hw.launch_overhead_s * (
                2 if base == NS_ATTN_BWD else 1)
        return {"time_s": float(t), "n_flushes": 0.0, "flush_bytes": 0.0, "reuse_deficit_bytes": 0.0}
    dual = base in _DUAL
    layers = 1
    if route == "cluster":
        layers = tk.forced_cluster_layers(k, launch["layers"])
        bm, bn = m, build.TILE[1]
        mb, nb = 1, math.ceil(n / bn)
        workers = max(layers, min(nb * layers, sms) // layers * layers)
        hw_w = _worker_model(hw, sms, workers, 1)
    else:
        if route == "wgmma":
            cfg = tk.wgmma_launch(m, n, sms, base == NS_GLU, 1, launch)
        else:
            cfg = tk.tn_wgmma_launch(m, n, sms, dual, 1, base in (NS_TN_UPDATE, NS_TN_UPDATE_DUAL),
                                     launch.get("group"))
        bm, bn = _card_tile(op, route, {"wide": int(cfg.wide)})
        mb, nb = cfg.mb, cfg.nb
        workers = cfg.ctas // cfg.group
        hw_w = _worker_model(hw, sms, workers, cfg.group)
    r = simulate_gemm(
        mb * bm, nb * bn, max(k, 1), n_workers=workers, k_layers=layers, k_block_factor=1,
        bm=bm, bn=bn, hw=hw_w, dtype_bytes=dtype_bytes, n_b_mats=2 if dual else 1,
    )
    t = float(r["time_s"])
    if base in (NS_TN_UPDATE, NS_TN_UPDATE_DUAL):
        t += (2 if dual else 1) * optimizer_update_bytes(m, n, fused=True, param_bytes=dtype_bytes) * hw.beta
    n_flushes = float(mb * nb * layers)
    return {
        "time_s": t,
        "n_flushes": n_flushes,
        "flush_bytes": max(0.0, n_flushes - 1.0) * float(r["drain_step_bytes"]),
        "reuse_deficit_bytes": float(r["reuse_deficit_bytes"]),
    }


def _simulate_candidate(m, n, k, dtype, knobs: Knobs, *, op: str = NS_GEMM, hw: HardwareModel = TPU_V5E,
                        sms: int = H100_SMS, heads: Optional[Tuple[int, int, int]] = None) -> Dict[str, float]:
    """The perf model's time for one candidate, with the calibration
    features of the prediction (``n_flushes``, ``flush_bytes``,
    ``reuse_deficit_bytes``), so that `tune.calibrate` fits exactly what
    this later predicts with: a card launch (``knobs.launch``) through
    `_simulate_card`, else the JAX module's path."""
    if knobs.launch is not None:
        return _simulate_card(m, n, k, dtype, knobs, op, hw, sms, heads)
    return _simulate_host(m, n, k, dtype, knobs, op, hw)


def _measure_simulated(m, n, k, dtype, knobs: Knobs, *, op: str = NS_GEMM, hw: HardwareModel = TPU_V5E,
                       sms: int = H100_SMS, heads: Optional[Tuple[int, int, int]] = None) -> float:
    """The simulator's score (always available): the CPU's measurement."""
    return _simulate_candidate(m, n, k, dtype, knobs, op=op, hw=hw, sms=sms, heads=heads)["time_s"]


def predict_candidate(
    m: int, n: int, k: int, dtype, knobs: Knobs, *, op: str = NS_GEMM,
    hw: Optional[HardwareModel] = None, device: Device = "cpu",
    heads: Optional[Tuple[int, int, int]] = None,
) -> float:
    """Modelled seconds for one candidate under the calibrated model (no
    kernel runs).  ``hw`` omitted: the device's persisted calibration
    (`tune.calibrate.resolve_hardware_model`), its data-sheet base if it
    was never calibrated."""
    sms = H100_SMS
    if _on_card(device):
        from repro_torch.core.device import sm_count

        sms = sm_count(torch.device(device))
    if hw is None:
        from repro_torch.tune.calibrate import resolve_hardware_model

        hw = resolve_hardware_model(device=device)
    return _measure_simulated(m, n, k, dtype, knobs, op=op, hw=hw, sms=sms, heads=heads)


# ---------------------------------------------------------------------------
# measurement on the card
# ---------------------------------------------------------------------------


def _op_operand_shapes(op: str, m: int, n: int, k: int):
    """Operand shapes of one measured GEMM call at the resolver's bucket
    (m, n, k), the JAX module's: NT takes (m, k) and the untransposed
    (n, k); TN (and the update flush) contracts over k rows into (m, n)."""
    op = base_namespace(op)
    if op in (NS_NT, NS_NT_DUAL):
        return (m, k), (n, k), None
    if op in _TN_OPS:
        return (k, m), (k, n), None
    if op == NS_GLU:
        return (m, k), (k, n), (k, n)
    return (m, k), (k, n), None


def _gemm_call(op: str, m: int, n: int, k: int, dtype, device: torch.device):
    """(fn(i), input sets) of one measured GEMM call: the namespace's entry
    point of `kernels.ops` on the i-th set of random operands."""
    from repro_torch.kernels import ops
    from repro_torch.tune.timing import rotation

    base = base_namespace(op)
    dt = _torch_dtype(dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    sa, sb, sbg = _op_operand_shapes(op, m, n, k)
    elem = torch.empty((), dtype=dt).element_size()
    set_bytes = elem * (math.prod(sa) + math.prod(sb) * (2 if sbg else 1))
    sets = rotation(set_bytes)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dt)

    a = [rand(sa) for _ in range(sets)]
    b = [rand(sb) for _ in range(sets)]
    bg = [rand(sbg) for _ in range(sets)] if sbg else None
    if base in (NS_TN_UPDATE, NS_TN_UPDATE_DUAL):
        from repro_torch.optim.adamw import AdamWConfig, pack_adamw_hyper

        hyper = pack_adamw_hyper(AdamWConfig(), torch.ones((), dtype=torch.int32, device=device),
                                 torch.ones((), dtype=torch.float32, device=device))
        state = [torch.zeros((m, n), dtype=torch.float32, device=device) for _ in range(3)]
        w = torch.zeros((m, n), dtype=dt, device=device)
        if base == NS_TN_UPDATE_DUAL:
            state2 = [torch.zeros((m, n), dtype=torch.float32, device=device) for _ in range(3)]
            w2 = torch.zeros_like(w)
            return (lambda i: ops.sfc_matmul_tn_update(a[i % sets], b[i % sets], *state, hyper, b[i % sets],
                                                       *state2, w=w, w2=w2)), sets
        return (lambda i: ops.sfc_matmul_tn_update(a[i % sets], b[i % sets], *state, hyper, w=w)), sets
    calls = {
        NS_GEMM: lambda i: ops.sfc_matmul(a[i % sets], b[i % sets]),
        NS_GLU: lambda i: ops.sfc_glu_matmul(a[i % sets], bg[i % sets], b[i % sets]),
        NS_NT: lambda i: ops.sfc_matmul_nt(a[i % sets], b[i % sets]),
        NS_NT_DUAL: lambda i: ops.sfc_matmul_nt(a[i % sets], b[i % sets], a[i % sets], b[i % sets]),
        NS_TN: lambda i: ops.sfc_matmul_tn(a[i % sets], b[i % sets]),
        NS_TN_DUAL: lambda i: ops.sfc_matmul_tn(a[i % sets], b[i % sets], b[i % sets]),
    }
    return calls[base], sets


def _attn_call(op: str, m: int, n: int, k: int, dtype, device: torch.device, heads):
    """(fn(i), input sets) of one measured attention call at bucket (m, n,
    k): (Sq, Sk, D), or (H, T, D) for the decode, with ``heads`` (batch, q
    heads, kv heads)."""
    from repro_torch.core import attention_backend as ab
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.tune.timing import rotation

    base = base_namespace(op)
    b, h, hkv = _heads(heads)
    dt = _torch_dtype(dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    elem = torch.empty((), dtype=dt).element_size()

    def rand(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dt)

    if base == NS_ATTN_DECODE:
        sets = rotation(elem * (2 * b * n * hkv * k + b * h * k))
        q = [rand((b, 1, h, k)) for _ in range(sets)]
        kv = [rand((b, n, hkv, k)) for _ in range(sets)]
        valid = torch.full((b,), n, dtype=torch.int32, device=device)
        return (lambda i: ab.decode_attention(q[i % sets], kv[i % sets], kv[i % sets], valid)), sets
    sets = rotation(elem * (b * m * h * k + 2 * b * n * hkv * k))
    q = [rand((b, m, h, k)) for _ in range(sets)]
    kv = [rand((b, n, hkv, k)) for _ in range(sets)]
    if base == NS_ATTN_FWD:
        return (lambda i: ab.flash_attention(q[i % sets], kv[i % sets], kv[i % sets], causal=True)), sets

    def bwd(i):
        # the JAX module's attn_bwd score: the forward and both backward launches
        qi, ki = q[i % sets], kv[i % sets]
        knobs = ab.resolve_attn_knobs(m, n, k, dt, op=NS_ATTN_BWD, device=device)
        o, lse = tsa.sfc_flash_fwd(qi, ki, ki, causal=True)
        delta = (o.float() * o.float()).sum(dim=-1)
        tsa.sfc_flash_bwd_dq(qi, ki, ki, o, lse, delta, causal=True)
        return tsa.sfc_flash_bwd_dkv(qi, ki, ki, o, lse, delta, causal=True,
                                     cluster=(knobs.launch or {}).get("cluster"))

    return bwd, sets


def _measure_card(m, n, k, dtype, knobs: Knobs, *, op: str, device: torch.device,
                  heads: Optional[Tuple[int, int, int]] = None, min_reps: int = 20) -> float:
    """Seconds of one call of the namespace's kernel on the launch of
    ``knobs``, which the call resolves as the serve would: from an entry of
    a scratch in-memory `KnobCache` made the process-wide one for the
    timing (`using_cache`, which autograd's backward thread sees too).
    CUDA events around a captured graph of at least ``min_reps`` calls,
    each on its own input set, the sets rotated past the L2
    (`tune.timing`).  Raises whatever the build or launch raises."""
    from repro_torch.tune.timing import time_ms

    scratch = KnobCache(persist=False)
    scratch.put(m, n, k, dtype, _backend_name(device), knobs, op)
    if base_namespace(op) in ATTN_OPS:
        fn, sets = _attn_call(op, m, n, k, dtype, device, heads)
    else:
        fn, sets = _gemm_call(op, m, n, k, dtype, device)
    with torch.no_grad(), using_cache(scratch):
        ms = time_ms(fn, max(min_reps, sets), graph=True)
    return ms * 1e-3


def measure_candidate(
    m: int, n: int, k: int, dtype, knobs: Knobs, *, op: str = NS_GEMM, device: Device = "cpu",
    heads: Optional[Tuple[int, int, int]] = None,
) -> float:
    """Score (seconds, lower is better): the card's time of the launch
    (`_measure_card`), or on the CPU the data-sheet simulator's."""
    if _on_card(device):
        return _measure_card(m, n, k, dtype, knobs, op=op, device=torch.device(device), heads=heads)
    return _measure_simulated(m, n, k, dtype, knobs, op=op)


def lookup_knobs(
    m: int, n: int, k: int, dtype, *, cache: Optional[KnobCache] = None, op: str = NS_GEMM,
    device: Device = "cpu",
) -> Optional[Knobs]:
    """Cache-only consult (never measures): the resolvers' fast path."""
    cache = cache if cache is not None else default_cache()
    return cache.get(m, n, k, dtype, _backend_name(device), op)


def tune_gemm(
    m: int,
    n: int,
    k: int,
    dtype=np.float32,
    *,
    cache: Optional[KnobCache] = None,
    measure_fn: Optional[Callable[[int, int, int, object, Knobs], float]] = None,
    max_candidates: int = 12,
    force: bool = False,
    op: str = NS_GEMM,
    strategy: str = "predict",
    confirm_top: int = 2,
    report: Optional[List[Dict]] = None,
    device: Device = None,
    heads: Optional[Tuple[int, int, int]] = None,
) -> Knobs:
    """Tune (or fetch) the knobs of namespace ``op`` for one shape bucket
    on ``device`` (the card unless the caller names the CPU).

    A cache hit returns at once, measuring nothing (unless ``force``).  On
    a miss ``strategy`` picks the sweep: ``"predict"`` ranks every
    candidate with the calibrated model and measures the ``confirm_top``
    best (``0``: none, the top-ranked wins with source "predicted"), the
    card's rule always among them; ``"exhaustive"`` measures every
    candidate.  ``measure_fn(m, n, k, dtype, knobs[, op=])`` replaces the
    measurement.  With ``report`` a list, one dict per measured candidate
    is appended (op, bucket, knobs, predicted_s, measured_s; on the card
    also launch and whether it is the rule's)."""
    if base_namespace(op) not in TUNE_OPS:
        raise ValueError(
            f"unknown tune namespace {op!r}; pick from {TUNE_OPS} (or a schedule-qualified form base@<spec-key>)"
        )
    if strategy not in ("predict", "exhaustive"):
        raise ValueError(f"unknown strategy {strategy!r}; pick 'predict' or 'exhaustive'")
    device = _device(device)
    cache = cache if cache is not None else default_cache()
    backend = _backend_name(device)
    if not force:
        hit = cache.get(m, n, k, dtype, backend, op)
        if hit is not None:
            return hit
    return _tune_sweep(m, n, k, dtype, cache=cache, backend=backend, measure_fn=measure_fn,
                       max_candidates=max_candidates, op=op, strategy=strategy, confirm_top=confirm_top,
                       report=report, device=device, heads=heads)


def _tune_sweep(m, n, k, dtype, *, cache: KnobCache, backend: str, measure_fn, max_candidates: int, op: str,
                strategy: str, confirm_top: int, report: Optional[List[Dict]], device: torch.device,
                heads) -> Knobs:
    card = device.type == "cuda"
    if measure_fn is None:
        measure = functools.partial(measure_candidate, op=op, device=device, heads=heads)
    elif op != NS_GEMM:
        import inspect

        params = inspect.signature(measure_fn).parameters
        if not ("op" in params or any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())):
            raise ValueError(f"measure_fn {measure_fn!r} does not accept op=; a {op!r} sweep scored with the "
                             "single-B measurement would persist a mis-scored winner")
        measure = functools.partial(measure_fn, op=op)
    else:
        measure = measure_fn
    cands = candidate_knobs(m, n, k, dtype_bytes=_dtype_bytes(dtype), max_candidates=max_candidates, op=op,
                            dtype=dtype, device=device, heads=heads)
    if card and cands[0].launch is None:
        # a tile kernel takes the call: nothing to choose, nothing measured
        best = dataclasses.replace(cands[0], source="analytical")
        cache.put(m, n, k, dtype, backend, best, op)
        return best

    predictions: Dict[int, float] = {}
    to_measure: Sequence[int] = range(len(cands))
    if strategy == "predict" or report is not None:
        from repro_torch.tune.calibrate import resolve_hardware_model

        hw = resolve_hardware_model(cache, device=device)
        for i, cand in enumerate(cands):
            predictions[i] = predict_candidate(m, n, k, dtype, cand, op=op, hw=hw, device=device, heads=heads)
    if strategy == "predict" and predictions:
        ranked = sorted(predictions, key=predictions.get)
        to_measure = ranked[: max(0, confirm_top)]
        if card and confirm_top > 0 and 0 not in to_measure:
            to_measure = [0, *to_measure]  # the rule is always measured on the card

    best: Optional[Knobs] = None
    best_i = None
    for i in to_measure:
        cand = cands[i]
        t = float(measure(m, n, k, dtype, cand))
        if report is not None:
            row = {
                "op": op,
                "bucket": "x".join(map(str, shape_bucket(m, n, k))),
                "knobs": (cand.bm, cand.bn, cand.k_layers, cand.k_block_factor),
                "predicted_s": predictions.get(i),
                "measured_s": t,
            }
            if card:
                row.update(launch=cand.launch, rule=i == 0)
            report.append(row)
        if best is None or t < best.time_s:
            best, best_i = dataclasses.replace(cand, source="measured", time_s=t), i
    if best is None and strategy == "predict" and predictions and confirm_top == 0:
        best_i = min(predictions, key=predictions.get)
        best = dataclasses.replace(cands[best_i], source="predicted", time_s=predictions[best_i])
    if best is None:
        best_i, best = 0, dataclasses.replace(cands[0], source="analytical")
    if card and best_i == 0:
        best = dataclasses.replace(best, launch=None)  # the rule's, at every shape of the bucket
    cache.put(m, n, k, dtype, backend, best, op)
    if best.source != "analytical":
        _lift_quarantines(op, cache)
    return best


def _lift_quarantines(op: str, cache: KnobCache) -> None:
    """A confirmed winner vouches for the kernel path again: lift ``op``'s
    ladder quarantines so the kernel rung is retried with the fresh knobs
    instead of staying degraded forever, and persist the lift (``put_health``
    replaces the ``__health__|`` set, so a fresh process no longer reloads
    the quarantine this re-tune healed).  The analytical fall-back vouches
    for nothing and lifts nothing."""
    from repro_torch.robust.ladder import get_registry

    reg = get_registry()
    cleared = reg.clear(namespace=op)
    if cleared:
        reg.save_to_cache(cache)
        print(f"[tune] {op}: re-tune lifted {cleared} ladder quarantine(s)")
