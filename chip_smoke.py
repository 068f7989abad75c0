#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout (src/repro_torch/kernels/csrc: the GEMM library with its forward
and backward parts and the attention library with its forward, decode and
backward parts, all compiled at once), then runs six phases, each printing
one JSON line and raising on failure:

1. device     the card's name and power limit (nvidia-smi) and the build time;
2. kernels    each kernel against its plain PyTorch version at the shapes the
              qwen3-4b server and trainer run, timed beside its bound and
              one PyTorch call of the same function: the SFC fused GEMM
              (K1/K2) at every serve shape (decode M=4, batched prefill
              4 x 128, the LM head), every training-forward shape (2 x 256,
              the GLU in its preact mode) and one ragged case with every
              epilogue flag; the NT (K7, dA) and TN (K8, dW) kernels at every
              training shape, single and dual, plus a ragged f32 case each;
              K8's update mode (AdamW in the flush, bf16 W stochastically
              rounded) and norm mode at every training shape, in bf16 and
              f32;
              the band flash forward (K11) at the prefill and training shapes
              and at 1 x 2000 with q_offset 0 and 48; the dense flash forward
              (K15); the decode attention (K14) at the serve's cache and at a
              4096-row cache; the flash backward (K12 dQ, K13 dK/dV) at the
              training shape and a ragged GQA f32 case with S != T;
3. grad check full-width qwen3-4b cut to 4 layers, f32, batch 2 x 256: the
              loss and every parameter's gradient under sfc_cuda GEMMs with
              attn_impl="sfc" against the torch backend with blockwise
              attention, within the bf16 bound; every projection weight has
              a non-zero gradient; then the fused optimizer's step (AdamW in
              K8's update flush, exact clip in two phases) against the
              unfused sfc_cuda step from the same init, with a clip that
              binds, for two steps, and a third step whose gradients are
              all NaN, which must leave every weight and state bitwise;
4. serve      ServingEngine serves full-width qwen3-4b (36 layers, bf16,
              random weights from a seeded torch.Generator), 4 requests,
              prompt 128, 16 new tokens, three times: sfc_cuda GEMMs with
              blockwise attention (exactly 217 x 16 GEMM launches), sfc_cuda
              GEMMs with attn_impl="sfc" (exactly 3,472 GEMM, 36 K11 and 540
              K14 launches), and the torch backend.  A prefill under
              attn_impl="flash_pallas" must launch K15 36 times.  The prefill
              logits of the same weights in f32 must agree with the torch
              backend's within the bf16 bound for each sfc_cuda variant, and
              each variant's bf16 logits must be as close to that f32 model as
              the torch backend's are;
5. train      `launch.train.build_trainer` trains full-width qwen3-4b (36
              layers, bf16, AdamW on f32 master weights) for 3 steps of
              2 x 256 SyntheticLM tokens under sfc_cuda + attn_impl="sfc",
              with exactly 217 K1/K2, 217 K7, 217 K8, 36 K11, 36 K12 and 36
              K13 launches per step, then the same 3 steps from the same
              init under torch + blockwise: every loss finite and within
              2^-7 of the torch backend's, every parameter changed; step
              times and peak memory, and a fourth step of each run under
              torch.profiler for its device-busy time by kernel group.  A
              third run, between them, trains the same 3 steps with
              fused_optimizer=True (K8 in its norm and update modes, exactly
              217 of each and no dW launch per step, no weight left with a
              .grad), its losses within 2^-7 of the unfused run's;
6. the {"kernels": [...]} line: per kernel and shape, launches in the run
              of its path (serve or train), max error, kernel / plain /
              library times and the bound.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository's src/repro_torch beside this file, it exits non-zero
and prints no result.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of every kernel row
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2**20

# stated tolerances (kernel against its plain version, both f32-accumulated
# in different orders): f32 inputs at rtol 1e-4 (plus 1e-5 of the largest
# |value| for sums that cancel to near zero); bf16 inputs within one output
# rounding: |k - p| <= 2^-7 |p| + 1e-3 max|p|
F32_RTOL, F32_ATOL_REL = 1e-4, 1e-5
BF16_RTOL, BF16_ATOL_REL = 2.0**-7, 1e-3

PROMPT, NEW_TOKENS, BATCH = 128, 16, 4
# the trainer: 2 sequences of 256 tokens, 3 AdamW steps; the f32 gradient
# check cuts the model to 4 layers (full width)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 256, 3
GRAD_CHECK_LAYERS = 4
# a training loss may differ from the torch backend's by one bf16 rounding
TRAIN_LOSS_RTOL = 2.0**-7
# the fused-step check: a clip far under the gradient norm, so it binds
FUSED_CHECK_CLIP = 1e-3

# bf16 serving: the sfc_cuda prefill logits may be at most this many times
# further (mean |error|) from the same model run in f32 than the torch
# backend's bf16 logits are
ACCURACY_PARITY = 1.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def within(got, want, dtype):
    """(ok, max_abs_err, worst err/bound) under the stated tolerance."""
    import torch

    g, p = got.float(), want.float()
    err = (g - p).abs()
    mag = p.abs()
    if dtype == torch.float32:
        bound = F32_RTOL * mag + F32_ATOL_REL * mag.max()
    else:
        bound = BF16_RTOL * mag + BF16_ATOL_REL * mag.max()
    ok = bool(torch.isfinite(g).all()) and bool((err <= bound).all())
    worst = float((err / bound.clamp_min(1e-30)).max())
    return ok, float(err.max()), worst


def within_all(got, want, dtype):
    """`within` over a tensor or over matching tuples of tensors."""
    if not isinstance(got, (tuple, list)):
        return within(got, want, dtype)
    res = [within(g, w, dtype) for g, w in zip(got, want)]
    return all(r[0] for r in res), max(r[1] for r in res), max(r[2] for r in res)


def time_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of fn(i) over reps calls, by CUDA events.  With
    ``graph`` the reps calls are captured once in a CUDA graph and one
    replay is timed, so the host's per-call cost (Python, argument checks)
    does not leave the card idle between short kernels."""
    import torch

    # warm up on a side stream, as capturing autograd's backward requires
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(reps):
                fn(i)
        g.replay()  # first replay uploads the graph
        run = g.replay
    else:
        def run():
            for i in range(reps):
                fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One GEMM of the main path: (batch, M) rows against (K, N) weights."""

    name: str
    mode: str  # "decode" (plain kernel mode) | "prefill" | "train" (batched mode)
    batch: int  # 0 = plain mode
    m: int
    k: int
    n: int
    glu: bool = False
    preact: bool = False  # the training forward's GLU: both pre-activations out

    @property
    def path(self) -> str:
        return "train" if self.mode == "train" else "serve"

    @property
    def key(self):
        return (self.batch, self.m, self.k, self.n, self.glu)

    @property
    def rows(self) -> int:
        return max(self.batch, 1) * self.m

    def flops(self) -> float:
        return 2.0 * self.rows * self.k * self.n * (2 if self.glu else 1)

    def bytes(self, elem: int) -> float:
        outs = 2 if self.preact else 1
        return elem * (self.rows * self.k + self.k * self.n * (2 if self.glu else 1) + outs * self.rows * self.n)

    def bound(self, elem: int, peak_flops: float):
        return _bound(self.flops(), self.bytes(elem), peak_flops)


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms, what bounds it) over the H100 SXM peaks."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _projections(cfg):
    """(name, K, N, glu) of each projection of a layer, forward (M, K) @ (K, N)."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim_
    kv = cfg.kv_heads * cfg.head_dim_
    return [("q", d, q, False), ("k,v", d, kv, False), ("o", q, d, False),
            ("mlp_glu", d, cfg.d_ff, True), ("mlp_out", cfg.d_ff, d, False)]


def main_path_gemms(cfg):
    """Every distinct forward GEMM the server and the trainer launch for
    this config: the decode step's (M = batch rows, flattened) and the
    batched prefill's, plus the LM head on the last position (plain mode in
    both phases); the training forward's, batched over 2 x 256 tokens, the
    GLU in its preact mode and the LM head on every position."""
    proj = _projections(cfg)
    d = cfg.d_model
    out = [Gemm(f"decode/{n}", "decode", 0, BATCH, k, nn, g) for n, k, nn, g in proj]
    out.append(Gemm("head", "decode", 0, BATCH, d, cfg.vocab))
    out += [Gemm(f"prefill/{n}", "prefill", BATCH, PROMPT, k, nn, g) for n, k, nn, g in proj]
    out += [Gemm(f"train/{n}", "train", TRAIN_BATCH, TRAIN_SEQ, k, nn, g, preact=g) for n, k, nn, g in proj]
    out.append(Gemm("train/head", "train", TRAIN_BATCH, TRAIN_SEQ, d, cfg.vocab))
    return out


@dataclasses.dataclass(frozen=True)
class BwdGemm:
    """One backward GEMM of the training step for the forward projection
    (M, K) @ (K, N): K7 ("nt", dA (M, K) = dC (M, N) W (K, N)^T) or K8
    ("tn", dW (K, N) = A (M, K)^T dC (M, N)); dual for the GLU."""

    name: str
    kind: str
    m: int
    k: int
    n: int
    dual: bool = False

    @property
    def key(self):  # the launches_by_shape key of sfc_gemm_nt / sfc_gemm_tn
        return (self.m, self.k, self.n, self.dual) if self.kind == "nt" else (self.k, self.n, self.m, self.dual)

    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * (2 if self.dual else 1)

    def bytes(self, elem: int) -> float:
        pairs = 2 if self.dual else 1
        if self.kind == "nt":  # dC and W (twice when dual) in, dA out
            return elem * (pairs * (self.m * self.n + self.k * self.n) + self.m * self.k)
        return elem * (self.m * self.k + pairs * (self.m * self.n + self.k * self.n))  # A, dC in; dW out


def train_backward_gemms(cfg):
    """K7 and K8 at every projection of the training step (2 x 256 token
    rows), the LM head included."""
    rows = TRAIN_BATCH * TRAIN_SEQ
    proj = _projections(cfg) + [("head", cfg.d_model, cfg.vocab, False)]
    return [BwdGemm(f"train/{name}", kind, rows, k, n, glu) for kind in ("nt", "tn") for name, k, n, glu in proj]


@dataclasses.dataclass(frozen=True)
class Attn:
    """One attention launch: a flash forward over (b, s) queries against
    (b, t) keys, or a decode step against a t-row cache with live lengths
    ``valid``."""

    name: str
    kernel: str  # "sfc_flash_fwd" (K11) | "flash_attention" (K15) | "sfc_decode_attention" (K14)
    b: int
    s: int
    t: int
    h: int
    hkv: int
    d: int
    causal: bool = True
    q_offset: int = 0
    valid: tuple = ()
    main_path: bool = True
    path: str = "serve"  # the run whose launches the row reports

    @property
    def decode(self) -> bool:
        return self.kernel == "sfc_decode_attention"

    def pairs(self) -> int:
        """(query, key) pairs attended over the batch and q heads: what
        these inputs need, not the padded tiles."""
        if self.decode:
            return sum(self.valid) * self.h
        if not self.causal:
            return self.b * self.h * self.s * self.t
        return self.b * self.h * sum(min(i + self.q_offset + 1, self.t) for i in range(self.s))

    def bytes(self, elem: int) -> float:
        """Each input read once and each output written once: q, the keys and
        values (the live cache rows for decode), o, and the f32 lse of K11."""
        if self.decode:
            return elem * (2 * self.b * self.h * self.d + 2 * sum(self.valid) * self.hkv * self.d) + 4 * self.b
        qo = 2 * self.b * self.s * self.h * self.d
        lse = 4 * self.b * self.s * self.h if self.kernel == "sfc_flash_fwd" else 0
        return elem * (qo + 2 * self.b * self.t * self.hkv * self.d) + lse

    def bound(self, elem: int):
        return _bound(4.0 * self.d * self.pairs(), self.bytes(elem))

    def shape(self) -> dict:
        out = {"b": self.b, "s": self.s, "t": self.t, "h": self.h, "hkv": self.hkv, "d": self.d}
        out.update({"valid": list(self.valid)} if self.decode else {"causal": self.causal, "q_offset": self.q_offset})
        return out


def attention_cases(cfg):
    """The attention launches of the main paths (the serve's prefill and
    decode) and two long ragged checks of each kernel family."""
    heads = dict(h=cfg.n_heads, hkv=cfg.kv_heads, d=cfg.head_dim_)
    cache = PROMPT + NEW_TOKENS + 1
    return [
        Attn("prefill", "sfc_flash_fwd", BATCH, PROMPT, PROMPT, **heads),
        Attn("train", "sfc_flash_fwd", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, path="train", **heads),
        Attn("long_1x2000", "sfc_flash_fwd", 1, 2000, 2000, main_path=False, **heads),
        Attn("long_1x2000_q_offset_48", "sfc_flash_fwd", 1, 2000, 2048, q_offset=48, main_path=False, **heads),
        Attn("prefill", "flash_attention", BATCH, PROMPT, PROMPT, **heads),
        Attn("decode", "sfc_decode_attention", BATCH, 1, cache, valid=(129, 134, 139, 144), **heads),
        Attn("long_cache_4096", "sfc_decode_attention", BATCH, 1, 4096, valid=(1, 1000, 2048, 4096),
             main_path=False, **heads),
    ]


def phase_attention(torch, cases, tsa, tfa, build):
    """Attention kernels against their plain versions, timed beside their
    bound and scaled_dot_product_attention (a yardstick the port never
    calls)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    dt = torch.bfloat16
    qc, kc = tsa.kernel_chunks()
    rows, checks = [], []
    for c in cases:
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa: E731
        # enough copies that a timed loop streams its inputs from HBM
        copies = max(1, math.ceil(4 * L2_BYTES / c.bytes(2)))
        ins = [(r(c.b, c.s, c.h, c.d), r(c.b, c.t, c.hkv, c.d), r(c.b, c.t, c.hkv, c.d)) for _ in range(copies)]
        mask = None
        if c.decode:
            valid = torch.tensor(c.valid, dtype=torch.int32, device=dev)
            mask = (torch.arange(c.t, device=dev)[None, :] < valid[:, None])[:, None, None, :]

            def kernel(i):
                return tsa.sfc_decode_attention(*ins[i % copies], valid)

            def plain(i):
                return tsa.sfc_decode_attention_plain(*ins[i % copies], valid, k_chunk=build.DECODE_CHUNK)
        elif c.kernel == "sfc_flash_fwd":
            kw = dict(causal=c.causal, q_offset=c.q_offset)

            def kernel(i):
                return tsa.sfc_flash_fwd(*ins[i % copies], **kw)

            def plain(i):
                return tsa.sfc_flash_fwd_plain(*ins[i % copies], q_chunk=qc, k_chunk=kc, **kw)
        else:
            def kernel(i):
                return tfa.flash_attention(*ins[i % copies], causal=c.causal)

            def plain(i):
                return tfa.flash_attention_plain(*ins[i % copies], causal=c.causal, q_chunk=qc, k_chunk=kc)
        if not c.decode and c.causal and (c.q_offset or c.s != c.t):
            qpos = torch.arange(c.s, device=dev)[:, None] + c.q_offset
            mask = torch.arange(c.t, device=dev)[None, :] <= qpos
        views = [tuple(x.transpose(1, 2) for x in trio) for trio in ins]
        causal_flag = not c.decode and c.causal and mask is None
        library = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            *views[i % copies], attn_mask=mask, is_causal=causal_flag, enable_gqa=True)
        got, want = kernel(0), plain(0)
        torch.cuda.synchronize()
        if c.kernel == "sfc_flash_fwd":
            (got, got_lse), (want, want_lse) = got, want
            ok_lse, err_lse, worst_lse = within(got_lse, want_lse, torch.float32)
        else:
            ok_lse, err_lse, worst_lse = True, 0.0, 0.0
        ok, err, worst = within(got, want, dt)
        checks.append({"case": f"{c.kernel}:{c.name}", "shape": c.shape(), "ok": ok and ok_lse, "max_abs_err": err,
                       "err_over_bound": worst, "lse_max_abs_err": err_lse, "lse_err_over_bound": worst_lse})
        if not (ok and ok_lse):
            raise AssertionError(f"{c.kernel} disagrees with its plain version at {c}: max err {err} "
                                 f"(err/bound {worst}), lse max err {err_lse} (err/bound {worst_lse})")
        reps = max(20, copies)
        ms = time_ms(kernel, reps=reps, graph=True)
        lib_ms = time_ms(library, reps=reps, graph=True)
        plain_ms = time_ms(plain, reps=2, warmup=1)
        bound_ms, bound_by = c.bound(2)
        rows.append(dict(case=c, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        del ins, views
    return rows, checks


def phase_kernels(torch, cfg, gemms, tk, ops):
    """Kernel against plain version at the main path's shapes, timed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = torch.bfloat16
    rows = []
    checks = []
    for gm in gemms:
        lead = (gm.batch,) if gm.batch else ()
        a = torch.randn((*lead, gm.m, gm.k), generator=gen, device=dev).to(dt)
        # enough weight copies that a timed loop streams them from HBM, as
        # the 8.8 GB model does, instead of finding them in the 50 MB L2
        w_bytes = gm.k * gm.n * 2 * (2 if gm.glu else 1)
        copies = max(1, math.ceil(4 * L2_BYTES / w_bytes))
        ws = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)]
        gs = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)] if gm.glu else None
        # the serve's GLU applies its activation in the flush; the training
        # forward's (preact) flushes both pre-activations
        kw = dict(preact=True) if gm.preact else dict(activation=cfg.act if gm.glu else None)

        def kernel(i):
            return tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies] if gs else None, **kw)

        bm, bn, _ = ops.pick_blocks(gm.m, gm.n, gm.k)

        def plain(i):
            return tk.sfc_gemm_fused_plain(a, ws[i % copies], gs[i % copies] if gs else None, bm=bm, bn=bn, **kw)

        got, want = kernel(0), plain(0)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": gm.name, "shape": [gm.batch, gm.m, gm.k, gm.n], "glu": gm.glu, "preact": gm.preact,
                       "ok": ok, "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version at {gm}: max err {err}, err/bound {worst}")
        if gm.glu:
            cats = [torch.cat([g, w], dim=1) for g, w in zip(gs, ws)]
            library = lambda i: torch.matmul(a, cats[i % copies])  # noqa: E731
        else:
            library = lambda i: torch.matmul(a, ws[i % copies])  # noqa: E731
        ms = time_ms(kernel, reps=max(20, copies), graph=True)
        lib_ms = time_ms(library, reps=max(20, copies), graph=True)
        plain_ms = time_ms(plain, reps=2, warmup=1)
        bound_ms, bound_by = gm.bound(2, PEAK_BF16_FLOPS)
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        del ws, gs, a
        if gm.glu:
            del cats
    # one ragged case with every epilogue flag, in both input types
    for dtype in (torch.float32, torch.bfloat16):
        m, k, n = 77, 203, 133
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        args = (r(3, m, k), r(k, n) * 0.1, r(k, n) * 0.1, r(n), r(1, n), r(3, m, n))
        kw = dict(activation="gelu", out_scale=0.7)
        got = tk.sfc_gemm_fused(*args, **kw)
        torch.cuda.synchronize()
        ok, err, worst = within(got, tk.sfc_gemm_fused_plain(*args, bm=32, bn=32, **kw), dtype)
        checks.append({"case": "all_epilogue_flags_ragged", "dtype": str(dtype), "shape": [3, m, k, n],
                       "ok": ok, "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"all-flags ragged case ({dtype}) disagrees: max err {err}")
    return rows, checks


def phase_backward_gemms(torch, gemms, tk, ops):
    """K7 and K8 against their plain versions at every training shape
    (bf16), timed beside their bound and torch.matmul of the same product;
    plus one ragged f32 case of each (dual)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    dt = torch.bfloat16
    rows, checks = [], []

    def r(*shape, dtype=dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def operands(gm, dtype):
        """(args of the wrapper, args of torch.matmul's yardstick)."""
        m, k, n = gm.m, gm.k, gm.n
        if gm.kind == "nt":
            dc, w = r(m, n, dtype=dtype), r(k, n, dtype=dtype, scale=0.02)
            if not gm.dual:
                return (dc, w), (dc, w.T)
            dc2, w2 = r(m, n, dtype=dtype), r(k, n, dtype=dtype, scale=0.02)
            return (dc, w, dc2, w2), (torch.cat([dc, dc2], 1), torch.cat([w, w2], 1).T)
        x, dc = r(m, k, dtype=dtype), r(m, n, dtype=dtype)
        if not gm.dual:
            return (x, dc), (x.T, dc)
        dc2 = r(m, n, dtype=dtype)
        return (x, dc, dc2), (x.T, torch.cat([dc, dc2], 1))

    for gm in gemms:
        fn, plain_fn = (tk.sfc_gemm_nt, tk.sfc_gemm_nt_plain) if gm.kind == "nt" else (tk.sfc_gemm_tn, tk.sfc_gemm_tn_plain)
        out_rows, out_cols = (gm.m, gm.k) if gm.kind == "nt" else (gm.k, gm.n)
        bm, bn, _ = ops.pick_blocks(out_rows, out_cols, gm.n if gm.kind == "nt" else gm.m)
        # enough input copies that a timed loop streams them from HBM
        copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2)))
        ins = [operands(gm, dt) for _ in range(copies)]
        got, want = fn(*ins[0][0]), plain_fn(*ins[0][0], bm=bm, bn=bn)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": f"{gm.kind}:{gm.name}", "shape": [gm.m, gm.k, gm.n], "dual": gm.dual, "ok": ok,
                       "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"sfc_gemm_{gm.kind} disagrees with its plain version at {gm}: max err {err}, "
                                 f"err/bound {worst}")
        reps = max(20, copies)
        ms = time_ms(lambda i: fn(*ins[i % copies][0]), reps=reps, graph=True)
        lib_ms = time_ms(lambda i: torch.matmul(*ins[i % copies][1]), reps=reps, graph=True)
        plain_ms = time_ms(lambda i: plain_fn(*ins[i % copies][0], bm=bm, bn=bn), reps=2, warmup=1)
        bound_ms, bound_by = _bound(gm.flops(), gm.bytes(2))
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        del ins, got, want
    for kind in ("nt", "tn"):
        gm = BwdGemm("ragged_f32", kind, 77, 203, 133, dual=True)
        args, _ = operands(gm, torch.float32)
        plain_fn = tk.sfc_gemm_nt_plain if kind == "nt" else tk.sfc_gemm_tn_plain
        got = (tk.sfc_gemm_nt if kind == "nt" else tk.sfc_gemm_tn)(*args)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, plain_fn(*args, bm=32, bn=32), torch.float32)
        checks.append({"case": f"{kind}:ragged_dual_f32", "shape": [gm.m, gm.k, gm.n], "ok": ok,
                       "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"sfc_gemm_{kind} ragged f32 case disagrees: max err {err}")
    return rows, checks


@dataclasses.dataclass(frozen=True)
class UpdGemm:
    """K8 in its update or norm mode for the forward projection (M, K) @
    (K, N): dW (K, N) = A^T dC in the f32 accumulator, then AdamW against
    the f32 master / mu / nu and W written (update), or only sum(dW^2)
    (norm); dual for the GLU."""

    name: str
    mode: str  # "update" | "norm"
    m: int
    k: int
    n: int
    dual: bool = False

    @property
    def key(self):  # sfc_gemm_tn.launches_by_shape's key for the mode
        return (self.k, self.n, self.m, self.dual, self.mode)

    @property
    def sets(self) -> int:
        return 2 if self.dual else 1

    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * self.sets

    def bytes(self, elem: int) -> float:
        """A and dC read once; update: 12 B of f32 state read and 14 B (the
        state and W) written per weight element; norm: the per-task
        partials."""
        operands = elem * (self.m * self.k + self.sets * self.m * self.n)
        if self.mode == "update":
            return operands + 26.0 * self.sets * self.k * self.n
        return operands + 4.0 * self.sets * math.ceil(self.k / 64) * math.ceil(self.n / 64)


def train_update_gemms(cfg):
    """K8's update mode at every projection of the training step (its norm
    mode runs the same shapes)."""
    rows = TRAIN_BATCH * TRAIN_SEQ
    proj = _projections(cfg) + [("head", cfg.d_model, cfg.vocab, False)]
    return [UpdGemm(f"train/{name}", "update", rows, k, n, glu) for name, k, n, glu in proj]


def phase_update_gemms(torch, cfg, tk, opt):
    """K8's update and norm modes against their plain versions at every
    training shape, in bf16 (stochastic rounding on, the main path, timed)
    and in f32: master, mu and nu within the f32 bound; a bf16 W bitwise the
    stochastic rounding of the kernel's own master with the plain version's
    tile bits (the counter hash) and within the bf16 bound of the plain W
    (the two masters differ in their last bits, and a rounding with the
    same bits may then land one ulp apart), an f32 W the new master; the
    norms within the f32 bound, the norm mode's bitwise the update mode's.
    Yardstick: torch.mm to an f32 dW plus torch._fused_adamw_ on the same
    state (two calls; they write no bf16 W)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device=dev),
                                 torch.tensor(0.37, device=dev))
    salt = (3 << 16) + 5
    rows, checks = [], []

    def r(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def inputs(gm, dt):
        """(x, [dC per set], [(master, mu, nu, W) per set]): a later step's
        state, its moments on the scale of dW (about sqrt(M))."""
        g = math.sqrt(gm.m)
        x, dcs = r((gm.m, gm.k), 1.0, dt), [r((gm.m, gm.n), 1.0, dt) for _ in range(gm.sets)]
        sets = []
        for _ in range(gm.sets):
            mst = r((gm.k, gm.n), 0.02)
            sets.append((mst, r((gm.k, gm.n), 0.5 * g), r((gm.k, gm.n), 2.0 * g) ** 2 + 1.0, mst.to(dt)))
        return x, dcs, sets

    def update(fn, x, dcs, sets, dt, **kw):
        (m1, u1, v1, w1), *rest = sets
        extra = dict(w2=rest[0][3]) if rest else {}
        second = list(rest[0][:3]) if rest else [None] * 3
        return fn(x, dcs[0], dcs[1] if rest else None, m1, u1, v1, *second, hyper, w=w1, salt=salt,
                  stochastic_round=dt == torch.bfloat16, **extra, **kw)

    def clone(sets):
        return [tuple(t.clone() for t in st) for st in sets]

    for gm in train_update_gemms(cfg):
        for dt in (torch.bfloat16, torch.float32):
            x, dcs, sets = inputs(gm, dt)
            got_sets, want_sets = clone(sets), clone(sets)
            got = update(tk.sfc_gemm_tn, x, dcs, got_sets, dt)
            norm_only = tk.sfc_gemm_tn(x, dcs[0], dcs[1] if gm.dual else None, norm=True)
            torch.cuda.synchronize()
            want = update(tk.sfc_gemm_tn_plain, x, dcs, want_sets, dt, bm=64, bn=64)
            ok, norm_err, worst = within(got, want, torch.float32)
            res = {"case": f"tn_update:{gm.name}", "dtype": str(dt), "shape": [gm.m, gm.k, gm.n], "dual": gm.dual,
                   "norm_ok": ok, "norm_max_abs_err": norm_err, "norm_err_over_bound": worst,
                   "norm_mode_bitwise": bool(torch.equal(norm_only, got))}
            err, worst_state, w_bitwise = 0.0, 0.0, True
            for s, ((g_mst, g_mu, g_nu, g_w), (p_mst, p_mu, p_nu, p_w)) in enumerate(zip(got_sets, want_sets)):
                for g_, w_ in ((g_mst, p_mst), (g_mu, p_mu), (g_nu, p_nu), (g_w, p_w)):
                    ok_s, err_s, worst_s = within(g_, w_, torch.float32 if g_.dtype == torch.float32 else dt)
                    ok, err, worst_state = ok and ok_s, max(err, err_s), max(worst_state, worst_s)
                if dt == torch.bfloat16:
                    bits = tk._tile_bits(gm.k, gm.n, 64, 64, hyper, salt, *((1,) if s else ()))
                    w_bitwise &= bool(torch.equal(g_w, tk.stochastic_round_to(g_mst, bits, dt)))
                    del bits
                else:
                    w_bitwise &= bool(torch.equal(g_w, g_mst))
            res.update(ok=ok and w_bitwise and res["norm_mode_bitwise"], max_abs_err=err,
                       state_err_over_bound=worst_state, w_bitwise_sr_of_master=w_bitwise)
            checks.append(res)
            if not res["ok"]:
                raise AssertionError(f"sfc_gemm_tn update / norm mode disagrees with its plain version: {res}")
            del got_sets, want_sets
            if dt != torch.bfloat16:
                del x, dcs, sets
                continue
            # the main path's type: time both modes, the plain versions and the yardstick
            copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2)))
            ins = [(x, dcs, sets)] + [inputs(gm, dt) for _ in range(copies - 1)]
            step_t = torch.zeros((), device=dev)

            def library(i):
                x_, dcs_, sets_ = ins[i % copies]
                grads = [torch.mm(x_.T, d, out_dtype=torch.float32) for d in dcs_]
                torch._fused_adamw_([st[0] for st in sets_], grads, [st[1] for st in sets_],
                                    [st[2] for st in sets_], [], [step_t] * len(sets_), lr=1e-2, beta1=0.9,
                                    beta2=0.95, weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)

            reps = max(20, copies)
            upd_ms = time_ms(lambda i: update(tk.sfc_gemm_tn, *ins[i % copies], dt), reps=reps, graph=True)
            norm_ms = time_ms(lambda i: tk.sfc_gemm_tn(ins[i % copies][0], *ins[i % copies][1], norm=True),
                              reps=reps, graph=True)
            lib_ms = time_ms(library, reps=reps, graph=True)
            plain_upd_ms = time_ms(lambda i: update(tk.sfc_gemm_tn_plain, x, dcs, sets, dt, bm=64, bn=64),
                                   reps=1, warmup=1)
            plain_norm_ms = time_ms(lambda i: tk.sfc_gemm_tn_plain(x, *dcs, norm=True, bm=64, bn=64),
                                    reps=1, warmup=1)
            for mode, ms, plain_ms, l_ms in (("update", upd_ms, plain_upd_ms, lib_ms),
                                             ("norm", norm_ms, plain_norm_ms, None)):
                g2 = dataclasses.replace(gm, mode=mode)
                bound_ms, bound_by = _bound(g2.flops(), g2.bytes(2))
                rows.append(dict(gemm=g2, max_abs_err=err if mode == "update" else norm_err, ms=ms, plain_ms=plain_ms,
                                 library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by))
            del ins, x, dcs, sets
            torch.cuda.empty_cache()
    return rows, checks


@dataclasses.dataclass(frozen=True)
class AttnBwd:
    """One flash backward: dQ (K12) and dK/dV (K13) for (b, s) queries
    against (b, t) keys."""

    name: str
    b: int
    s: int
    t: int
    h: int
    hkv: int
    d: int
    dtype: str
    causal: bool = True
    q_offset: int = 0
    main_path: bool = True

    def pairs(self) -> int:
        return Attn("", "sfc_flash_fwd", self.b, self.s, self.t, self.h, self.hkv, self.d, self.causal,
                    self.q_offset).pairs()

    def bound(self, kernel: str, elem: int):
        """K12 reads q, k, v, dO, lse and delta and writes dQ, with 6 D flops
        a pair (S, dP, dS k); K13 reads the same and writes dK and dV, with
        8 D flops a pair (S, dP, P^T dO, dS^T q)."""
        q_elems, kv_elems = self.b * self.s * self.h * self.d, self.b * self.t * self.hkv * self.d
        stats = 2 * 4 * self.b * self.s * self.h
        if kernel == "sfc_flash_bwd_dq":
            return _bound(6.0 * self.d * self.pairs(), elem * (3 * q_elems + 2 * kv_elems) + stats)
        return _bound(8.0 * self.d * self.pairs(), elem * (2 * q_elems + 4 * kv_elems) + stats)

    def shape(self) -> dict:
        return {"b": self.b, "s": self.s, "t": self.t, "h": self.h, "hkv": self.hkv, "d": self.d,
                "causal": self.causal, "q_offset": self.q_offset, "dtype": self.dtype}


def attention_bwd_cases(cfg):
    heads = dict(h=cfg.n_heads, hkv=cfg.kv_heads, d=cfg.head_dim_)
    return [
        AttnBwd("train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, dtype="bfloat16", **heads),
        AttnBwd("ragged_gqa_f32", 1, 190, 250, dtype="float32", q_offset=60, main_path=False, **heads),
    ]


def phase_attention_bwd(torch, cases, tsa, build):
    """K12 and K13 against their plain versions, the main case timed beside
    its bound and the backward of scaled_dot_product_attention (a yardstick
    the port never calls: one graph of SDPA forward and backward, less one
    of the forward alone; it computes dQ, dK and dV together, so K12 and
    K13 share it)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rows, checks = [], []
    for c in cases:
        dt = getattr(torch, c.dtype)
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa: E731
        q, k, v, do = r(c.b, c.s, c.h, c.d), r(c.b, c.t, c.hkv, c.d), r(c.b, c.t, c.hkv, c.d), r(c.b, c.s, c.h, c.d)
        kw = dict(causal=c.causal, q_offset=c.q_offset)
        o, lse = tsa.sfc_flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        qc, kc = tsa.kernel_chunks()
        dqc, dkc = build.ATTN_DKV_TILE[build.DTYPE_NAMES[c.dtype]]
        kernels = {
            "sfc_flash_bwd_dq": (lambda i: tsa.sfc_flash_bwd_dq(*args, **kw),
                                 lambda i: tsa.sfc_flash_bwd_dq_plain(*args, q_chunk=qc, k_chunk=kc, **kw)),
            "sfc_flash_bwd_dkv": (lambda i: tsa.sfc_flash_bwd_dkv(*args, **kw),
                                  lambda i: tsa.sfc_flash_bwd_dkv_plain(*args, q_chunk=dqc, k_chunk=dkc, **kw)),
        }
        lib_ms = None
        if c.main_path:
            views = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
            do_t = do.transpose(1, 2)

            def sdpa(i):
                return F.scaled_dot_product_attention(*views, is_causal=c.causal, enable_gqa=True)

            def sdpa_fwd_bwd(i):
                return torch.autograd.grad(sdpa(i), views, do_t)

            lib_ms = time_ms(sdpa_fwd_bwd, reps=20, graph=True) - time_ms(sdpa, reps=20, graph=True)
        for name, (kernel, plain) in kernels.items():
            got, want = kernel(0), plain(0)
            torch.cuda.synchronize()
            ok, err, worst = within_all(got, want, dt)
            checks.append({"case": f"{name}:{c.name}", "shape": c.shape(), "ok": ok, "max_abs_err": err,
                           "err_over_bound": worst})
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at {c}: max err {err}, "
                                     f"err/bound {worst}")
            if not c.main_path:
                continue
            bound_ms, bound_by = c.bound(name, 2)
            rows.append(dict(case=c, kernel=name, max_abs_err=err, ms=time_ms(kernel, reps=20, graph=True),
                             plain_ms=time_ms(plain, reps=2, warmup=1), library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
    return rows, checks


def _is_projection(name: str) -> bool:
    return name.split(".")[-1] in ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "head")


def phase_grad_check(torch, cfg, build_model, gemm_backend, attention_backend, batch):
    """Full-width qwen3-4b cut to GRAD_CHECK_LAYERS layers, in f32: the loss
    and every parameter's gradient under sfc_cuda + attn_impl="sfc" (K1/K2,
    K7, K8, K11, K12, K13) against the torch backend with blockwise
    attention, within the bf16 bound; every projection weight must get a
    non-zero gradient."""
    cfg4 = dataclasses.replace(cfg, n_layers=GRAD_CHECK_LAYERS, param_dtype="float32")
    model = build_model(cfg4, device="cuda").init(torch.Generator(device="cuda").manual_seed(7))
    losses, grads = {}, {}
    for name, (gemm, impl) in (("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc")), ("torch", ("torch", "blockwise"))):
        with gemm_backend(gemm), attention_backend(impl):
            loss = model.loss(batch)
            loss.backward()
        torch.cuda.synchronize()
        losses[name] = loss.detach()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    missing = [n for n, g in grads["sfc_cuda+sfc_attn"].items()
               if _is_projection(n) and (g is None or not bool(g.abs().max() > 0))]
    if missing:
        raise AssertionError(f"projection weights without a gradient under sfc_cuda: {missing}")
    ok_loss, err_loss, worst_loss = within(losses["sfc_cuda+sfc_attn"], losses["torch"], torch.bfloat16)
    per_param = {n: within(g, grads["torch"][n], torch.bfloat16) for n, g in grads["sfc_cuda+sfc_attn"].items()}
    bad = {n: r for n, r in per_param.items() if not r[0]}
    out = {"layers": GRAD_CHECK_LAYERS, "dtype": "float32", "tokens": list(batch["tokens"].shape),
           "loss": {"sfc_cuda+sfc_attn": float(losses["sfc_cuda+sfc_attn"]), "torch": float(losses["torch"]),
                    "ok": ok_loss, "err_over_bound": worst_loss},
           "params": len(per_param), "projections_with_gradient": sum(map(_is_projection, per_param)),
           "grad_worst_err_over_bound": max(r[2] for r in per_param.values()),
           "grad_max_abs_err": max(r[1] for r in per_param.values())}
    del model, grads
    if not ok_loss or bad:
        raise AssertionError(f"sfc_cuda gradients disagree with the torch backend's: loss ok={ok_loss} "
                             f"(err/bound {worst_loss}); parameters {sorted(bad)}")
    return out


def phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, batches):
    """Full-width qwen3-4b cut to GRAD_CHECK_LAYERS layers, in f32: two
    fused-optimizer steps (sfc_cuda + attn_impl="sfc", AdamW of every
    projection in K8's update flush, the clip exact in two phases) against
    two unfused sfc_cuda steps from the same init, with a clip that binds:
    losses, grad norms, every parameter and every master / mu / nu within
    the f32 bound; then a third fused step whose gradients are all NaN (a
    hook on the final norm's output): every weight and state bitwise
    unchanged, the step counted."""
    cfg4 = dataclasses.replace(cfg, n_layers=GRAD_CHECK_LAYERS, param_dtype="float32")
    opt_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3, clip_norm=FUSED_CHECK_CLIP)
    runs = {}
    for name, fused in (("unfused", False), ("fused", True)):
        model = build_model(cfg4, device="cuda").init(torch.Generator(device="cuda").manual_seed(7))
        step = make_train_step(model, opt_cfg, backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc",
                                                                     fused_optimizer=fused))
        state = opt.adamw_init(dict(model.named_parameters()))
        metrics = []
        modes0 = dict(tk.sfc_gemm_tn.launches_by_mode)
        for batch in batches[:2]:
            state, m = step(state, batch)
            metrics.append({"loss": m["loss"], "grad_norm": m["grad_norm"]})
        torch.cuda.synchronize()
        modes = {k: v - modes0.get(k, 0) for k, v in tk.sfc_gemm_tn.launches_by_mode.items()}
        runs[name] = (model, step, state, metrics, modes)
    (mu_, _, su, metu, _), (mf, stepf, sf, metf, modesf) = runs["unfused"], runs["fused"]
    per_step = GRAD_CHECK_LAYERS * 6 + 1
    worst, ok = 0.0, True
    for a, b in zip(metf, metu):
        for key in ("loss", "grad_norm"):
            ok_, _, w_ = within(a[key], b[key], torch.float32)
            ok, worst = ok and ok_, max(worst, w_)
    binds = all(float(m["grad_norm"]) > FUSED_CHECK_CLIP for m in metu)
    pf, pu = dict(mf.named_parameters()), dict(mu_.named_parameters())
    for n in pf:
        for a, b in [(pf[n], pu[n])] + [(sf[k][n], su[k][n]) for k in ("mu", "nu", "master")]:
            ok_, _, w_ = within(a.detach(), b.detach(), torch.float32)
            ok, worst = ok and ok_, max(worst, w_)
    no_grad = all(p.grad is None for p in pf.values())
    counts_ok = modesf.get("norm", 0) == modesf.get("update", 0) == 2 * per_step and not modesf.get("dw")
    del mu_, su, pu, runs
    # the non-finite case
    before = {n: p.detach().clone() for n, p in pf.items()}
    slots = {k: {n: t.clone() for n, t in sf[k].items()} for k in ("mu", "nu", "master")}
    hook = mf.final_norm.register_forward_hook(lambda mod, inp, out: out.register_hook(lambda g: g * float("nan"))
                                               and None)
    sf, m_nan = stepf(sf, batches[2])
    hook.remove()
    torch.cuda.synchronize()
    skipped = (not math.isfinite(float(m_nan["grad_norm"])) and int(sf["step"]) == 3
               and all(torch.equal(p.detach(), before[n]) for n, p in pf.items())
               and all(torch.equal(sf[k][n], slots[k][n]) for k in slots for n in slots[k]))
    out = {"layers": GRAD_CHECK_LAYERS, "dtype": "float32", "clip_norm": FUSED_CHECK_CLIP, "clip_binds": binds,
           "losses": {"fused": [float(m["loss"]) for m in metf], "unfused": [float(m["loss"]) for m in metu]},
           "grad_norms": {"fused": [float(m["grad_norm"]) for m in metf],
                          "unfused": [float(m["grad_norm"]) for m in metu]},
           "worst_err_over_bound": worst, "within_f32_bound": ok, "no_weight_has_grad": no_grad,
           "tn_launches_by_mode_2_steps": modesf, "nonfinite_step_skipped_bitwise": skipped}
    del mf, sf, stepf, pf, before, slots
    if not (ok and binds and no_grad and counts_ok and skipped):
        raise AssertionError(f"the fused step disagrees with the unfused one: {out}")
    return out


# kernel-name fragments of the port's kernels in a profiler trace
_KERNEL_GROUPS = (("sfc_gemm_fused_kernel", "K1/K2"), ("nt_kernel", "K7"), ("tn_kernel", "K8"),
                  ("tn_update_kernel", "K8 norm/update"), ("flash_fwd_kernel", "K11"),
                  ("flash_bwd_dq_kernel", "K12"), ("flash_bwd_dkv_kernel", "K13"))


def profile_step(torch, step_fn, opt_state, batch):
    """One more train step under torch.profiler: its wall time, the
    device's busy time (the sum of the device-side events: kernels, memcpy,
    memset), the idle share, and the busy time by group: the port's
    kernels by name, the rest (elementwise, reductions, cuBLAS, copies) as
    "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(opt_state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {label: 0.0 for _, label in _KERNEL_GROUPS if label != "K8 norm/update"}
    groups.update({"K8 norm": 0.0, "K8 update": 0.0, "other": 0.0})
    top = []
    for ev in prof.key_averages():
        # the device's own activities (kernels, memcpy, memset); a CPU op
        # also reports the device time of the kernels it launched
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        label = next((lab for frag, lab in _KERNEL_GROUPS if frag in ev.key), "other")
        if label == "K8 norm/update":  # tn_update_kernel<T, DUAL, UPDATE, SR>
            label = "K8 update" if ev.key.split("tn_update_kernel<")[1].split(", ")[2] == "true" else "K8 norm"
        groups[label] += us / 1e3
        top.append((us / 1e3, ev.key[:80]))
    busy = sum(groups.values()) / 1e3
    top.sort(reverse=True)
    # a trace with no device time measured nothing: no idle share then
    return opt_state, {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall if busy else None,
                       "device_ms_by_group": groups, "top_device_ms": top[:10]}


def _tn_mode_counts(tn):
    return {f"sfc_gemm_tn:{mode}": tn.launches_by_mode.get(mode, 0) for mode in ("dw", "norm", "update")}


def phase_train(torch, cfg, build_trainer, counted):
    """Three steps of `build_trainer` at full width under sfc_cuda +
    attn_impl="sfc", the same steps from the same init with the fused
    optimizer, then under torch + blockwise.  Returns (summary, launches by
    shape of each sfc run)."""
    per_step = cfg.n_layers * 6 + 1
    layers = {"sfc_flash_fwd": cfg.n_layers, "sfc_flash_bwd_dq": cfg.n_layers, "sfc_flash_bwd_dkv": cfg.n_layers}
    want = {"sfc_gemm_fused": per_step, "sfc_gemm_nt": per_step, "sfc_gemm_tn": per_step, **layers,
            "sfc_gemm_tn:dw": per_step, "sfc_gemm_tn:norm": 0, "sfc_gemm_tn:update": 0}
    # the fused step: K8 runs its norm mode in the backward and its update
    # mode after it, and never writes dW
    want_fused = {**want, "sfc_gemm_tn": 2 * per_step, "sfc_gemm_tn:dw": 0, "sfc_gemm_tn:norm": per_step,
                  "sfc_gemm_tn:update": per_step}
    tn = counted["sfc_gemm_tn"]
    runs, by_shape = {}, {}
    for name, (gemm, impl, fused) in (("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc", False)),
                                      ("sfc_cuda+sfc_attn+fused_optimizer", ("sfc_cuda", "sfc", True)),
                                      ("torch", ("torch", "blockwise", False))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, opt_state, step_fn, batch_fn = build_trainer(
            cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, total_steps=TRAIN_STEPS, seed=0,
            gemm_backend=gemm, attn_impl=impl, fused_optimizer=fused, device="cuda")
        params = dict(model.named_parameters())
        # a fingerprint of each initial parameter (its f64 sum): every
        # parameter's f32 master must move off it
        before = {n: float(p.detach().double().sum()) for n, p in params.items()}
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        losses, times, launches = [], [], []
        for fn in counted.values():
            fn.launches = 0
            if hasattr(fn, "launches_by_shape"):
                fn.launches_by_shape.clear()
        tn.launches_by_mode.clear()

        def counts():
            return {**{k: fn.launches for k, fn in counted.items()}, **_tn_mode_counts(tn)}

        for step in range(TRAIN_STEPS):
            batch = batch_fn(step)
            start = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(opt_state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append({k: v - start[k] for k, v in counts().items()})
        unchanged = [n for n in params if float(opt_state["master"][n].double().sum()) == before[n]]
        runs[name] = {"losses": losses, "step_s": times, "setup_s": setup_s,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(), "unchanged_params": unchanged,
                      "params_with_grad": [n for n, p in params.items() if p.grad is not None],
                      "launches_per_step": launches, "grad_norm_last": float(metrics["grad_norm"])}
        if gemm == "sfc_cuda":
            by_shape[name] = {k: dict(fn.launches_by_shape) for k, fn in counted.items()
                              if hasattr(fn, "launches_by_shape")}
            by_shape[name]["totals"] = counts()
        # a fourth step, profiled, for the split of its time (not compared)
        opt_state, runs[name]["profiled_step"] = profile_step(torch, step_fn, opt_state, batch_fn(TRAIN_STEPS))
        del model, opt_state, step_fn, batch_fn, params, metrics
        torch.cuda.empty_cache()
    sfc, fused, ref = runs["sfc_cuda+sfc_attn"], runs["sfc_cuda+sfc_attn+fused_optimizer"], runs["torch"]

    def close(a_run, b_run):
        return [math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
                for a, b in zip(a_run["losses"], b_run["losses"])]

    loss_ok, fused_ok = close(sfc, ref), close(fused, sfc)
    out = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "launches_expected_per_step": want,
           "fused_launches_expected_per_step": want_fused, "loss_within_2^-7": loss_ok,
           "fused_loss_within_2^-7_of_unfused": fused_ok, **{f"{k}": v for k, v in runs.items()}}
    emit(out)
    for run, expect in ((sfc, want), (fused, want_fused)):
        bad_counts = [i for i, c in enumerate(run["launches_per_step"]) if c != expect]
        if bad_counts:
            raise AssertionError(f"train steps {bad_counts} launched {run['launches_per_step']}, expected {expect}")
    if not all(loss_ok) or not all(fused_ok) or not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"train losses {sfc['losses']} (fused {fused['losses']}) vs torch {ref['losses']}: "
                             "not within 2^-7 or not finite")
    for name, run in runs.items():
        if run["unchanged_params"]:
            raise AssertionError(f"{name} training left parameters unchanged: {run['unchanged_params']}")
    if fused["params_with_grad"]:
        raise AssertionError(f"the fused step left weights with a .grad: {fused['params_with_grad']}")
    return out, by_shape


def small_reference_check(torch, get_config, build_model, gemm_backend):
    """Reduced qwen3-4b in f32 on the card: sfc_cuda logits against the
    Listing-1 reference backend at rtol 1e-4 (prefill and 3 decode steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3_4b").reduced()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(2))
    prompt = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator(device="cuda").manual_seed(3),
                           device="cuda")
    outs = {}
    for backend in ("sfc_cuda", "sfc_reference"):
        with gemm_backend(backend):
            logits, cache = model.prefill(prompt, cache_len=16)
            seq = [logits]
            tok = prompt[:, -1:]
            for _ in range(3):
                logits, cache = model.decode_step(tok, cache)
                seq.append(logits)
        outs[backend] = torch.stack(seq)
    ok, err, worst = within(outs["sfc_cuda"], outs["sfc_reference"], torch.float32)
    if not ok:
        raise AssertionError(f"reduced model: sfc_cuda vs sfc_reference max err {err}")
    return {"ok": ok, "max_abs_err": err, "err_over_bound": worst}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.attention_backend import attention_backend
    from repro_torch.core.gemm_backend import gemm_backend
    from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as opt
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.train.step import BackendConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load_all()  # nvcc at first use, every part of both libraries at once
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_and_load_s": time.perf_counter() - t0})

    # ---- 2. kernels against their plain versions ---------------------------
    cfg = get_config("qwen3_4b")
    gemms = main_path_gemms(cfg)
    rows, checks = phase_kernels(torch, cfg, gemms, tk, ops)
    attn_rows, attn_checks = phase_attention(torch, attention_cases(cfg), tsa, tfa, build)
    bwd_rows, bwd_checks = phase_backward_gemms(torch, train_backward_gemms(cfg), tk, ops)
    upd_rows, upd_checks = phase_update_gemms(torch, cfg, tk, opt)
    attn_bwd_rows, attn_bwd_checks = phase_attention_bwd(torch, attention_bwd_cases(cfg), tsa, build)
    small = small_reference_check(torch, get_config, build_model, gemm_backend)
    emit({"phase": "kernels_vs_plain", "ok": True, "tolerance": {
        "float32": f"|k-p| <= {F32_RTOL}|p| + {F32_ATOL_REL} max|p|",
        "bfloat16": f"|k-p| <= 2^-7 |p| + {BF16_ATOL_REL} max|p|",
        "lse": "float32 tolerance"},
        "tn_update": "master, mu, nu and the norms at the float32 tolerance; a bf16 W bitwise the stochastic "
                     "rounding of the kernel's master with the plain version's bits and within the bfloat16 "
                     "tolerance of the plain W",
        "checks": checks + attn_checks + bwd_checks + upd_checks + attn_bwd_checks,
        "reduced_model_f32_vs_reference": small})
    torch.cuda.empty_cache()

    # ---- 3. gradients of a 4-layer full-width model in f32 -----------------
    data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=1))
    gc_batch = {key: torch.from_numpy(val).cuda() for key, val in data.batch(0).items()}
    emit({"phase": "grad_check", "ok": True,
          **phase_grad_check(torch, cfg, build_model, gemm_backend, attention_backend, gc_batch)})
    torch.cuda.empty_cache()
    fc_batches = [{key: torch.from_numpy(val).cuda() for key, val in data.batch(i).items()} for i in range(3)]
    emit({"phase": "fused_step_check", "ok": True,
          **phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, fc_batches)})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. serve full-width qwen3-4b --------------------------------------
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    # (gemm backend, attn_impl) of each served configuration
    variants = {"sfc_cuda": ("sfc_cuda", "blockwise"), "sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"),
                "torch": ("torch", "blockwise"), "sfc_cuda+flash_attn": ("sfc_cuda", "flash_pallas")}
    served = ("sfc_cuda", "sfc_cuda+sfc_attn", "torch")

    def engine(name, config):
        gemm, impl = variants[name]
        return ServingEngine(dataclasses.replace(config, attn_impl=impl), params_of[config.param_dtype],
                             max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend=gemm, device="cuda")

    params_of = {cfg.param_dtype: params}
    engines = {name: engine(name, cfg) for name in served}
    for eng in engines.values():  # warm-up: first launches, allocator, cuBLAS handles
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))
    torch.cuda.synchronize()

    per_step = cfg.n_layers * 6 + 1  # q, k, v, o, GLU, w_out per layer, plus the head
    want_launches = per_step * NEW_TOKENS  # one prefill and 15 decode steps
    want_attn = {"sfc_flash_fwd": cfg.n_layers, "sfc_decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}
    attn_kernels = {"sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_decode_attention": tsa.sfc_decode_attention,
                    "flash_attention": tfa.flash_attention}

    def reset_counts():
        tk.sfc_gemm_fused.launches = 0
        tk.sfc_gemm_fused.launches_by_shape.clear()
        for fn in attn_kernels.values():
            fn.launches = 0

    # the blockwise path: every projection on the GEMM kernel
    reset_counts()
    done = {"sfc_cuda": engines["sfc_cuda"].run(engines["sfc_cuda"].submit_many(prompts, max_new_tokens=NEW_TOKENS))}
    torch.cuda.synchronize()
    launches = tk.sfc_gemm_fused.launches
    by_shape = dict(tk.sfc_gemm_fused.launches_by_shape)
    if launches != want_launches:
        raise AssertionError(f"sfc_cuda serve launched the kernel {launches} times, expected {want_launches}")
    # the attn_impl="sfc" path: projections on the GEMM, attention on K11 / K14
    reset_counts()
    eng = engines["sfc_cuda+sfc_attn"]
    done["sfc_cuda+sfc_attn"] = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    attn_launches = {name: fn.launches for name, fn in attn_kernels.items()}
    attn_gemm_launches = tk.sfc_gemm_fused.launches
    if attn_gemm_launches != want_launches or any(attn_launches[k] != n for k, n in want_attn.items()):
        raise AssertionError(f"attn_impl='sfc' serve launched GEMM {attn_gemm_launches} (want {want_launches}) "
                             f"and attention {attn_launches} (want {want_attn}) times")
    done["torch"] = engines["torch"].run(engines["torch"].submit_many(prompts, max_new_tokens=NEW_TOKENS))
    reports = {name: engines[name].latency_report(batch) for name, batch in done.items()}
    for batch in done.values():
        for r in batch:
            if (r.status != "completed" or len(r.output) != NEW_TOKENS
                    or not all(0 <= t < cfg.vocab for t in r.output)):
                raise AssertionError(f"request {r.uid} ended {r.status} with {len(r.output or [])} tokens")
    tokens_of = {name: np.array([r.output for r in batch]) for name, batch in done.items()}

    # prefill logits against the torch backend.  In bf16 both backends sit
    # about 3% of a logit's spread away from the f32 model after 36 layers
    # (rounding noise that no bf16 implementation avoids), so the bf16
    # bound is asserted where only the implementations differ: the same
    # weights in f32 on every variant.  The bf16 logits must be no further
    # from that f32 reference than the torch backend's are.
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}
    del engines, eng
    # the attn_impl="flash_pallas" prefill: its attention on K15
    reset_counts()
    logits["sfc_cuda+flash_attn"] = engine("sfc_cuda+flash_attn", cfg)._prefill(tokens)[0].float()
    torch.cuda.synchronize()
    attn_launches["flash_attention"] = tfa.flash_attention.launches
    if attn_launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_pallas prefill launched K15 {attn_launches['flash_attention']} times, "
                             f"expected {cfg.n_layers}")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params_of["float32"] = {k: v.float() for k, v in params.items()}
    for name in ("torch", "sfc_cuda", "sfc_cuda+sfc_attn", "sfc_cuda+flash_attn"):
        logits[name + "_f32"] = engine(name, cfg32)._prefill(tokens)[0]
    del params_of["float32"]
    torch.cuda.synchronize()
    for name in ("sfc_cuda", "sfc_cuda+sfc_attn", "sfc_cuda+flash_attn"):
        if tuple(logits[name].shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"{name} prefill logits shape {tuple(logits[name].shape)} or non-finite values")
    ref = logits["torch_f32"]
    sfc_variants = ("sfc_cuda", "sfc_cuda+sfc_attn", "sfc_cuda+flash_attn")
    f32_agree = {name: dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                within(logits[name + "_f32"], ref, torch.bfloat16))) for name in sfc_variants}
    ok16, err16, worst16 = within(logits["sfc_cuda"], logits["torch"], torch.bfloat16)
    noise = {b: float((logits[b] - ref).abs().mean()) for b in (*sfc_variants, "torch")}
    parity = {name: noise[name] <= ACCURACY_PARITY * noise["torch"] for name in sfc_variants}
    argmax = {b: float((logits[b].argmax(-1) == ref.argmax(-1)).float().mean()) for b in (*sfc_variants, "torch")}
    serve = {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
        "requests": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
        "launches": launches, "launches_expected": want_launches,
        "attn_impl_sfc_launches": {"sfc_gemm_fused": attn_gemm_launches, **{k: attn_launches[k] for k in want_attn}},
        "flash_pallas_prefill_launches": attn_launches["flash_attention"],
        "prefill_logits": {
            "f32_vs_torch": f32_agree,
            "bf16_sfc_cuda_vs_torch": {"within_bound": ok16, "max_abs_err": err16, "err_over_bound": worst16,
                                       "mean_abs_err": float((logits["sfc_cuda"] - logits["torch"]).abs().mean())},
            "bf16_mean_abs_err_vs_f32": noise, "parity_ok": parity,
            "argmax_match_vs_f32": argmax, "max_abs_logit": float(ref.abs().max()),
        },
        "first_token_match": {name: float((logits[name].argmax(-1) == logits["torch"].argmax(-1)).float().mean())
                              for name in sfc_variants},
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of["torch"]).mean())
                               for name in ("sfc_cuda", "sfc_cuda+sfc_attn")},
        "greedy_token_match_sfc_attn_vs_sfc_cuda":
            float((tokens_of["sfc_cuda+sfc_attn"] == tokens_of["sfc_cuda"]).mean()),
        "latency": reports,
    }
    emit(serve)
    for name, res in f32_agree.items():
        if not res["ok"]:
            raise AssertionError(f"f32 prefill logits {name} vs torch: max err {res['max_abs_err']}, "
                                 f"err/bound {res['err_over_bound']}")
    if not all(parity.values()):
        raise AssertionError(f"bf16 logits further from the f32 model than torch's: {noise}")
    # the serve's model and every tensor of it leave the card before training
    del model, params, params_of, logits, ref
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5. train full-width qwen3-4b --------------------------------------
    counted = {"sfc_gemm_fused": tk.sfc_gemm_fused, "sfc_gemm_nt": tk.sfc_gemm_nt, "sfc_gemm_tn": tk.sfc_gemm_tn,
               "sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_flash_bwd_dq": tsa.sfc_flash_bwd_dq,
               "sfc_flash_bwd_dkv": tsa.sfc_flash_bwd_dkv}
    _, counts_by_run = phase_train(torch, cfg, build_trainer, counted)
    train_counts, fused_counts = counts_by_run["sfc_cuda+sfc_attn"], counts_by_run["sfc_cuda+sfc_attn+fused_optimizer"]

    # ---- 6. the kernels line ------------------------------------------------
    kernels = []
    for row in rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_fused:{gm.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu",
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": (train_counts["sfc_gemm_fused"] if gm.path == "train" else by_shape).get(gm.key, 0),
            "path": gm.path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "glu": gm.glu, "preact": gm.preact},
        })
    for row in bwd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_{gm.kind}:{gm.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu",
            "replaces": "src/repro/kernels/sfc_gemm.py:1219" if gm.kind == "nt" else "src/repro/kernels/sfc_gemm.py:1429",
            "launches": train_counts[f"sfc_gemm_{gm.kind}"].get(gm.key, 0),
            "path": "train",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {"m": gm.m, "k": gm.k, "n": gm.n, "dual": gm.dual},
        })
    for row in upd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_tn_{gm.mode}:{gm.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu",
            "replaces": "src/repro/kernels/sfc_gemm.py:1094",
            "launches": fused_counts["sfc_gemm_tn"].get(gm.key, 0),
            "path": "train, fused optimizer",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.mm to an f32 dW + torch._fused_adamw_ (two calls)" if gm.mode == "update" else None,
            "shape": {"m": gm.m, "k": gm.k, "n": gm.n, "dual": gm.dual, "dtype": "bfloat16",
                      "stochastic_round": gm.mode == "update"},
        })
    replaces = {"sfc_flash_fwd": "src/repro/kernels/sfc_attention.py:204",
                "flash_attention": "src/repro/kernels/flash_attention.py:107",
                "sfc_decode_attention": "src/repro/kernels/sfc_attention.py:660",
                "sfc_flash_bwd_dq": "src/repro/kernels/sfc_attention.py:428",
                "sfc_flash_bwd_dkv": "src/repro/kernels/sfc_attention.py:509"}
    for row in attn_bwd_rows:
        c = row["case"]
        kernels.append({
            "name": f"{row['kernel']}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[row["kernel"]],
            "launches": train_counts["totals"][row["kernel"]],
            "path": "train",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "scaled_dot_product_attention backward (dQ, dK, dV together)",
            "shape": c.shape(),
        })
    for row in attn_rows:
        c = row["case"]
        # every launch of a path's run is at its main-path shape; a check row
        # at another shape carries its kernel's count from that run
        count = train_counts["totals"][c.kernel] if c.path == "train" else attn_launches[c.kernel]
        kernels.append({
            "name": f"{c.kernel}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[c.kernel],
            "launches": count,
            "launches_at_shape": count if c.main_path else 0,
            "path": c.path,
            "main_path": c.main_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": c.shape(),
        })
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"main-path kernels never launched in the run of their path: {missing}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
