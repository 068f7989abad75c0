#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout (src/repro_torch/kernels/csrc: the GEMM library with its forward
and backward parts and the attention library with its forward, decode and
backward parts and the ABFT checksum lanes' parts, all compiled at once),
then runs nine phases, each printing one JSON line (phases 2 and 6 two,
phase 3 three) and raising on failure:

1. device     the card's name and power limit (nvidia-smi) and the build time;
2. kernels    each kernel against its plain PyTorch version at the shapes the
              qwen3-4b server and trainer run, timed beside its bound and
              one PyTorch call of the same function: the SFC fused GEMM
              (K1/K2) at every serve shape (decode M=4, batched prefill
              4 x 128, the LM head), every training-forward shape (2 x 256,
              the GLU in its preact mode) and one ragged case with every
              epilogue flag; the replicated form's partial copies (K4
              plain, K5 batched) and their layer sum (K6) at every serve
              shape at k_layers 1, 2, 4 and 8 (the LM head at 1 and 8; the
              GLU's two products with f32 copies), each timed alone, the
              unfused call (`fuse=False`) as a whole beside K1/K2 and
              torch.matmul of the same product, plus a ragged case of each
              input type with every epilogue flag at k_layers 2, kbf 4 and
              K = 203; the NT (K7, dA) and TN (K8, dW) kernels at every
              training shape, single and dual, plus a ragged f32 case each;
              K8's update mode (AdamW in the flush, bf16 W stochastically
              rounded) and norm mode at every training shape, in bf16 and
              f32;
              the plain-mode bf16 rows of at most 16 (the decode projections
              and the LM head) launch the cluster kernel, each 64-column C
              tile split over L K slabs inside one launch, and are held
              against the plain version summed over the same L layers; each
              K1/K2 row names the kernel it launched and its L;
              the band flash forward (K11) at the prefill and training shapes
              and at 1 x 2000 with q_offset 0 and 48; the dense flash forward
              (K15); the decode attention (K14, batch x Hkv clusters of S CTAs,
              one a cache segment; its plain version over the same S
              segments) at the serve's cache and at a 4096-row cache; the
              flash backward (K12 dQ, K13 dK/dV) at the training shape and
              at 1 x 2048 tokens (bf16: the wgmma kernels, K13 a cluster of
              CTAs, each a part of the GQA group's q heads, against the
              plain version summing those parts in turn) and a ragged GQA
              f32 case with S != T (the 64 x 64 tile kernels), each row
              naming its kernel and configuration; the
              grouped MoE kernels K3 (forward: GLU with silu in the flush,
              GLU preact, w_out), K9 (dA) and K10 (dW) at every olmoe-1b-7b
              shape (64 experts; decode 32, prefill and training 80 rows an
              expert), timed beside one torch.bmm, and each on ragged
              expert sizes (5, 0, 19, 32) in f32 and bf16; K10's update
              mode (per-expert AdamW in the flush, bf16 W stochastically
              rounded) and norm mode at olmoe's two training shapes in
              bf16, timed beside torch.bmm + torch._fused_adamw_, and on
              the ragged sizes in f32 and bf16 (the empty expert's g = 0
              update included);
              the ABFT checksum lanes ("abft_lanes" line): K1/K2 at every
              K1/K2 shape above and the ragged all-flags case, K3 at
              olmoe's decode, prefill and training shapes and the ragged
              sizes, K8 dW (single, dual) at every training shape with the
              LM head, K8's update (bf16 stochastically rounded, f32) and
              norm modes at every layer's training shape, each in bf16 and
              f32: the lane within 1e-5 of the sum of |64 x 64 raw tile
              sums| of its plain version's lane (never more than
              robust.abft.tolerance(); a lane of 0, the plain lane less
              its last tile and the ragged case's sum after the epilogue
              must miss that limit), within tolerance() of the
              operand-side reference, the
              outputs with the lane on bitwise those with it off; timed in
              bf16 with the lane on and off beside the operand-side
              reference; a negative control per lane (one exponent bit of
              one element of A flipped after the launch: eager verify
              raises SdcDetected, "strict" in a step scope returns NaN and
              counts one detection) and K8's update with an all-NaN
              gradient (a NaN residual, no detection);
3. grad check full-width qwen3-4b cut to 4 layers, f32, batch 2 x 256: the
              loss and every parameter's gradient under sfc_cuda GEMMs with
              attn_impl="sfc" against the torch backend with blockwise
              attention, within the bf16 bound; every projection weight has
              a non-zero gradient; then the fused optimizer's step (AdamW in
              K8's update flush, exact clip in two phases) against the
              unfused sfc_cuda step from the same init, with a clip that
              binds, for two steps, and a third step whose gradients are
              all NaN, which must leave every weight and state bitwise;
              the same fused check again with both steps under
              BackendConfig(abft="detect"): no detection, the NaN step's
              NaN residuals none;
4. serve      ServingEngine serves full-width qwen3-4b (36 layers, bf16,
              random weights from a seeded torch.Generator), 4 requests,
              prompt 128, 16 new tokens, five times: sfc_cuda GEMMs with
              blockwise attention (exactly 217 x 16 GEMM launches), sfc_cuda
              GEMMs with attn_impl="sfc" (exactly 3,472 GEMM, 36 K11 and 540
              K14 launches), the "replicated" backend (exactly 252 K5 and
              3,796 K4 launches, no K6 and no K1/K2: k_layers is 1 at every
              shape), the same with every product split over 8 K layers
              (as many K4/K5, 4,048 K6), and the torch backend.  The
              attn_impl="sfc" serve again under ABFT "detect" (the prefill
              in abft_mode, ServingEngine(verify_every=1)): 0 detections,
              the same tokens, the same 3,472 K1/K2 launches, every one
              with its checksum lane and checked (3,472 checks), the
              verify ledger, its TTFT and decode gap, the largest
              residual / tolerance; and one serve step (prefill and one
              decode step) on "replicated" split over 8 K layers under
              "detect" (the op-level K4/K5 + K6 checks).  A prefill
              under attn_impl="flash_pallas" must launch K15 36 times.  One
              decode step of sfc_cuda, both replicated serves and torch is
              profiled (device busy time, idle share, GEMM kernel time).  The
              prefill logits of the same weights in f32 must agree with the
              torch backend's within the bf16 bound for each SFC variant,
              and each variant's bf16 logits must be as close to that f32
              model as the torch backend's are;
5. train      `launch.train.build_trainer` trains full-width qwen3-4b (36
              layers, bf16, AdamW on f32 master weights) for 3 steps of
              2 x 256 SyntheticLM tokens under sfc_cuda + attn_impl="sfc",
              with exactly 217 K1/K2, 217 K7, 217 K8, 36 K11, 36 K12 and 36
              K13 launches per step (every K12 and K13 one on the wgmma
              kernels; the f32 gradient check's on the tile kernels), then
              the same 3 steps from the same
              init under torch + blockwise: every loss finite and within
              2^-7 of the torch backend's, every parameter changed; step
              times and peak memory, and a fourth step of each run under
              torch.profiler for its device-busy time by kernel group.  A
              third run, between them, trains the same 3 steps with
              fused_optimizer=True (K8 in its norm and update modes, exactly
              217 of each and no dW launch per step, no weight left with a
              .grad), its losses within 2^-7 of the unfused run's; and both
              again under BackendConfig(abft="detect") (no profiled step):
              the same launches a step, 217 K1/K2 and 217 (fused: 434) K8
              launches with the lane, 0 detections, losses within 2^-7 of
              the runs without ABFT (bitwise or not is reported), step
              times and peak memory, the largest residual / tolerance;
6. grad check olmoe-1b-7b at full width cut to 2 layers, f32, as phase 3:
              the router and the expert stacks through K3, K9 and K10;
              then its fused step as phase 3's (K8's modes for q, k, v, o
              and the head, K10's for the expert stacks; the router, as in
              the JAX package, unrouted), with the NaN step;
7. serve      ServingEngine serves full-width, full-depth olmoe-1b-7b (16
              layers, 64 experts top-8, bf16, seeded random weights), 4
              requests, prompt 128, 16 new tokens: sfc_cuda GEMMs with
              blockwise attention and with attn_impl="sfc" (exactly 512 K3
              and 1,296 K1/K2 launches; 16 K11 and 240 K14 with "sfc"), and
              the torch backend; the f32 prefill logits of the same weights
              cut to 4 layers within the bf16 bound of the torch backend's;
              where the bf16 greedy tokens part from torch's, the routing
              of both backends at that step (top-k sets that differ, the
              router's probability gap of the swapped experts); the
              sfc_cuda serve again under ABFT "detect" (verify_every=1):
              0 detections, tokens identical, 512 K3 and 1,296 K1/K2
              launches, every one with its lane;
8. train      `build_trainer` trains olmoe-1b-7b at full width on 8 of its 16
              layers (AdamW's 16 B a parameter: 57 GB) for 3 steps of 2 x 256
              tokens under sfc_cuda + attn_impl="sfc" (exactly 16 K3, 16 K9,
              16 K10 and 41 each of K1/K2, K7, K8 a step), the same steps with
              fused_optimizer=True (16 K10 norm and 16 update launches, 33
              K8 norm and 33 update, the router's 8 K8 dW, no K10 dW a step;
              no weight left with a .grad; losses within 2^-7 of the unfused
              run's), then under torch + blockwise from the same init:
              losses within 2^-7, every parameter moved, a profiled fourth
              step of each (K8's and K10's norm and update modes as groups
              of their own);
9. the {"kernels": [...]} line: per kernel and shape, launches in the run
              of its path (serve or train), max error, kernel / plain /
              library times and the bound (K1/K2 rows: the kernel launched
              and its K layers; K14 rows: the segments); the lane rows (K1/K2, K3, K8 dW,
              update, norm with the lane) carry the launches of the ABFT
              run of their path, the time with the lane off, the operand
              reference's time and the partials their bound adds; before
              it, the seconds at which each phase began and the run's
              total.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository's src/repro_torch beside this file, it exits non-zero
and prints no result.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import collections
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

# olmoe-1b-7b (the MoE slice): served at full width and depth; trained at
# full width on 8 of its 16 layers (AdamW holds 16 B a parameter: 16 layers
# would need 111 GB); its f32 checks cut the depth further
MOE_ARCH = "olmoe_1b_7b"
MOE_TRAIN_LAYERS = 8
MOE_CHECK_LAYERS = 2  # the f32 gradient check
MOE_SERVE_F32_LAYERS = 4  # the f32 prefill-logits check
# expert row counts of the ragged checks: one expert empty, none a whole tile
RAGGED_GROUPS = (5, 0, 19, 32)

# the replicated form (split-K): the K layers of phase 2's rows (the LM head
# at two of them), and those of the second "replicated" serve
REP_LAYERS = (1, 2, 4, 8)
REP_HEAD_LAYERS = (1, 8)
REP_SERVE_LAYERS = 8


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


def launched(counter, fn):
    """(fn(), the one key of ``counter`` that the call added to): which
    kernel (and split) a wrapper launched."""
    before = collections.Counter(counter)
    out = fn()
    (key,) = collections.Counter(counter) - before
    return out, key


def by_kernel(counter) -> dict:
    """A wrapper's ``launches_by_kernel`` summed by CUDA kernel name."""
    out = collections.Counter()
    for (name, _), n in counter.items():
        out[name] += n
    return dict(out)


def plain_layers(name, config) -> int:
    """The K layers a plain version sums over to follow a launch: the
    cluster kernel's L, else one."""
    return config if name == "sfc_gemm_cluster_kernel" else 1


WGMMA_SOURCE = "src/repro_torch/kernels/csrc/sfc_gemm_wgmma.cuh"
GEMM_SOURCE = "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu"


def kernel_source(name: str) -> str:
    """The file in the repository that holds a GEMM kernel's body."""
    return WGMMA_SOURCE if "wgmma" in name else GEMM_SOURCE


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

            splits = tsa.decode_splits(c.b, c.hkv, c.t, torch.cuda.get_device_properties(dev).multi_processor_count)

            def kernel(i):
                return tsa.sfc_decode_attention(*ins[i % copies], valid)

            def plain(i):
                return tsa.sfc_decode_attention_plain(*ins[i % copies], valid, k_chunk=build.DECODE_CHUNK,
                                                      splits=splits)
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
        if c.decode:
            got, launched_splits = launched(tsa.sfc_decode_attention.launches_by_splits, lambda: kernel(0))
            if launched_splits != splits:
                raise AssertionError(f"decode launched {launched_splits} segments, its plain version {splits}")
        else:
            got = kernel(0)
        want = plain(0)
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
                         bound_ms=bound_ms, bound_by=bound_by, **({"splits": splits} if c.decode else {})))
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
        # which kernel the wrapper takes: the cluster kernel (M <= 16), its
        # plain version summed over the same K layers, the wgmma kernel (bf16
        # rows TMA can describe) with its C tile, or the tile kernel
        got, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: kernel(0))
        layers = plain_layers(name, config)

        def plain(i):
            return tk.sfc_gemm_fused_plain(a, ws[i % copies], gs[i % copies] if gs else None, bm=bm, bn=bn,
                                           k_layers=layers, **kw)

        want = plain(0)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": gm.name, "shape": [gm.batch, gm.m, gm.k, gm.n], "glu": gm.glu, "preact": gm.preact,
                       "kernel": name, "config": config, "ok": ok, "max_abs_err": err, "err_over_bound": worst})
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
                         bound_ms=bound_ms, bound_by=bound_by, kernel=name, config=config))
        del ws, gs, a
        if gm.glu:
            del cats
    # ragged cases with every epilogue flag: K 203 in both input types (rows
    # TMA cannot describe: the tile kernel), and K 264 / N 328 in bf16 (the
    # wgmma kernel, whose TMA boxes run past every edge)
    for dtype, (m, k, n) in ((torch.float32, (77, 203, 133)), (torch.bfloat16, (77, 203, 133)),
                             (torch.bfloat16, (77, 264, 328))):
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        args = (r(3, m, k), r(k, n) * 0.1, r(k, n) * 0.1, r(n), r(1, n), r(3, m, n))
        kw = dict(activation="gelu", out_scale=0.7)
        got, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: tk.sfc_gemm_fused(*args, **kw))
        torch.cuda.synchronize()
        ok, err, worst = within(got, tk.sfc_gemm_fused_plain(*args, bm=32, bn=32, **kw), dtype)
        checks.append({"case": "all_epilogue_flags_ragged", "dtype": str(dtype), "shape": [3, m, k, n],
                       "kernel": name, "config": config, "ok": ok, "max_abs_err": err, "err_over_bound": worst})
        if not ok or (name == "sfc_gemm_wgmma_kernel") != (k % 8 == 0 and dtype == torch.bfloat16):
            raise AssertionError(f"all-flags ragged case ({dtype}, K {k}) on {name} disagrees: max err {err}")
    return rows, checks


@dataclasses.dataclass(frozen=True)
class RepGemm:
    """One product of the replicated form at a serve shape: (batch, M) rows
    against (K, N) weights, split over ``layers`` K slabs into partial
    copies (K4, K5 batched) that K6 sums; the unfused GLU is two such
    products with f32 copies."""

    name: str
    batch: int  # 0 = plain mode (K4)
    m: int
    k: int
    n: int
    layers: int
    glu: bool = False

    @property
    def kernel(self) -> str:
        return "K5" if self.batch else "K4"

    @property
    def key(self):  # sfc_gemm_replicated.launches_by_shape
        return (self.batch, self.m, self.k, self.n, self.layers)

    @property
    def reduce_key(self):  # add_reduce.launches_by_shape
        return (self.batch, self.layers, self.m, self.n)

    @property
    def rows(self) -> int:
        return max(self.batch, 1) * self.m

    @property
    def copy_elem(self) -> int:
        return 4 if self.glu else 2

    def bound(self):
        """One K4/K5 launch: A and B read once, the L copies written once."""
        nbytes = 2 * (self.rows * self.k + self.k * self.n) + self.copy_elem * self.layers * self.rows * self.n
        return _bound(2.0 * self.rows * self.k * self.n, nbytes)

    def reduce_bound(self):
        """One K6 launch: the L copies read once, C written once."""
        return _bound(float((self.layers - 1) * self.rows * self.n),
                      self.copy_elem * (self.layers + 1) * self.rows * self.n, PEAK_F32_FLOPS)

    def shape(self) -> dict:
        return {"batch": self.batch, "m": self.m, "k": self.k, "n": self.n, "k_layers": self.layers,
                "glu": self.glu, "copies": "float32" if self.glu else "bfloat16"}


def replicated_gemms(cfg):
    """Every product the "replicated" serve launches (decode M = 4 in the
    plain mode, prefill 4 x 128 batched; the GLU's two products as one
    row), at each k_layers of REP_LAYERS, and the LM head at 1 and 8."""
    out = []
    for mode, batch, m in (("decode", 0, BATCH), ("prefill", BATCH, PROMPT)):
        for name, k, n, glu in _projections(cfg):
            out += [RepGemm(f"{mode}/{name}", batch, m, k, n, layers, glu) for layers in REP_LAYERS]
    out += [RepGemm("head", 0, BATCH, cfg.d_model, cfg.vocab, layers) for layers in REP_HEAD_LAYERS]
    return out


def phase_replicated(torch, cfg, gemms, tk, ops):
    """K4/K5 (the partial copies) and K6 (their sum) against their plain
    versions at every serve shape and k_layers, and the public unfused call
    (``ops.sfc_matmul`` / ``sfc_glu_matmul`` with ``fuse=False``) against
    the plain versions' composition; each timed alone and the call as a
    whole, beside the fused K1/K2 and torch.matmul of the same product.
    Then a ragged case of each input type with every epilogue flag at
    k_layers 2, kbf 4 and K = 203 (split 104 + 99, not ceil's 102 + 101),
    on the card against the same call on the CPU."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    dt = torch.bfloat16
    rows, checks = [], []

    def check(case, got, want, tol_dtype, **extra):
        ok, err, worst = within_all(got, want, tol_dtype)
        checks.append({"case": case, "ok": ok, "max_abs_err": err, "err_over_bound": worst, **extra})
        if not ok:
            raise AssertionError(f"{case} disagrees with its plain version: max err {err}, err/bound {worst}")
        return err

    for gm in gemms:
        lead = (gm.batch,) if gm.batch else ()
        kl, cdt = gm.layers, (torch.float32 if gm.glu else dt)
        a = torch.randn((*lead, gm.m, gm.k), generator=gen, device=dev).to(dt)
        # weight copies past the 50 MB L2, as phase 2's K1/K2 rows stream them
        copies = max(1, math.ceil(4 * L2_BYTES / (gm.k * gm.n * 2 * (2 if gm.glu else 1))))
        ws = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)]
        gs = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt)
              for _ in range(copies)] if gm.glu else None
        bm, bn, _ = ops.pick_blocks(gm.m, gm.n, gm.k)

        def k4(i):
            return tk.sfc_gemm_replicated(a, ws[i % copies], k_layers=kl, out_dtype=cdt)

        def k4_plain(i):
            return tk.sfc_gemm_replicated_plain(a, ws[i % copies], bm=bm, bn=bn, k_layers=kl, out_dtype=cdt)

        def public(i):
            if gm.glu:
                return ops.sfc_glu_matmul(a, gs[i % copies], ws[i % copies], activation=cfg.act, fuse=False,
                                          k_layers=kl)
            return ops.sfc_matmul(a, ws[i % copies], fuse=False, k_layers=kl)

        parts = k4(0)
        summed = tk.add_reduce(parts) if kl > 1 else None
        got = public(0)
        torch.cuda.synchronize()
        want = k4_plain(0)
        shape = [gm.batch, gm.m, gm.k, gm.n, kl]
        err = check(f"{gm.kernel}:{gm.name}@L{kl}", parts, want, cdt, shape=shape, copies=str(cdt))
        err6 = check(f"K6:{gm.name}@L{kl}", summed, tk.add_reduce_plain(parts), cdt, shape=shape) if kl > 1 else None
        check(f"unfused:{gm.name}@L{kl}", got,
              composed(tk, a, ws[0], gs[0] if gs else None, activation=cfg.act if gm.glu else None, k_layers=kl),
              dt, shape=shape)
        del want, got, summed

        reps = max(20, copies)
        ms = time_ms(k4, reps=reps, graph=True)
        together_ms = time_ms(public, reps=reps, graph=True)
        fused_ms = time_ms(lambda i: tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies] if gs else None,
                                                       activation=cfg.act if gm.glu else None), reps=reps, graph=True)
        if gm.glu:
            cats = [torch.cat([g, w], dim=1) for g, w in zip(gs, ws)]
            matmul_ms = time_ms(lambda i: torch.matmul(a, cats[i % copies]), reps=reps, graph=True)
            del cats
        else:
            matmul_ms = time_ms(lambda i: torch.matmul(a, ws[i % copies]), reps=reps, graph=True)
        library_ms = None
        if not gm.glu and gm.k % kl == 0:
            # the same copies from one torch.matmul over the K slabs (bf16
            # out; no single call writes the GLU's f32 copies)
            a_sl = a.unflatten(-1, (kl, gm.k // kl)).movedim(-2, -3)
            w_sl = [w.view(kl, gm.k // kl, gm.n) for w in ws]
            library_ms = time_ms(lambda i: torch.matmul(a_sl, w_sl[i % copies]), reps=reps, graph=True)
            del a_sl, w_sl
        plain_ms = time_ms(k4_plain, reps=2, warmup=1)
        bound_ms, bound_by = gm.bound()
        row = dict(gemm=gm, kernel=gm.kernel, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms, together_ms=together_ms, fused_ms=fused_ms,
                   matmul_ms=matmul_ms)
        rows.append(row)
        if kl > 1:
            # K6 timed on copies rotated past the L2, as its bound counts
            # them from device memory (in the serve K4 has just written them)
            n_rot = max(1, math.ceil(4 * L2_BYTES / (parts.numel() * parts.element_size())))
            rot = [parts] + [parts.clone() for _ in range(n_rot - 1)]
            r_bound, r_by = gm.reduce_bound()
            rows.append(dict(gemm=gm, kernel="K6", max_abs_err=err6,
                             ms=time_ms(lambda i: tk.add_reduce(rot[i % n_rot]), reps=max(20, n_rot), graph=True),
                             plain_ms=time_ms(lambda i: tk.add_reduce_plain(parts), reps=2, warmup=1),
                             library_ms=time_ms(lambda i: rot[i % n_rot].float().sum(-3).to(cdt), reps=max(20, n_rot),
                                                graph=True),
                             bound_ms=r_bound, bound_by=r_by))
            del rot
        del ws, gs, a, parts
        torch.cuda.empty_cache()

    # the ragged cases: every epilogue flag, k_layers 2, kbf 4, K = 203
    for dtype in (torch.float32, torch.bfloat16):
        m, k, n = 77, 203, 133
        r = lambda *shp: torch.randn(shp, generator=gen, device=dev).to(dtype)  # noqa: E731
        x, w, wg, bias, gbias, res = r(3, m, k), r(k, n) * 0.1, r(k, n) * 0.1, r(n), r(1, n), r(3, m, n)
        knobs = dict(k_layers=2, k_block_factor=4)
        kw = dict(bias=bias, out_scale=0.7, residual=res, fuse=False, **knobs)
        cpu = {key: v.cpu() if isinstance(v, torch.Tensor) else v for key, v in kw.items()}
        parts = tk.sfc_gemm_replicated(x, w, **knobs)
        got = ops.sfc_matmul(x, w, activation="gelu", **kw)
        got_glu = ops.sfc_glu_matmul(x, wg, w, activation="gelu", gate_bias=gbias, **kw)
        torch.cuda.synchronize()
        extra = dict(dtype=str(dtype), shape=[3, m, k, n], slab=tk.layer_slab(k, 2, 4))
        check("K5:ragged_kbf4", parts, tk.sfc_gemm_replicated_plain(x, w, bm=64, bn=64, **knobs), dtype, **extra)
        check("K6:ragged", tk.add_reduce(parts), tk.add_reduce_plain(parts), dtype, **extra)
        flags = dict(bias=bias, out_scale=0.7, residual=res, activation="gelu", **knobs)
        check("unfused:ragged_all_epilogue_flags", got, composed(tk, x, w, **flags), dtype, **extra)
        check("unfused_glu:ragged_all_epilogue_flags", got_glu, composed(tk, x, w, wg, gate_bias=gbias, **flags),
              dtype, **extra)
        if dtype == torch.float32:  # and against the whole call on the CPU
            check("unfused:ragged_f32_vs_cpu", got,
                  ops.sfc_matmul(x.cpu(), w.cpu(), activation="gelu", bm=64, bn=64, **cpu).to(dev), dtype, **extra)
            check("unfused_glu:ragged_f32_vs_cpu", got_glu,
                  ops.sfc_glu_matmul(x.cpu(), wg.cpu(), w.cpu(), activation="gelu", gate_bias=gbias.cpu(), bm=64,
                                     bn=64, **cpu).to(dev), dtype, **extra)
    return rows, checks


# kernel-name fragments of the serve's GEMM kernels in a profiler trace
_SERVE_KERNEL_GROUPS = (("sfc_gemm_replicated_kernel", "K4/K5"), ("add_reduce_kernel", "K6"),
                        ("sfc_gemm_fused_kernel", "K1/K2"), ("sfc_gemm_cluster_kernel", "K1 cluster"),
                        ("sfc_gemm_wgmma_kernel", "K2 wgmma"), ("decode_split_kernel", "K14"))


def profile_decode(torch, eng, tokens, ops, layers=None):
    """One decode step of 4 sequences (after the 128-token prefill and a
    warm step) under torch.profiler: the wall time until its tokens reach
    the host, the device's busy time (kernels, memcpy, memset), the idle
    share, and the busy time of the GEMM kernels by group.  The profiler
    slows the host, so the wall time and idle share run above an
    unprofiled step's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with ops.knob_defaults(k_layers=layers):
        logits, cache = eng._prefill(tokens)
        logits, cache = eng._decode(logits.argmax(-1)[:, None], cache)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = eng._decode(tok, cache)
            logits.argmax(-1).tolist()
            wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {label: 0.0 for _, label in _SERVE_KERNEL_GROUPS}
    groups["other"] = 0.0
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        groups[next((lab for frag, lab in _SERVE_KERNEL_GROUPS if frag in ev.key), "other")] += us / 1e3
    busy = sum(groups.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms if busy else None,
            "device_ms_by_group": groups}


def composed(tk, a, w, w_gate=None, *, activation=None, bias=None, gate_bias=None, out_scale=None, residual=None,
             **knobs):
    """What the unfused call must return given the kernel's own copies:
    their f32 sum in the copies' type (f32 for the GLU's two products),
    then the epilogue in f32 and one cast.  In bf16 each copy is rounded
    before the sum, so the result is held to the copies the kernel wrote
    (themselves held to their plain version), not to a sum of other
    roundings."""
    import torch

    cdt = torch.float32 if w_gate is not None else a.dtype
    val, gate = (None if b is None else tk.add_reduce_plain(tk.sfc_gemm_replicated(a, b, out_dtype=cdt, **knobs))
                 for b in (w, w_gate))
    return tk._epilogue(val.float(), gate, bias, gate_bias, residual, activation, out_scale).to(a.dtype)


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
        if gm.kind == "nt":  # the wgmma NT kernel and its C tile, or the tile kernel
            got, (name, config) = launched(tk.sfc_gemm_nt.launches_by_kernel, lambda: fn(*ins[0][0]))
        else:
            got, (name, config) = fn(*ins[0][0]), ("tn_kernel", 1)
        want = plain_fn(*ins[0][0], bm=bm, bn=bn)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": f"{gm.kind}:{gm.name}", "shape": [gm.m, gm.k, gm.n], "dual": gm.dual, "ok": ok,
                       "kernel": name, "config": config, "max_abs_err": err, "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"sfc_gemm_{gm.kind} disagrees with its plain version at {gm}: max err {err}, "
                                 f"err/bound {worst}")
        reps = max(20, copies)
        ms = time_ms(lambda i: fn(*ins[i % copies][0]), reps=reps, graph=True)
        lib_ms = time_ms(lambda i: torch.matmul(*ins[i % copies][1]), reps=reps, graph=True)
        plain_ms = time_ms(lambda i: plain_fn(*ins[i % copies][0], bm=bm, bn=bn), reps=2, warmup=1)
        bound_ms, bound_by = _bound(gm.flops(), gm.bytes(2))
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, kernel=name, config=config))
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
    timed: bool = True

    def pairs(self) -> int:
        return Attn("", "sfc_flash_fwd", self.b, self.s, self.t, self.h, self.hkv, self.d, self.causal,
                    self.q_offset).pairs()

    def kernels(self):
        """The (K12, K13) CUDA kernels a call at this case launches: the
        wgmma kernels for bf16 (`uses_bwd_wgmma_kernel`: these cases' head
        dims, groups and layouts), the 64 x 64 tile kernels for f32."""
        if self.dtype == "bfloat16":
            return "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel"
        return "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"

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
        # off the main path: one 2048-token sequence, where the band's flops,
        # not its bytes, bound the kernels
        AttnBwd("band_2048", 1, 2048, 2048, dtype="bfloat16", main_path=False, **heads),
        AttnBwd("ragged_gqa_f32", 1, 190, 250, dtype="float32", q_offset=60, main_path=False, timed=False, **heads),
    ]


def phase_attention_bwd(torch, cases, tsa, build):
    """K12 and K13 against their plain versions (K13's in the kernel's
    summation order: its cluster's parts of the GQA group in turn), each
    launch on the CUDA kernel its case names
    (`AttnBwd.kernels`), the timed cases beside their bound and the
    backward of scaled_dot_product_attention (a yardstick the port never
    calls: one graph of SDPA forward and backward, less one of the forward
    alone; it computes dQ, dK and dV together, so K12 and K13 share it)."""
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
        # the plain versions take the launch's configuration: K13's, its CTAs
        # a cluster, the parts of the group it sums in turn (1 on the tile kernel)
        kernels = {
            "sfc_flash_bwd_dq": (lambda i: tsa.sfc_flash_bwd_dq(*args, **kw),
                                 lambda i, cfg: tsa.sfc_flash_bwd_dq_plain(*args, q_chunk=qc, k_chunk=kc, **kw)),
            "sfc_flash_bwd_dkv": (lambda i: tsa.sfc_flash_bwd_dkv(*args, **kw),
                                  lambda i, cfg: tsa.sfc_flash_bwd_dkv_plain(*args, q_chunk=dqc, k_chunk=dkc,
                                                                             group_parts=cfg, **kw)),
        }
        lib_ms = None
        if c.timed:
            views = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
            do_t = do.transpose(1, 2)

            def sdpa(i):
                return F.scaled_dot_product_attention(*views, is_causal=c.causal, enable_gqa=True)

            def sdpa_fwd_bwd(i):
                return torch.autograd.grad(sdpa(i), views, do_t)

            lib_ms = time_ms(sdpa_fwd_bwd, reps=20, graph=True) - time_ms(sdpa, reps=20, graph=True)
        for (name, (kernel, plain)), cuda_kernel in zip(kernels.items(), c.kernels()):
            got, (launched_kernel, config) = launched(getattr(tsa, name).launches_by_kernel, lambda: kernel(0))
            want = plain(0, config)
            torch.cuda.synchronize()
            ok, err, worst = within_all(got, want, dt)
            checks.append({"case": f"{name}:{c.name}", "shape": c.shape(), "kernel": launched_kernel,
                           "config": config, "ok": ok, "max_abs_err": err, "err_over_bound": worst})
            if launched_kernel != cuda_kernel:
                raise AssertionError(f"{name} at {c} launched {launched_kernel}, expected {cuda_kernel}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at {c}: max err {err}, "
                                     f"err/bound {worst}")
            if not c.timed:
                continue
            bound_ms, bound_by = c.bound(name, 2)
            rows.append(dict(case=c, kernel=name, cuda_kernel=launched_kernel, config=config, max_abs_err=err,
                             ms=time_ms(kernel, reps=20, graph=True),
                             plain_ms=time_ms(lambda i: plain(i, config), reps=2, warmup=1),
                             library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
    return rows, checks


def _is_projection(name: str) -> bool:
    return name.split(".")[-1] in ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "head", "router")


def phase_grad_check(torch, cfg, build_model, gemm_backend, attention_backend, batch, layers=GRAD_CHECK_LAYERS):
    """The config at full width cut to ``layers`` layers, in f32: the loss
    and every parameter's gradient under sfc_cuda + attn_impl="sfc" (K1/K2,
    K7, K8, K11, K12, K13; for olmoe also K3, K9 and K10) against the torch
    backend with blockwise attention, within the bf16 bound; every
    projection weight (the router and the expert stacks included) must get
    a non-zero gradient."""
    from repro_torch.kernels import sfc_attention as tsa

    cfg4 = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32")
    model = build_model(cfg4, device="cuda").init(torch.Generator(device="cuda").manual_seed(7))
    losses, grads = {}, {}
    # the f32 cut's flash backward: every launch on the 64 x 64 tile kernels
    bwd_before = [collections.Counter(f.launches_by_kernel) for f in (tsa.sfc_flash_bwd_dq, tsa.sfc_flash_bwd_dkv)]
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
    bwd_kernels = [by_kernel(collections.Counter(f.launches_by_kernel) - before)
                   for f, before in zip((tsa.sfc_flash_bwd_dq, tsa.sfc_flash_bwd_dkv), bwd_before)]
    if bwd_kernels != [{"flash_bwd_dq_kernel": layers}, {"flash_bwd_dkv_kernel": layers}]:
        raise AssertionError(f"the f32 cut's flash backward launched {bwd_kernels}, expected the tile kernels")
    ok_loss, err_loss, worst_loss = within(losses["sfc_cuda+sfc_attn"], losses["torch"], torch.bfloat16)
    per_param = {n: within(g, grads["torch"][n], torch.bfloat16) for n, g in grads["sfc_cuda+sfc_attn"].items()}
    bad = {n: r for n, r in per_param.items() if not r[0]}
    out = {"arch": cfg.name, "layers": layers, "dtype": "float32", "tokens": list(batch["tokens"].shape),
           "flash_bwd_launches_by_kernel": bwd_kernels,
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


def phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, batches,
                           layers=GRAD_CHECK_LAYERS, abft=None):
    """The config at full width cut to ``layers`` layers, in f32: two
    fused-optimizer steps (sfc_cuda + attn_impl="sfc", AdamW of every
    projection in K8's update flush and, for a MoE config, of every expert
    stack in K10's; the clip exact in two phases) against two unfused
    sfc_cuda steps from the same init, with a clip that binds: losses, grad
    norms, every parameter and every master / mu / nu within the f32 bound,
    exact norm and update launches of both kernels and no dW launch; then a
    third fused step whose gradients are all NaN (a hook on the final
    norm's output): every weight and state bitwise unchanged, the step
    counted.  ``abft``: both runs' `BackendConfig.abft`; under "detect" no
    step may count a detection (the NaN step's NaN residuals are none)."""
    from repro_torch.robust import abft as abft_lib

    abft_lib.reset_runtime_sdc()
    cfg4 = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32")
    kernels = {"sfc_gemm_tn": tk.sfc_gemm_tn, "sfc_gemm_grouped_tn": tk.sfc_gemm_grouped_tn}
    opt_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3, clip_norm=FUSED_CHECK_CLIP)
    runs = {}
    for name, fused in (("unfused", False), ("fused", True)):
        model = build_model(cfg4, device="cuda").init(torch.Generator(device="cuda").manual_seed(7))
        step = make_train_step(model, opt_cfg, backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc",
                                                                     fused_optimizer=fused, abft=abft))
        state = opt.adamw_init(dict(model.named_parameters()))
        metrics = []
        modes0 = {k: dict(fn.launches_by_mode) for k, fn in kernels.items()}
        for batch in batches[:2]:
            state, m = step(state, batch)
            metrics.append({"loss": m["loss"], "grad_norm": m["grad_norm"]})
        torch.cuda.synchronize()
        modes = {k: {mode: v - modes0[k].get(mode, 0) for mode, v in fn.launches_by_mode.items()}
                 for k, fn in kernels.items()}
        runs[name] = (model, step, state, metrics, modes)
    (mu_, _, su, metu, _), (mf, stepf, sf, metf, modesf) = runs["unfused"], runs["fused"]
    # routed a layer: q, k, v, o and the GLU pair and w_out, or q, k, v, o
    # and the two expert projections; the head.  The MoE router stays
    # unrouted (as in the JAX package): its dW runs K8's dW mode.
    per_step = {"sfc_gemm_tn": layers * (4 if cfg.n_experts else 6) + 1,
                "sfc_gemm_grouped_tn": layers * 2 if cfg.n_experts else 0}
    dw_per_step = {"sfc_gemm_tn": layers if cfg.n_experts else 0, "sfc_gemm_grouped_tn": 0}
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
    counts_ok = all(modesf[k].get("norm", 0) == modesf[k].get("update", 0) == 2 * n
                    and modesf[k].get("dw", 0) == 2 * dw_per_step[k] for k, n in per_step.items())
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
    out = {"arch": cfg.name, "layers": layers, "dtype": "float32", "clip_norm": FUSED_CHECK_CLIP,
           "clip_binds": binds,
           "losses": {"fused": [float(m["loss"]) for m in metf], "unfused": [float(m["loss"]) for m in metu]},
           "grad_norms": {"fused": [float(m["grad_norm"]) for m in metf],
                          "unfused": [float(m["grad_norm"]) for m in metu]},
           "worst_err_over_bound": worst, "within_f32_bound": ok, "no_weight_has_grad": no_grad,
           "launches_by_mode_2_steps": modesf, "nonfinite_step_skipped_bitwise": skipped}
    clean = True
    if abft:
        out["abft"] = {"mode": abft, "sdc_detections": abft_lib.runtime_sdc_total(),
                       "checks": abft_lib.runtime_check_total(),
                       "max_residual_over_tol": abft_lib.runtime_max_ratio()}
        clean = out["abft"]["sdc_detections"] == 0 and out["abft"]["checks"] > 0
    del mf, sf, stepf, pf, before, slots
    if not (ok and binds and no_grad and counts_ok and skipped and clean):
        raise AssertionError(f"the fused step disagrees with the unfused one: {out}")
    return out


# kernel-name fragments of the port's kernels in a profiler trace
_KERNEL_GROUPS = (("sfc_gemm_fused_kernel", "K1/K2"), ("sfc_gemm_wgmma_kernel", "K2 wgmma"), ("nt_kernel", "K7"),
                  ("nt_wgmma_kernel", "K7 wgmma"), ("tn_kernel", "K8"),
                  ("tn_update_kernel", "K8 norm/update"), ("flash_fwd_kernel", "K11"),
                  ("flash_bwd_dq_kernel", "K12"), ("flash_bwd_dkv_kernel", "K13"),
                  ("flash_bwd_dq_wgmma_kernel", "K12 wgmma"), ("flash_bwd_dkv_wgmma_kernel", "K13 wgmma"))
# the MoE step's: the grouped kernels first, since "nt_kernel",
# "tn_kernel" and "tn_update_kernel" are fragments of their names too
_MOE_KERNEL_GROUPS = (("sfc_gemm_grouped_kernel", "K3"), ("grouped_nt_kernel", "K9"), ("grouped_tn_kernel", "K10"),
                      ("grouped_tn_update_kernel", "K10 norm/update"), *_KERNEL_GROUPS)


def profile_step(torch, step_fn, opt_state, batch, kernel_groups=_KERNEL_GROUPS):
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
    # a "norm/update" kernel is two groups, split by its UPDATE template argument
    groups = {}
    for _, label in kernel_groups:
        base, split = label.removesuffix(" norm/update"), label.endswith(" norm/update")
        groups.update({f"{base} norm": 0.0, f"{base} update": 0.0} if split else {label: 0.0})
    groups["other"] = 0.0
    top = []
    for ev in prof.key_averages():
        # the device's own activities (kernels, memcpy, memset); a CPU op
        # also reports the device time of the kernels it launched
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        label = next((lab for frag, lab in kernel_groups if frag in ev.key), "other")
        if label.endswith(" norm/update"):  # [grouped_]tn_update_kernel<T, DUAL, UPDATE, SR>
            update = ev.key.split("tn_update_kernel<")[1].split(", ")[2] == "true"
            label = label.removesuffix("norm/update") + ("update" if update else "norm")
        groups[label] += us / 1e3
        top.append((us / 1e3, ev.key[:80]))
    busy = sum(groups.values()) / 1e3
    top.sort(reverse=True)
    # a trace with no device time measured nothing: no idle share then
    return opt_state, {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall if busy else None,
                       "device_ms_by_group": groups, "top_device_ms": top[:10]}


def _tn_mode_counts(counted):
    """Launches by mode of the TN kernels among ``counted`` (K8, and K10
    where the run counts it)."""
    return {f"{name}:{mode}": counted[name].launches_by_mode.get(mode, 0)
            for name in ("sfc_gemm_tn", "sfc_gemm_grouped_tn") if name in counted for mode in ("dw", "norm", "update")}


def _kernel_counts(counted):
    """K1/K2's, K7's, K12's and K13's launches on their wgmma kernels and on
    the 64 x 64 tile kernels (the cluster kernel takes none of a training
    step's)."""
    out = {}
    for name, tile in (("sfc_gemm_fused", "sfc_gemm_fused_kernel"), ("sfc_gemm_nt", "nt_kernel"),
                       ("sfc_flash_bwd_dq", "flash_bwd_dq_kernel"), ("sfc_flash_bwd_dkv", "flash_bwd_dkv_kernel")):
        if name in counted:
            kernels = by_kernel(counted[name].launches_by_kernel)
            out[f"{name}:wgmma"] = sum(n for k, n in kernels.items() if "wgmma" in k)
            out[f"{name}:tile"] = kernels.get(tile, 0)
    return out


def _train_run(torch, cfg, build_trainer, counted, gemm, impl, fused, kernel_groups=_KERNEL_GROUPS, abft=None):
    """TRAIN_STEPS steps of `build_trainer` from seed 0, each step's launch
    counts, times and loss, then a profiled step.  Returns (run summary,
    launches by shape of every counted kernel, their totals).  ``abft``:
    `BackendConfig.abft`; such a run also counts each kernel's launches with
    the checksum lane (``"<kernel>:abft"``) and reports the runtime ABFT
    counters of its steps, and profiles no step."""
    from repro_torch.robust import abft as abft_lib

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt_state, step_fn, batch_fn = build_trainer(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, total_steps=TRAIN_STEPS, seed=0,
        gemm_backend=gemm, attn_impl=impl, fused_optimizer=fused, abft=abft, device="cuda")
    params = dict(model.named_parameters())
    # a fingerprint of each initial parameter (its f64 sum): every
    # parameter's f32 master must move off it
    before = {n: float(p.detach().double().sum()) for n, p in params.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses, times, launches = [], [], []
    for fn in counted.values():
        fn.launches = 0
        if hasattr(fn, "abft_launches"):
            fn.abft_launches = 0
        for counter in ("launches_by_shape", "launches_by_mode", "launches_by_kernel"):
            if hasattr(fn, counter):
                getattr(fn, counter).clear()
    abft_lib.reset_runtime_sdc()

    def counts():
        lanes = {f"{k}:abft": fn.abft_launches for k, fn in counted.items() if abft and hasattr(fn, "abft_launches")}
        return {**{k: fn.launches for k, fn in counted.items()}, **_tn_mode_counts(counted), **lanes,
                **_kernel_counts(counted)}

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
    run = {"losses": losses, "step_s": times, "setup_s": setup_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(), "unchanged_params": unchanged,
           "params_with_grad": [n for n, p in params.items() if p.grad is not None],
           "launches_per_step": launches, "grad_norm_last": float(metrics["grad_norm"])}
    if abft:
        run["abft"] = {"mode": abft, "sdc_detections": abft_lib.runtime_sdc_total(),
                       "checks": abft_lib.runtime_check_total(), "max_residual_over_tol": abft_lib.runtime_max_ratio()}
    by_shape = {k: dict(fn.launches_by_shape) for k, fn in counted.items() if hasattr(fn, "launches_by_shape")}
    by_shape["totals"] = counts()
    if not abft:  # a fourth step, profiled, for the split of its time (not compared)
        opt_state, run["profiled_step"] = profile_step(torch, step_fn, opt_state, batch_fn(TRAIN_STEPS),
                                                       kernel_groups)
    del model, opt_state, step_fn, batch_fn, params, metrics
    torch.cuda.empty_cache()
    return run, by_shape


def _losses_close(a_run, b_run):
    return [math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
            for a, b in zip(a_run["losses"], b_run["losses"])]


def phase_train(torch, cfg, build_trainer, counted):
    """Three steps of `build_trainer` at full width under sfc_cuda +
    attn_impl="sfc", the same steps from the same init with the fused
    optimizer, then under torch + blockwise.  Returns (summary, launches by
    shape of each sfc run)."""
    per_step = cfg.n_layers * 6 + 1
    # every K12 and K13 launch (bf16, D 128) on the wgmma kernels
    layers = {"sfc_flash_fwd": cfg.n_layers, "sfc_flash_bwd_dq": cfg.n_layers, "sfc_flash_bwd_dkv": cfg.n_layers,
              "sfc_flash_bwd_dq:wgmma": cfg.n_layers, "sfc_flash_bwd_dq:tile": 0,
              "sfc_flash_bwd_dkv:wgmma": cfg.n_layers, "sfc_flash_bwd_dkv:tile": 0}
    # every K1/K2 and K7 launch (512 bf16 token rows) on the wgmma kernels
    want = {"sfc_gemm_fused": per_step, "sfc_gemm_nt": per_step, "sfc_gemm_tn": per_step, **layers,
            "sfc_gemm_tn:dw": per_step, "sfc_gemm_tn:norm": 0, "sfc_gemm_tn:update": 0,
            "sfc_gemm_fused:wgmma": per_step, "sfc_gemm_fused:tile": 0, "sfc_gemm_nt:wgmma": per_step,
            "sfc_gemm_nt:tile": 0}
    # the fused step: K8 runs its norm mode in the backward and its update
    # mode after it, and never writes dW
    want_fused = {**want, "sfc_gemm_tn": 2 * per_step, "sfc_gemm_tn:dw": 0, "sfc_gemm_tn:norm": per_step,
                  "sfc_gemm_tn:update": per_step}
    # under ABFT "detect": the same launches, every K1/K2 and K8 one with
    # its checksum lane (K7 and the attention kernels have none)
    want_abft = {**want, "sfc_gemm_fused:abft": per_step, "sfc_gemm_tn:abft": per_step}
    want_fused_abft = {**want_fused, "sfc_gemm_fused:abft": per_step, "sfc_gemm_tn:abft": 2 * per_step}
    runs, by_shape = {}, {}
    for name, (gemm, impl, fused, abft) in (
            ("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc", False, None)),
            ("sfc_cuda+sfc_attn+abft", ("sfc_cuda", "sfc", False, "detect")),
            ("sfc_cuda+sfc_attn+fused_optimizer", ("sfc_cuda", "sfc", True, None)),
            ("sfc_cuda+sfc_attn+fused_optimizer+abft", ("sfc_cuda", "sfc", True, "detect")),
            ("torch", ("torch", "blockwise", False, None))):
        runs[name], shapes = _train_run(torch, cfg, build_trainer, counted, gemm, impl, fused, abft=abft)
        if gemm == "sfc_cuda":
            by_shape[name] = shapes
    sfc, fused, ref = runs["sfc_cuda+sfc_attn"], runs["sfc_cuda+sfc_attn+fused_optimizer"], runs["torch"]
    sfc_abft, fused_abft = runs["sfc_cuda+sfc_attn+abft"], runs["sfc_cuda+sfc_attn+fused_optimizer+abft"]
    loss_ok, fused_ok = _losses_close(sfc, ref), _losses_close(fused, sfc)
    abft_ok = {"unfused": _losses_close(sfc_abft, sfc), "fused": _losses_close(fused_abft, fused)}
    abft_bitwise = {"unfused": sfc_abft["losses"] == sfc["losses"], "fused": fused_abft["losses"] == fused["losses"]}
    out = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "launches_expected_per_step": want,
           "fused_launches_expected_per_step": want_fused, "abft_launches_expected_per_step": want_abft,
           "fused_abft_launches_expected_per_step": want_fused_abft, "loss_within_2^-7": loss_ok,
           "fused_loss_within_2^-7_of_unfused": fused_ok, "abft_loss_within_2^-7_of_off": abft_ok,
           "abft_losses_bitwise_off": abft_bitwise, **{f"{k}": v for k, v in runs.items()}}
    emit(out)
    for run, expect in ((sfc, want), (fused, want_fused), (sfc_abft, want_abft), (fused_abft, want_fused_abft)):
        bad_counts = [i for i, c in enumerate(run["launches_per_step"]) if c != expect]
        if bad_counts:
            raise AssertionError(f"train steps {bad_counts} launched {run['launches_per_step']}, expected {expect}")
    if not all(loss_ok) or not all(fused_ok) or not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"train losses {sfc['losses']} (fused {fused['losses']}) vs torch {ref['losses']}: "
                             "not within 2^-7 or not finite")
    for name, run in (("unfused", sfc_abft), ("fused", fused_abft)):
        if not all(abft_ok[name]) or run["abft"]["sdc_detections"] or not run["abft"]["max_residual_over_tol"] < 1:
            raise AssertionError(f"the {name} train run under ABFT detect: losses {run['losses']}, {run['abft']}")
    for name, run in runs.items():
        if run["unchanged_params"]:
            raise AssertionError(f"{name} training left parameters unchanged: {run['unchanged_params']}")
    if fused["params_with_grad"]:
        raise AssertionError(f"the fused step left weights with a .grad: {fused['params_with_grad']}")
    return out, by_shape


# ---------------------------------------------------------------------------
# olmoe-1b-7b: the grouped expert GEMMs (K3, K9, K10), serving and training
# ---------------------------------------------------------------------------


def moe_rows(cfg, groups: int, tokens_per_group: int) -> int:
    """Rows per expert of the MoE dispatch buffer: groups x capacity, the
    capacity as the JAX package's ``moe_forward`` sets it."""
    cap = max(math.ceil(tokens_per_group * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts), cfg.moe_top_k)
    return groups * cap


@dataclasses.dataclass(frozen=True)
class GroupedGemm:
    """One expert-GEMM launch of olmoe's main path, for the forward (E x
    rows, K) @ (E, K, N): K3 ("fwd"), K9 ("nt": dA (T, K) = dC (T, N)
    W[e]^T) or K10 ("tn": dW[e] (K, N) = A_e^T dC_e); dual for the GLU."""

    name: str
    kind: str  # "fwd" | "nt" | "tn"
    path: str  # the run whose launches the row reports: "serve" | "train"
    experts: int
    rows: int  # per expert
    k: int
    n: int
    glu: bool = False
    preact: bool = False

    @property
    def t(self) -> int:
        return self.experts * self.rows

    @property
    def sets(self) -> int:
        return 2 if self.glu else 1

    @property
    def kernel(self) -> str:
        return {"fwd": "sfc_gemm_grouped", "nt": "sfc_gemm_grouped_nt", "tn": "sfc_gemm_grouped_tn"}[self.kind]

    @property
    def replaces(self) -> str:
        return "src/repro/kernels/sfc_gemm.py:" + {"fwd": "883", "nt": "1642", "tn": "1859"}[self.kind]

    @property
    def key(self):  # the wrapper's launches_by_shape key
        if self.kind == "tn":
            return (self.experts, self.k, self.n, self.t, self.glu)
        return (self.experts, self.t, self.k, self.n, self.glu)

    def flops(self) -> float:
        return 2.0 * self.t * self.k * self.n * self.sets

    def bytes(self, elem: int) -> float:
        """Each input read once, each output written once: every expert's
        weights (the dW stacks for K10) once per launch."""
        w = self.experts * self.k * self.n * self.sets
        if self.kind == "fwd":
            return elem * (self.t * self.k + w + (2 if self.preact else 1) * self.t * self.n)
        if self.kind == "nt":
            return elem * (self.sets * self.t * self.n + w + self.t * self.k)
        return elem * (self.t * self.k + self.sets * self.t * self.n + w)

    def shape(self) -> dict:
        return {"experts": self.experts, "rows_per_expert": self.rows, "k": self.k, "n": self.n, "dual": self.glu,
                "preact": self.preact}


def moe_grouped_gemms(cfg):
    """Every distinct expert GEMM of olmoe's serve (decode at batch 4, the
    4 x 128 prefill) and training step (2 x 256 tokens): the GLU (dual-B;
    the training forward's in preact mode) and w_out, forward, dA and dW."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dec, pre, tr = moe_rows(cfg, BATCH, 1), moe_rows(cfg, BATCH, PROMPT), moe_rows(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out = []
    for path, label, rows in (("serve", "decode", dec), ("serve", "prefill", pre)):
        out += [GroupedGemm(f"{label}/glu", "fwd", path, e, rows, d, f, glu=True),
                GroupedGemm(f"{label}/w_out", "fwd", path, e, rows, f, d)]
    out += [GroupedGemm("train/glu_preact", "fwd", "train", e, tr, d, f, glu=True, preact=True),
            GroupedGemm("train/w_out", "fwd", "train", e, tr, f, d)]
    for kind in ("nt", "tn"):
        out += [GroupedGemm("train/glu", kind, "train", e, tr, d, f, glu=True),
                GroupedGemm("train/w_out", kind, "train", e, tr, f, d)]
    return out


def _grouped_operands(torch, gm, dtype, gen, rows=None):
    """(kernel args, kernel kwargs, library operands) of one grouped GEMM:
    the library call is one torch.bmm over the (E, rows, .) views, the dual
    forms on concatenated operands."""
    dev = torch.device("cuda")
    rows = rows if rows is not None else (gm.rows,) * gm.experts
    t, e, k, n = sum(rows), gm.experts, gm.k, gm.n

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    if gm.kind == "fwd":
        a, w = r(t, k), r(e, k, n, scale=0.02)
        if not gm.glu:
            return (a, w), {}, (a.view(e, -1, k), w) if len(set(rows)) == 1 else None
        wg = r(e, k, n, scale=0.02)
        kw = dict(preact=True) if gm.preact else dict(activation="silu")
        lib = (a.view(e, -1, k), torch.cat([wg, w], dim=2)) if len(set(rows)) == 1 else None
        return (a, w, wg), kw, lib
    if gm.kind == "nt":  # dA (T, K) = dC (T, N) W[e]^T, W as stored (E, K, N)
        dc, w = r(t, n), r(e, k, n, scale=0.02)
        if not gm.glu:
            return (dc, w), {}, (dc.view(e, -1, n), w.transpose(1, 2)) if len(set(rows)) == 1 else None
        dc2, w2 = r(t, n), r(e, k, n, scale=0.02)
        lib = ((torch.cat([dc, dc2], 1).view(e, -1, 2 * n), torch.cat([w, w2], 2).transpose(1, 2))
               if len(set(rows)) == 1 else None)
        return (dc, w, dc2, w2), {}, lib
    a, dc = r(t, k), r(t, n)
    dc2 = r(t, n) if gm.glu else None
    both = torch.cat([dc, dc2], 1) if gm.glu else dc
    lib = (a.view(e, -1, k).transpose(1, 2), both.view(e, -1, both.shape[1])) if len(set(rows)) == 1 else None
    return (a, dc, dc2), {}, lib


def phase_grouped_gemms(torch, gemms, tk):
    """K3, K9 and K10 against their plain versions at every olmoe shape
    (bf16), timed beside their bound and one torch.bmm of the same product;
    then each on the ragged expert sizes RAGGED_GROUPS (one expert empty)
    at olmoe's widths, in f32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    dt = torch.bfloat16
    fns = {"fwd": (tk.sfc_gemm_grouped, tk.sfc_gemm_grouped_plain),
           "nt": (tk.sfc_gemm_grouped_nt, tk.sfc_gemm_grouped_nt_plain),
           "tn": (tk.sfc_gemm_grouped_tn, tk.sfc_gemm_grouped_tn_plain)}
    rows, checks = [], []
    for gm in gemms:
        fn, plain_fn = fns[gm.kind]
        gs = dict(group_sizes=(gm.rows,) * gm.experts)
        # every launch streams every expert's weights (0.27-0.55 GB), far
        # past the 50 MB L2: one copy of the inputs is enough
        copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2)))
        ins = [_grouped_operands(torch, gm, dt, gen) for _ in range(copies)]
        args, kw, _ = ins[0]
        got, want = fn(*args, **gs, **kw), plain_fn(*args, **gs, bm=64, bn=64, **kw)
        torch.cuda.synchronize()
        ok, err, worst = within_all(got, want, dt)
        checks.append({"case": f"{gm.kernel}:{gm.name}", "shape": gm.shape(), "ok": ok, "max_abs_err": err,
                       "err_over_bound": worst})
        if not ok:
            raise AssertionError(f"{gm.kernel} disagrees with its plain version at {gm}: max err {err}, "
                                 f"err/bound {worst}")
        del got, want
        reps = max(20, copies)
        ms = time_ms(lambda i: fn(*ins[i % copies][0], **gs, **ins[i % copies][1]), reps=reps, graph=True)
        lib_ms = time_ms(lambda i: torch.bmm(*ins[i % copies][2]), reps=reps, graph=True)
        plain_ms = time_ms(lambda i: plain_fn(*args, **gs, bm=64, bn=64, **kw), reps=1, warmup=0)
        bound_ms, bound_by = _bound(gm.flops(), gm.bytes(2))
        rows.append(dict(gemm=gm, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        del ins, args
        torch.cuda.empty_cache()
    # the ragged checks: the olmoe widths, four experts, one of them empty
    d, f = gemms[0].k, gemms[0].n
    e = len(RAGGED_GROUPS)
    ragged = [GroupedGemm("ragged/glu", "fwd", "-", e, 0, d, f, glu=True),
              GroupedGemm("ragged/glu_preact", "fwd", "-", e, 0, d, f, glu=True, preact=True),
              GroupedGemm("ragged/w_out", "fwd", "-", e, 0, f, d)]
    ragged += [GroupedGemm(f"ragged/{w}", kind, "-", e, 0, *kn, glu=glu) for kind in ("nt", "tn")
               for w, kn, glu in (("glu", (d, f), True), ("w_out", (f, d), False))]
    for dtype in (torch.float32, torch.bfloat16):
        for gm in ragged:
            fn, plain_fn = fns[gm.kind]
            args, kw, _ = _grouped_operands(torch, gm, dtype, gen, rows=RAGGED_GROUPS)
            got = fn(*args, group_sizes=RAGGED_GROUPS, **kw)
            torch.cuda.synchronize()
            ok, err, worst = within_all(got, plain_fn(*args, group_sizes=RAGGED_GROUPS, bm=64, bn=64, **kw), dtype)
            if gm.kind == "tn":  # the empty expert's weight gradient is exactly zero
                ok = ok and not any(bool(g[1].any()) for g in (got if gm.glu else [got]))
            checks.append({"case": f"{gm.kernel}:{gm.name}", "dtype": str(dtype), "group_sizes": list(RAGGED_GROUPS),
                           "shape": gm.shape(), "ok": ok, "max_abs_err": err, "err_over_bound": worst})
            if not ok:
                raise AssertionError(f"{gm.kernel} ragged case {gm.name} ({dtype}) disagrees: max err {err}")
    return rows, checks


@dataclasses.dataclass(frozen=True)
class GroupedUpdGemm:
    """K10 in its update or norm mode for the expert projection (E x rows,
    K) @ (E, K, N): each dW_e (K, N) = A_e^T dC_e in the f32 accumulators,
    then per-expert AdamW against the f32 master / mu / nu stacks and W
    written (update), or only sum(dW^2) (norm); dual for the GLU pair."""

    name: str
    mode: str  # "update" | "norm"
    experts: int
    rows: int  # per expert
    k: int
    n: int
    glu: bool = False

    @property
    def t(self) -> int:
        return self.experts * self.rows

    @property
    def sets(self) -> int:
        return 2 if self.glu else 1

    @property
    def key(self):  # sfc_gemm_grouped_tn.launches_by_shape's key for the mode
        return (self.experts, self.k, self.n, self.t, self.glu, self.mode)

    def flops(self) -> float:
        return 2.0 * self.t * self.k * self.n * self.sets

    def bytes(self, elem: int) -> float:
        """A and dC read once; update: 12 B of f32 state read and 14 B (the
        state and W) written per weight element of every expert; norm: the
        per-task partials."""
        operands = elem * (self.t * self.k + self.sets * self.t * self.n)
        if self.mode == "update":
            return operands + 26.0 * self.sets * self.experts * self.k * self.n
        return operands + 4.0 * self.sets * self.experts * math.ceil(self.k / 64) * math.ceil(self.n / 64)


def moe_update_gemms(cfg):
    """K10's update mode at olmoe's two expert projections of the training
    step, 80 rows an expert (its norm mode runs the same shapes)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    tr = moe_rows(cfg, TRAIN_BATCH, TRAIN_SEQ)
    return [GroupedUpdGemm("train/glu", "update", e, tr, d, f, glu=True),
            GroupedUpdGemm("train/w_out", "update", e, tr, f, d)]


def phase_grouped_update_gemms(torch, cfg, tk, opt):
    """K10's update and norm modes against their plain versions at olmoe's
    training shapes in bf16 (stochastic rounding on, the main path, timed),
    then on the ragged expert sizes RAGGED_GROUPS at olmoe's widths in f32
    and bf16, the empty expert's g = 0 update included: master, mu and nu
    within the f32 bound; a bf16 W bitwise the stochastic rounding of the
    kernel's own master with the plain version's grouped tile bits and
    within the bf16 bound of the plain W, an f32 W the new master; the
    norms within the f32 bound, the norm mode's bitwise the update mode's.
    Yardstick: torch.bmm per set to an f32 dW stack plus
    torch._fused_adamw_ on the same state (they write no bf16 W)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device=dev),
                                 torch.tensor(0.37, device=dev))
    salt = (5 << 16) + 3
    rows, checks = [], []

    def r(shape, scale, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def inputs(gm, dt, sizes):
        """(x, [dC per set], [(master, mu, nu, W) per set]): a later step's
        state, its moments on the scale of dW (about sqrt(rows))."""
        g, t, stack = math.sqrt(max(sizes)), sum(sizes), (gm.experts, gm.k, gm.n)
        x, dcs = r((t, gm.k), 1.0, dt), [r((t, gm.n), 1.0, dt) for _ in range(gm.sets)]
        sets = []
        for _ in range(gm.sets):
            mst = r(stack, 0.02)
            sets.append((mst, r(stack, 0.5 * g), r(stack, 2.0 * g) ** 2 + 1.0, mst.to(dt)))
        return x, dcs, sets

    def update(fn, x, dcs, sets, sizes, dt, **kw):
        (m1, u1, v1, w1), *rest = sets
        extra = dict(w2=rest[0][3]) if rest else {}
        second = list(rest[0][:3]) if rest else [None] * 3
        return fn(x, dcs[0], dcs[1] if rest else None, m1, u1, v1, *second, hyper, group_sizes=sizes, w=w1,
                  salt=salt, stochastic_round=dt == torch.bfloat16, **extra, **kw)

    def check(gm, dt, sizes, case):
        """Kernel against plain on fresh inputs; returns (result, plain ms
        of the update, the inputs)."""
        x, dcs, sets = inputs(gm, dt, sizes)
        got_sets, want_sets = [tuple(v.clone() for v in st) for st in sets], [tuple(v.clone() for v in st)
                                                                               for st in sets]
        got = update(tk.sfc_gemm_grouped_tn, x, dcs, got_sets, sizes, dt)
        norm_only = tk.sfc_gemm_grouped_tn(x, *dcs, group_sizes=sizes, norm=True)
        torch.cuda.synchronize()
        want = []
        plain_ms = time_ms(lambda i: want.append(update(tk.sfc_gemm_grouped_tn_plain, x, dcs, want_sets, sizes, dt,
                                                        bm=64, bn=64)), reps=1, warmup=0)
        ok, norm_err, worst = within(got, want[0], torch.float32)
        res = {"case": f"sfc_gemm_grouped_tn:update:{case}", "dtype": str(dt), "group_sizes": list(sizes),
               "shape": {"experts": gm.experts, "k": gm.k, "n": gm.n, "dual": gm.glu}, "norm_ok": ok,
               "norm_max_abs_err": norm_err, "norm_err_over_bound": worst,
               "norm_mode_bitwise": bool(torch.equal(norm_only, got))}
        err, worst_state, w_bitwise, empty_moved = 0.0, 0.0, True, True
        for s, (g_set, p_set, o_set) in enumerate(zip(got_sets, want_sets, sets)):
            for g_, w_ in zip(g_set, p_set):
                ok_s, err_s, worst_s = within(g_, w_, torch.float32 if g_.dtype == torch.float32 else dt)
                ok, err, worst_state = ok and ok_s, max(err, err_s), max(worst_state, worst_s)
            if dt == torch.bfloat16:
                bits = tk._grouped_tile_bits(gm.experts, gm.k, gm.n, 64, 64, hyper, salt, s)
                w_bitwise &= bool(torch.equal(g_set[3], tk.stochastic_round_to(g_set[0], bits, dt)))
                del bits
            else:
                w_bitwise &= bool(torch.equal(g_set[3], g_set[0]))
            # an empty expert's moments decay: its g = 0 update ran
            empty_moved &= all(not torch.equal(g_set[1][e], o_set[1][e]) for e, z in enumerate(sizes) if z == 0)
        res.update(ok=ok and w_bitwise and empty_moved and res["norm_mode_bitwise"], max_abs_err=err,
                   state_err_over_bound=worst_state, w_bitwise_sr_of_master=w_bitwise,
                   empty_experts_updated=empty_moved)
        checks.append(res)
        if not res["ok"]:
            raise AssertionError(f"sfc_gemm_grouped_tn update / norm mode disagrees with its plain version: {res}")
        return res, plain_ms, (x, dcs, sets)

    for gm in moe_update_gemms(cfg):
        dt, sizes = torch.bfloat16, (gm.rows,) * gm.experts
        res, plain_upd_ms, (x, dcs, sets) = check(gm, dt, sizes, gm.name)
        # every launch streams 3.5-7 GB of state, far past the 50 MB L2: one copy of the inputs
        step_t = torch.zeros((), device=dev)
        e, rows_e = gm.experts, gm.rows

        def library(i):
            grads = [torch.bmm(x.view(e, rows_e, gm.k).transpose(1, 2), d.view(e, rows_e, gm.n),
                               out_dtype=torch.float32) for d in dcs]
            torch._fused_adamw_([st[0] for st in sets], grads, [st[1] for st in sets], [st[2] for st in sets], [],
                                [step_t] * len(sets), lr=1e-2, beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
                                amsgrad=False, maximize=False)

        upd_ms = time_ms(lambda i: update(tk.sfc_gemm_grouped_tn, x, dcs, sets, sizes, dt), reps=20, graph=True)
        norm_ms = time_ms(lambda i: tk.sfc_gemm_grouped_tn(x, *dcs, group_sizes=sizes, norm=True), reps=20,
                          graph=True)
        lib_ms = time_ms(library, reps=20, graph=True)
        plain_norm_ms = time_ms(lambda i: tk.sfc_gemm_grouped_tn_plain(x, *dcs, group_sizes=sizes, norm=True, bm=64,
                                                                       bn=64), reps=1, warmup=0)
        for mode, ms, plain_ms, l_ms in (("update", upd_ms, plain_upd_ms, lib_ms),
                                         ("norm", norm_ms, plain_norm_ms, None)):
            g2 = dataclasses.replace(gm, mode=mode)
            bound_ms, bound_by = _bound(g2.flops(), g2.bytes(2))
            rows.append(dict(gemm=g2, max_abs_err=res["max_abs_err"] if mode == "update" else res["norm_max_abs_err"],
                             ms=ms, plain_ms=plain_ms, library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by))
        del x, dcs, sets
        torch.cuda.empty_cache()
    # the ragged checks: olmoe's widths, four experts, one of them empty
    for dt in (torch.float32, torch.bfloat16):
        for gm in moe_update_gemms(cfg):
            check(dataclasses.replace(gm, experts=len(RAGGED_GROUPS), rows=0), dt, RAGGED_GROUPS,
                  f"ragged/{gm.name.split('/')[1]}")
    torch.cuda.empty_cache()
    return rows, checks


def moe_routing_at_divergence(torch, np, engines, prompts, tokens_of, top_k):
    """Why the bf16 sfc_cuda serve's greedy tokens leave the torch
    backend's.  Both engines replay the serve (the same prompts, then
    decode steps fed the torch run's tokens, which both runs chose up to
    each request's first divergent token) with every MoE layer's routing
    recorded.  For each request that diverged, at the step that produced
    its first divergent token: the layers whose top-k expert sets differ
    between the backends, the first of them, and, per differing set, the
    torch router's probability of the expert it chose over the one sfc_cuda
    chose in its place (the swap's gap), beside the median gap between the
    torch router's k-th and (k+1)-th expert at that step and the largest
    difference of the two routers' probabilities there; the torch logits'
    top-1 margin at that step; and the (token, layer) sets of the request
    that differ over all its tokens up to that step (the prompt's included)."""
    import repro_torch.models.moe as moe_mod

    route = moe_mod.route
    seen = []

    def recording(*args, **kw):
        r = route(*args, **kw)
        g, tg = r.probs.shape[:2]
        seen.append((r.probs.float(), r.flat_e.reshape(g, tg, top_k)))
        return r

    first = {i: int(np.nonzero(tokens_of["sfc_cuda"][i] != tokens_of["torch"][i])[0][0])
             for i in range(len(prompts)) if (tokens_of["sfc_cuda"][i] != tokens_of["torch"][i]).any()}
    if not first:
        return {"diverged_requests": 0}
    steps = max(first.values())
    dev = engines["torch"].device
    forced = torch.from_numpy(tokens_of["torch"]).long().to(dev)
    rec = {}  # name -> [(routing of each layer, logits)] for step 0 (prefill) .. steps
    moe_mod.route = recording
    try:
        for name in ("sfc_cuda", "torch"):
            eng, rec[name] = engines[name], []
            seen.clear()
            logits, cache = eng._prefill(torch.from_numpy(np.stack(prompts)).long().to(dev))
            rec[name].append((list(seen), logits.float()))
            for s in range(1, steps + 1):
                seen.clear()
                logits, cache = eng._decode(forced[:, s - 1:s], cache)
                rec[name].append((list(seen), logits.float()))
    finally:
        moe_mod.route = route
    out = {"diverged_requests": len(first), "requests": []}
    for i, j in sorted(first.items()):
        layers_s, logits_t = rec["sfc_cuda"][j][0], rec["torch"][j][1]
        layers_t = rec["torch"][j][0]
        differ, gaps, margins, prob_diff = [], [], [], 0.0
        for layer, ((ps, es), (pt, et)) in enumerate(zip(layers_s, layers_t)):
            ps, es, pt, et = ps[i, -1], es[i, -1], pt[i, -1], et[i, -1]  # the step's last token
            top = torch.sort(pt, descending=True).values
            margins.append(float(top[top_k - 1] - top[top_k]))
            prob_diff = max(prob_diff, float((ps - pt).abs().max()))
            chose_s, chose_t = set(es.tolist()), set(et.tolist())
            if chose_s != chose_t:
                differ.append(layer)
                gaps.append(float(max(pt[e] for e in chose_t - chose_s) - min(pt[e] for e in chose_s - chose_t)))
        upto, total = 0, 0
        for k in range(j + 1):
            for (ps, es), (pt, et) in zip(rec["sfc_cuda"][k][0], rec["torch"][k][0]):
                a, b = torch.sort(es[i], dim=-1).values, torch.sort(et[i], dim=-1).values
                upto += int((a != b).any(dim=-1).sum())
                total += a.shape[0]
        lt = torch.sort(logits_t[i], descending=True).values
        out["requests"].append({
            "request": i, "first_divergent_token": j, "step": "prefill" if j == 0 else f"decode {j}",
            "layers_with_different_topk": len(differ), "layers": len(layers_t),
            "first_layer_different": differ[0] if differ else None,
            "swapped_prob_gap_torch": gaps,
            # a model without MoE layers records no routing: nothing to take the median of
            "topk_margin_median_torch": float(np.median(margins)) if margins else None,
            "max_abs_router_prob_diff": prob_diff, "torch_top1_logit_margin": float(lt[0] - lt[1]),
            "sets_different_through_step": upto, "sets_through_step": total})
    return out


def phase_moe_serve(torch, np, cfg, build_model, ServingEngine, tk, tsa):
    """ServingEngine serves full-width, full-depth olmoe-1b-7b (bf16, random
    weights from a seeded torch.Generator), 4 requests x 128 + 16 tokens,
    under sfc_cuda GEMMs with blockwise attention and with attn_impl="sfc",
    and under the torch backend: exactly 2 K3 launches a layer a forward
    and 5 K1/K2 a layer (q, k, v, o, the router) plus the head; the
    prefill logits of the same weights cut to MOE_SERVE_F32_LAYERS layers
    in f32 within the bf16 bound of the torch backend's.  Then the sfc_cuda
    serve again under ABFT "detect" (the prefill in `abft_mode`, every
    decode step verified, ``verify_every=1``): no detection, the same
    tokens and launches, every K3 and K1/K2 launch with its checksum lane.
    Returns (summary, K3 launches by shape of the sfc_cuda run and of the
    one under ABFT)."""
    from repro_torch.robust import abft
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    variants = {"sfc_cuda": ("sfc_cuda", "blockwise"), "sfc_cuda+sfc_attn": ("sfc_cuda", "sfc"),
                "torch": ("torch", "blockwise")}

    def engine(name, config, weights):
        gemm, impl = variants[name]
        return ServingEngine(dataclasses.replace(config, attn_impl=impl), weights, max_batch=BATCH,
                             max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend=gemm, device="cuda")

    engines = {name: engine(name, cfg, params) for name in variants}
    for eng in engines.values():  # warm-up: first launches, allocator, cuBLAS handles
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))
    torch.cuda.synchronize()
    n_layers = cfg.n_layers
    counted = {"sfc_gemm_grouped": tk.sfc_gemm_grouped, "sfc_gemm_fused": tk.sfc_gemm_fused,
               "sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_decode_attention": tsa.sfc_decode_attention}
    gemm_want = {"sfc_gemm_grouped": 2 * n_layers * NEW_TOKENS, "sfc_gemm_fused": (5 * n_layers + 1) * NEW_TOKENS}
    want = {"sfc_cuda": {**gemm_want, "sfc_flash_fwd": 0, "sfc_decode_attention": 0},
            "sfc_cuda+sfc_attn": {**gemm_want, "sfc_flash_fwd": n_layers,
                                  "sfc_decode_attention": n_layers * (NEW_TOKENS - 1)},
            "torch": {k: 0 for k in counted}}
    # the prefill's K1/K2 (4 x 128 rows) on the wgmma kernel, every decode
    # step's (4 rows) and the prefill's head (its last positions) on the
    # cluster kernel
    want_by_kernel = {"sfc_gemm_wgmma_kernel": 5 * n_layers,
                      "sfc_gemm_cluster_kernel": (5 * n_layers + 1) * NEW_TOKENS - 5 * n_layers}
    done, launches, by_shape, launches_by_kernel = {}, {}, {}, {}
    for name, eng in engines.items():
        for fn in counted.values():
            fn.launches = 0
            if hasattr(fn, "launches_by_shape"):
                fn.launches_by_shape.clear()
        tk.sfc_gemm_fused.launches_by_kernel.clear()
        done[name] = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
        launches[name] = {k: fn.launches for k, fn in counted.items()}
        launches_by_kernel[name] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
        if name == "sfc_cuda":
            by_shape = dict(tk.sfc_gemm_grouped.launches_by_shape)
    # the sfc_cuda serve under ABFT "detect": a fresh engine (its verify
    # ledger starts at 0) after a warm-up one
    for _ in range(2):
        abft_eng = ServingEngine(dataclasses.replace(cfg, attn_impl="blockwise"), params, max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1,
                                 gemm_backend="sfc_cuda", device="cuda", verify_every=1)
        for fn in counted.values():
            fn.launches = 0
            if hasattr(fn, "launches_by_shape"):
                fn.launches_by_shape.clear()
        tk.sfc_gemm_grouped.abft_launches = tk.sfc_gemm_fused.abft_launches = 0
        tk.sfc_gemm_fused.launches_by_kernel.clear()
        abft.reset_runtime_sdc()
        with abft.abft_mode("detect"):
            done["sfc_cuda+abft"] = abft_eng.run(abft_eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
    launches_by_kernel["sfc_cuda+abft"] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
    launches["sfc_cuda+abft"] = {**{k: fn.launches for k, fn in counted.items()},
                                 "sfc_gemm_grouped:abft": tk.sfc_gemm_grouped.abft_launches,
                                 "sfc_gemm_fused:abft": tk.sfc_gemm_fused.abft_launches}
    want["sfc_cuda+abft"] = {**want["sfc_cuda"], "sfc_gemm_grouped:abft": gemm_want["sfc_gemm_grouped"],
                             "sfc_gemm_fused:abft": gemm_want["sfc_gemm_fused"]}
    abft_by_shape = dict(tk.sfc_gemm_grouped.launches_by_shape)
    abft_serve = {"verify": abft_eng.degradation_report()["verify"], "sdc_detections": abft.runtime_sdc_total(),
                  "checks": abft.runtime_check_total(), "max_residual_over_tol": abft.runtime_max_ratio()}
    del abft_eng
    for batch in done.values():
        for r in batch:
            if (r.status != "completed" or len(r.output) != NEW_TOKENS
                    or not all(0 <= t < cfg.vocab for t in r.output)):
                raise AssertionError(f"olmoe request {r.uid} ended {r.status} with {len(r.output or [])} tokens")
    reports = {name: ServingEngine.latency_report(batch) for name, batch in done.items()}
    tokens_of = {name: np.array([r.output for r in batch]) for name, batch in done.items()}
    abft_serve["tokens_identical_to_off"] = bool((tokens_of["sfc_cuda+abft"] == tokens_of["sfc_cuda"]).all())
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}
    divergence = moe_routing_at_divergence(torch, np, engines, prompts, tokens_of, cfg.moe_top_k)
    del engines, eng
    for name, lg in logits.items():
        if tuple(lg.shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"olmoe {name} prefill logits shape {tuple(lg.shape)} or non-finite values")
    # the f32 check on a cut: in bf16 the router's logits round to ties that
    # the two backends break differently, so only f32 isolates the kernels
    cut = dataclasses.replace(cfg, n_layers=MOE_SERVE_F32_LAYERS, param_dtype="float32")
    cut_params = {k: v.float() for k, v in params.items()
                  if not k.startswith("layers.") or int(k.split(".")[1]) < MOE_SERVE_F32_LAYERS}
    logits32 = {name: engine(name, cut, cut_params)._prefill(tokens)[0] for name in variants}
    del cut_params
    torch.cuda.synchronize()
    f32_agree = {name: dict(zip(("ok", "max_abs_err", "err_over_bound"),
                                within(logits32[name], logits32["torch"], torch.bfloat16)))
                 for name in ("sfc_cuda", "sfc_cuda+sfc_attn")}
    out = {
        "phase": "serve_moe", "arch": cfg.name, "layers": n_layers, "d_model": cfg.d_model,
        "experts": cfg.n_experts, "top_k": cfg.moe_top_k, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
        "params": n_params, "init_s": init_s, "requests": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
        "launches": launches, "launches_expected": want,
        "sfc_gemm_fused_launches_by_kernel": launches_by_kernel, "by_kernel_expected": want_by_kernel,
        "prefill_logits": {
            "f32_cut_layers": MOE_SERVE_F32_LAYERS, "f32_vs_torch": f32_agree,
            "bf16_sfc_cuda_vs_torch_mean_abs_err": float((logits["sfc_cuda"] - logits["torch"]).abs().mean()),
            "bf16_max_abs_logit": float(logits["torch"].abs().max()),
        },
        "first_token_match": {name: float((logits[name].argmax(-1) == logits["torch"].argmax(-1)).float().mean())
                              for name in ("sfc_cuda", "sfc_cuda+sfc_attn")},
        "greedy_token_match": {name: float((tokens_of[name] == tokens_of["torch"]).mean())
                               for name in ("sfc_cuda", "sfc_cuda+sfc_attn")},
        "routing_at_divergence": divergence,
        "latency": reports,
        "abft_detect": abft_serve,
    }
    emit(out)
    del model, params, logits, logits32
    gc.collect()
    torch.cuda.empty_cache()
    for name, expect in want.items():
        if launches[name] != expect:
            raise AssertionError(f"olmoe {name} serve launched {launches[name]}, expected {expect}")
        if name != "torch" and launches_by_kernel[name] != want_by_kernel:
            raise AssertionError(f"olmoe {name} serve launched K1/K2 {launches_by_kernel[name]} by kernel, "
                                 f"expected {want_by_kernel}")
    for name, res in f32_agree.items():
        if not res["ok"]:
            raise AssertionError(f"olmoe f32 prefill logits {name} vs torch: max err {res['max_abs_err']}, "
                                 f"err/bound {res['err_over_bound']}")
    if abft_serve["sdc_detections"] or not abft_serve["tokens_identical_to_off"] or not (
            abft_serve["max_residual_over_tol"] < 1):
        raise AssertionError(f"the olmoe serve under ABFT detect: {abft_serve}")
    return out, by_shape, abft_by_shape


def phase_moe_train(torch, cfg, build_trainer, counted):
    """Three steps of `build_trainer` on olmoe-1b-7b at full width and
    MOE_TRAIN_LAYERS layers under sfc_cuda + attn_impl="sfc" (K3, K9, K10
    for the experts; K1/K2, K7, K8 for attention, the router and the head;
    K11-K13), the same steps from the same init with the fused optimizer
    (K8's and K10's norm and update modes, no dW launch, no routed weight
    left with a .grad), then under torch + blockwise: exact launches a
    step, every unfused loss within 2^-7 of the torch backend's and every
    fused loss within 2^-7 of the unfused one's, every parameter moved;
    then a profiled step of each.  Returns (summary, launches by shape of
    each sfc run)."""
    cut = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    n_layers = MOE_TRAIN_LAYERS
    dense = 5 * n_layers + 1  # q, k, v, o and the router a layer, plus the head
    grouped = 2 * n_layers  # the GLU pair and w_out a layer
    want = {"sfc_gemm_fused": dense, "sfc_gemm_nt": dense, "sfc_gemm_tn": dense,
            "sfc_gemm_tn:dw": dense, "sfc_gemm_tn:norm": 0, "sfc_gemm_tn:update": 0,
            "sfc_gemm_fused:wgmma": dense, "sfc_gemm_fused:tile": 0, "sfc_gemm_nt:wgmma": dense,
            "sfc_gemm_nt:tile": 0,
            "sfc_gemm_grouped": grouped, "sfc_gemm_grouped_nt": grouped, "sfc_gemm_grouped_tn": grouped,
            "sfc_gemm_grouped_tn:dw": grouped, "sfc_gemm_grouped_tn:norm": 0, "sfc_gemm_grouped_tn:update": 0,
            "sfc_flash_fwd": n_layers, "sfc_flash_bwd_dq": n_layers, "sfc_flash_bwd_dkv": n_layers,
            "sfc_flash_bwd_dq:wgmma": n_layers, "sfc_flash_bwd_dq:tile": 0,
            "sfc_flash_bwd_dkv:wgmma": n_layers, "sfc_flash_bwd_dkv:tile": 0}
    # the fused step: K8 and K10 run their norm mode in the backward and
    # their update mode after it, and never write a routed weight's dW; the
    # router stays unrouted, as in the JAX package (its dW: K8's dW mode)
    routed = dense - n_layers
    want_fused = {**want, "sfc_gemm_tn": 2 * routed + n_layers, "sfc_gemm_tn:dw": n_layers,
                  "sfc_gemm_tn:norm": routed, "sfc_gemm_tn:update": routed, "sfc_gemm_grouped_tn": 2 * grouped,
                  "sfc_gemm_grouped_tn:dw": 0, "sfc_gemm_grouped_tn:norm": grouped,
                  "sfc_gemm_grouped_tn:update": grouped}
    runs, by_shape = {}, {}
    for name, (gemm, impl, fused) in (("sfc_cuda+sfc_attn", ("sfc_cuda", "sfc", False)),
                                      ("sfc_cuda+sfc_attn+fused_optimizer", ("sfc_cuda", "sfc", True)),
                                      ("torch", ("torch", "blockwise", False))):
        runs[name], shapes = _train_run(torch, cut, build_trainer, counted, gemm, impl, fused, _MOE_KERNEL_GROUPS)
        if gemm == "sfc_cuda":
            by_shape[name] = shapes
    sfc, fused, ref = runs["sfc_cuda+sfc_attn"], runs["sfc_cuda+sfc_attn+fused_optimizer"], runs["torch"]
    loss_ok, fused_ok = _losses_close(sfc, ref), _losses_close(fused, sfc)
    out = {"phase": "train_moe", "arch": cfg.name, "layers": n_layers, "layers_of_config": cfg.n_layers,
           "params_bytes_per_param": 16, "dtype": cfg.param_dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "launches_expected_per_step": want, "fused_launches_expected_per_step": want_fused,
           "loss_within_2^-7": loss_ok, "fused_loss_within_2^-7_of_unfused": fused_ok, **runs}
    emit(out)
    for run, expect in ((sfc, want), (fused, want_fused)):
        bad_counts = [i for i, c in enumerate(run["launches_per_step"]) if c != expect]
        if bad_counts:
            raise AssertionError(f"olmoe train steps {bad_counts} launched {run['launches_per_step']}, "
                                 f"expected {expect}")
    if not all(loss_ok) or not all(fused_ok) or not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"olmoe train losses {sfc['losses']} (fused {fused['losses']}) vs torch "
                             f"{ref['losses']}: not within 2^-7 or not finite")
    for name, run in runs.items():
        if run["unchanged_params"]:
            raise AssertionError(f"olmoe {name} training left parameters unchanged: {run['unchanged_params']}")
    if fused["params_with_grad"]:
        raise AssertionError(f"the fused olmoe step left weights with a .grad: {fused['params_with_grad']}")
    return out, by_shape


# ---------------------------------------------------------------------------
# ABFT: the checksum lanes of K1/K2, K3 and K8 (dW, update, norm)
# ---------------------------------------------------------------------------

# exponent bit 4 of a bf16 / f32 element: flipped on an element of
# magnitude in [2, 65536), it multiplies that element by 2^16
_EXP_BIT4 = {"bfloat16": 1 << 11, "float32": 1 << 27}


def flip_exponent_bit(torch, x):
    """A copy of ``x`` with exponent bit 4 of its largest element flipped:
    one input element corrupted silently, 2^16 times larger."""
    flat = x.detach().reshape(-1).clone()
    i = int(flat.float().abs().argmax())
    if not 2.0 <= abs(float(flat[i])) < 65536.0:
        raise AssertionError(f"the largest element {float(flat[i])} is not in [2, 65536)")
    bits = flat.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    bits[i] = bits[i] ^ _EXP_BIT4[str(x.dtype).split(".")[1]]
    return flat.reshape(x.shape)


def _once_ms(torch, fn):
    """(result, ms) of one call, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# A lane and its plain version's lane sum the same f32 raw accumulators in
# other orders, so they are held far inside `tolerance()` (which allows for
# the operand side's reassociation and, for bf16, a cast): within LANE_RTOL
# of the sum of |each tile's raw sum| at LANE_TILE x LANE_TILE tiles.  A
# lane that wrote 0, dropped a task or summed after the epilogue misses it
# (the lane-side controls).  On an H100 the lanes came within 0.32 of it
# (bf16 at decode) and every control missed it by 3x or more.
LANE_RTOL = 1e-5
LANE_TILE = 64


def raw_tile_sums(torch, *raws, tile=(LANE_TILE, LANE_TILE)):
    """The f32 sum of each ``tile`` block (edge blocks clipped) of the last
    two dims of the raw products ``raws``, the raws added block by block as
    the GLU's lane adds its two accumulators: a lane's partials at that
    tile, flattened, the bottom-right block last."""
    tr, tc = tile
    total = None
    for c in raws:
        r, k = c.shape[-2:]
        c = torch.nn.functional.pad(c.float(), (0, -k % tc, 0, -r % tr))
        s = c.reshape(*c.shape[:-2], c.shape[-2] // tr, tr, c.shape[-1] // tc, tc).sum(dim=(-3, -1))
        total = s if total is None else total + s
    return total.reshape(-1)


def kernel_tiles(torch, name, config, *raws):
    """`raw_tile_sums` over the tiles a K1/K2 launch's lane sums: the
    wgmma kernel's C tile (``config``, "128x256") over the rows of every
    batch element together (shared weights fold the batch into the rows),
    else LANE_TILE x LANE_TILE tiles of each batch element."""
    if name != "sfc_gemm_wgmma_kernel":
        return raw_tile_sums(torch, *raws)
    tile = tuple(int(x) for x in config.split("x"))
    return raw_tile_sums(torch, *(c.reshape(-1, c.shape[-1]) for c in raws), tile=tile)


def lane_limit(tiles, tol):
    """How far a lane may sit from its plain version's: LANE_RTOL of the
    sum of |tile sums|, never more than ``tol`` (`tolerance()`)."""
    return min(LANE_RTOL * float(tiles.abs().sum()) + 1e-30, float(tol))


def grouped_raw(torch, a, w, sizes):
    """(E, max rows, N) f32 raw products of a grouped GEMM: expert e's rows
    of ``a`` (sorted by expert) against ``w[e]``, from row 0 of its slab
    (zero rows below), so that its row blocks are the kernel's."""
    e, dev = len(sizes), a.device
    sz = torch.tensor(sizes, device=dev)
    expert = torch.repeat_interleave(torch.arange(e, device=dev), sz, output_size=a.shape[0])
    pos = torch.arange(a.shape[0], device=dev) - (torch.cumsum(sz, 0) - sz)[expert]
    slab = torch.zeros((e, max(sizes, default=0), a.shape[1]), dtype=torch.float32, device=dev)
    slab[expert, pos] = a.float()
    return slab @ w.float()


def _lane_check(torch, abft, case, lane, plain_lane, ref, mag, depth, on, off, tiles, wrong=None, **extra):
    """The three checks of a lane: its checksum within `lane_limit` of its
    plain version's lane (``tiles``: `raw_tile_sums` of the launch's raw
    products), within `tolerance()` of the operand-side reference, and the
    outputs with the lane on bitwise those with it off.  ``wrong``: the
    lane-side controls, lanes of a faulty kernel ({name: value}), each of
    which must miss the plain lane by more than the limit."""
    tol = float(abft.tolerance(mag, depth))
    limit = lane_limit(tiles, tol)
    lane_f, plain_f, ref_f = float(lane), float(plain_lane), float(ref)
    res = {"case": case, **extra, "lane": lane_f, "plain_lane": plain_f, "operand_ref": ref_f, "tolerance": tol,
           "lane_limit": limit, "lane_vs_plain_over_limit": abs(lane_f - plain_f) / limit,
           "lane_vs_ref_over_tol": abs(lane_f - ref_f) / tol,
           "outputs_bitwise_lane_off": all(torch.equal(x, y) for x, y in zip(on, off))}
    if wrong:
        res["lane_side_controls_over_limit"] = {k: abs(float(v) - plain_f) / limit for k, v in wrong.items()}
    res["ok"] = (res["lane_vs_plain_over_limit"] <= 1 and res["lane_vs_ref_over_tol"] <= 1
                 and res["outputs_bitwise_lane_off"]
                 and all(r > 1 for r in res.get("lane_side_controls_over_limit", {}).values()))
    if not res["ok"]:
        raise AssertionError(f"ABFT lane check failed: {res}")
    return res


def _dropped(plain_lane, tiles):
    """The lane-side controls: a lane of 0, and the plain lane with its
    last tile's partial left out (a kernel that skipped its last task)."""
    return {"zero": 0.0, "last_tile_dropped": float(plain_lane) - float(tiles[-1])}


def _negative_control(torch, abft, namespace, out, chk, ref_of, a, depth):
    """One input element of A flipped after the launch (`flip_exponent_bit`)
    and the reference taken from the flipped A: eager `verify` must raise
    `SdcDetected`, and under "strict" in a step scope the output must come
    back NaN and the scope count one detection."""
    ref, mag = ref_of(flip_exponent_bit(torch, a))
    try:
        abft.verify(namespace, out, chk, ref, mag, contract_dim=depth, mode="detect")
        raised = False
    except abft.SdcDetected:
        raised = True
    before = abft.runtime_sdc_total()
    with abft.step_scope() as scope:
        poisoned = abft.verify(namespace, out, chk, ref, mag, contract_dim=depth, mode="strict")
    outs = poisoned if isinstance(poisoned, tuple) else (poisoned,)
    res = {"raised_sdc_detected": raised, "strict_output_nan": all(bool(torch.isnan(x).all()) for x in outs),
           "strict_counted": abft.runtime_sdc_total() - before, "scope_detections": scope.detections}
    if not (raised and res["strict_output_nan"] and res["strict_counted"] == 1):
        raise AssertionError(f"ABFT negative control in {namespace!r} failed: {res}")
    return res


def _lane_row(kernel, gm, lane_err, ms, off_ms, ref_ms, plain_ms, bound, partials, **extra):
    """A lane's row of the kernels line: its time with the lane on and off,
    the operand-side reference's, and the bound of the launch with the
    partials it writes (4 B a task and set)."""
    flops, nbytes, peak = bound
    bound_ms, bound_by = _bound(flops, nbytes + 4.0 * partials, peak)
    return dict(kernel=kernel, gemm=gm, max_abs_err=lane_err, ms=ms, lane_off_ms=off_ms, operand_ref_ms=ref_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, partials=partials, **extra)


def phase_abft_lanes(torch, cfg, ocfg, tk, ops, abft, opt):
    """Each checksum lane against its plain version's lane and the
    operand-side reference within `tolerance()`, its outputs bitwise those
    with the lane off, at every shape of its path in bf16 and f32: K1/K2 at
    phase 2's K1/K2 shapes and its ragged case with every epilogue flag; K3
    at olmoe's decode, prefill and training shapes and on RAGGED_GROUPS; K8
    dW, single and dual, at every training shape, the LM head included;
    K8's update (bf16 stochastically rounded, f32) and norm modes at every
    layer's training shape.  In bf16 each is timed with the lane on and off
    beside the operand-side reference (`gemm_checksum_ref` /
    `tn_checksum_ref`).  Then a negative control per lane, and K8's update
    with an all-NaN gradient, whose NaN residual is no detection.  Returns
    (rows, checks, controls)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    rows, checks, controls = [], [], {}

    def r(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # K1/K2 at the main path's shapes
    for gm in main_path_gemms(cfg):
        for dt in (torch.bfloat16, torch.float32):
            lead = (gm.batch,) if gm.batch else ()
            copies = max(1, math.ceil(4 * L2_BYTES / (gm.k * gm.n * 2 * (2 if gm.glu else 1)))) \
                if dt == torch.bfloat16 else 1
            a = r(*lead, gm.m, gm.k, dtype=dt)
            ws = [r(gm.k, gm.n, dtype=dt, scale=0.02) for _ in range(copies)]
            gs = [r(gm.k, gm.n, dtype=dt, scale=0.02) for _ in range(copies)] if gm.glu else [None] * copies
            kw = dict(preact=True) if gm.preact else dict(activation=cfg.act if gm.glu else None)

            def call(i, lane):
                return tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies], abft=lane, **kw)

            on, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: call(0, True))
            layers = plain_layers(name, config)
            off = call(0, False)
            off = off if isinstance(off, tuple) else (off,)
            bm, bn, _ = ops.pick_blocks(gm.m, gm.n, gm.k)
            plain, plain_ms = _once_ms(torch, lambda: tk.sfc_gemm_fused_plain(a, ws[0], gs[0], bm=bm, bn=bn,
                                                                             k_layers=layers, abft=True, **kw))
            ref, mag = abft.gemm_checksum_ref(a, ws[0], gs[0])
            af = a.float()
            tiles = kernel_tiles(torch, name, config, *(af @ x.float() for x in (ws[0], gs[0]) if x is not None))
            del af
            checks.append(_lane_check(torch, abft, f"K1/K2:{gm.name}", on[-1], plain[-1], ref, mag, gm.k, on[:-1], off,
                                      tiles, _dropped(plain[-1], tiles) if gm.name == "decode/q" else None,
                                      dtype=str(dt), kernel=name.replace("_kernel", "_abft_kernel"), config=config))
            if dt == torch.bfloat16:
                if gm.name == "decode/q":
                    controls["K1/K2 decode/q"] = _negative_control(
                        torch, abft, "gemm", on[0], on[-1], lambda x: abft.gemm_checksum_ref(x, ws[0]), a, gm.k)
                reps = max(20, copies)
                ms = time_ms(lambda i: call(i, True), reps=reps, graph=True)
                off_ms = time_ms(lambda i: call(i, False), reps=reps, graph=True)
                ref_ms = time_ms(lambda i: abft.gemm_checksum_ref(a, ws[i % copies], gs[i % copies]), reps=reps,
                                 graph=True)
                rows.append(_lane_row("K1/K2", gm, abs(float(on[-1]) - float(plain[-1])), ms, off_ms, ref_ms,
                                      plain_ms, (gm.flops(), gm.bytes(2), PEAK_BF16_FLOPS), len(tiles),
                                      cuda_kernel=name.replace("_kernel", "_abft_kernel"), config=config))
            del a, ws, gs, on, off, plain, tiles
    # the ragged cases with every epilogue flag: K 203 in both input types
    # (the tile kernel's lane), K 264 / N 328 in bf16 (the wgmma kernel's)
    for dt, (m, k, n) in ((torch.float32, (77, 203, 133)), (torch.bfloat16, (77, 203, 133)),
                          (torch.bfloat16, (77, 264, 328))):
        args = (r(3, m, k, dtype=dt), r(k, n, dtype=dt, scale=0.1), r(k, n, dtype=dt, scale=0.1), r(n, dtype=dt),
                r(1, n, dtype=dt), r(3, m, n, dtype=dt))
        kw = dict(activation="gelu", out_scale=0.7)
        on, (name, config) = launched(tk.sfc_gemm_fused.launches_by_kernel,
                                      lambda: tk.sfc_gemm_fused(*args, abft=True, **kw))
        off = tk.sfc_gemm_fused(*args, **kw)
        plain = tk.sfc_gemm_fused_plain(*args, bm=32, bn=32, abft=True, **kw)
        ref, mag = abft.gemm_checksum_ref(args[0], args[1], args[2])
        tiles = kernel_tiles(torch, name, config, args[0].float() @ args[1].float(), args[0].float() @ args[2].float())
        wrong = {**_dropped(plain[-1], tiles), "after_epilogue": on[0].float().sum()}
        checks.append(_lane_check(torch, abft, "K1/K2:all_epilogue_flags_ragged", on[-1], plain[-1], ref, mag, k,
                                  on[:-1], (off,), tiles, wrong, dtype=str(dt), shape=[3, m, k, n],
                                  kernel=name.replace("_kernel", "_abft_kernel"), config=config))
    # K3 at olmoe's shapes, then on the ragged expert sizes
    fwd = [gm for gm in moe_grouped_gemms(ocfg) if gm.kind == "fwd"]
    d, f = fwd[0].k, fwd[0].n
    e = len(RAGGED_GROUPS)
    ragged = [GroupedGemm("ragged/glu", "fwd", "-", e, 0, d, f, glu=True),
              GroupedGemm("ragged/glu_preact", "fwd", "-", e, 0, d, f, glu=True, preact=True),
              GroupedGemm("ragged/w_out", "fwd", "-", e, 0, f, d)]
    for gm in fwd + ragged:
        sizes = (gm.rows,) * gm.experts if gm.rows else RAGGED_GROUPS
        for dt in (torch.bfloat16, torch.float32):
            args, kw, _ = _grouped_operands(torch, gm, dt, gen, rows=sizes)
            a, w, wg = args[0], args[1], args[2] if gm.glu else None

            def call(lane):
                return tk.sfc_gemm_grouped(*args, group_sizes=sizes, abft=lane, **kw)

            on, off = call(True), call(False)
            off = off if isinstance(off, tuple) else (off,)
            plain, plain_ms = _once_ms(torch, lambda: tk.sfc_gemm_grouped_plain(*args, group_sizes=sizes, bm=64, bn=64,
                                                                               abft=True, **kw))

            def ref_of(x):
                return abft.grouped_checksum_ref(x, w, wg, sizes)

            ref, mag = ref_of(a)
            tiles = raw_tile_sums(torch, *(grouped_raw(torch, a, x, sizes) for x in (w, wg) if x is not None))
            wrong = _dropped(plain[-1], tiles) if gm.name in ("decode/glu", "ragged/glu") else None
            checks.append(_lane_check(torch, abft, f"K3:{gm.name}", on[-1], plain[-1], ref, mag, gm.k, on[:-1], off,
                                      tiles, wrong, dtype=str(dt), group_sizes=list(sizes)))
            if dt == torch.bfloat16 and gm.path == "serve":
                if gm.name == "decode/glu":
                    controls["K3 decode/glu"] = _negative_control(torch, abft, "grouped_glu", on[0], on[-1], ref_of,
                                                                  a, gm.k)
                ms = time_ms(lambda i: call(True), reps=20, graph=True)
                off_ms = time_ms(lambda i: call(False), reps=20, graph=True)
                ref_ms = time_ms(lambda i: ref_of(a), reps=20, graph=True)
                tasks = gm.experts * math.ceil(gm.rows / 64) * math.ceil(gm.n / 64)
                rows.append(_lane_row("K3", gm, abs(float(on[-1]) - float(plain[-1])), ms, off_ms, ref_ms, plain_ms,
                                      (gm.flops(), gm.bytes(2), PEAK_BF16_FLOPS), tasks))
            del args, a, w, wg, on, off, plain, tiles
            torch.cuda.empty_cache()
    # K8 dW at every training shape
    for gm in [g for g in train_backward_gemms(cfg) if g.kind == "tn"]:
        for dt in (torch.bfloat16, torch.float32):
            copies = max(1, math.ceil(4 * L2_BYTES / gm.bytes(2))) if dt == torch.bfloat16 else 1
            ins = [(r(gm.m, gm.k, dtype=dt), r(gm.m, gm.n, dtype=dt), r(gm.m, gm.n, dtype=dt) if gm.dual else None)
                   for _ in range(copies)]
            x, dc, dc2 = ins[0]
            on, off = tk.sfc_gemm_tn(x, dc, dc2, abft=True), tk.sfc_gemm_tn(x, dc, dc2)
            off = off if isinstance(off, tuple) else (off,)
            plain, plain_ms = _once_ms(torch, lambda: tk.sfc_gemm_tn_plain(x, dc, dc2, bm=64, bn=64, abft=True))
            for s, d_ in enumerate((dc, dc2) if gm.dual else (dc,)):
                ref, mag = abft.tn_checksum_ref(x, d_)
                tiles = raw_tile_sums(torch, x.float().T @ d_.float())
                checks.append(_lane_check(torch, abft, f"K8 dW:{gm.name}[{s}]", on[-1][s, 0], plain[-1][s, 0], ref,
                                          mag, gm.m, on[:-1], off, tiles,
                                          _dropped(plain[-1][s, 0], tiles) if gm.name == "train/q" else None,
                                          dtype=str(dt)))
                del tiles
            if dt == torch.bfloat16:
                if gm.name == "train/q":
                    controls["K8 dW train/q"] = _negative_control(
                        torch, abft, "tn", on[0], on[-1][0, 0], lambda a_: abft.tn_checksum_ref(a_, dc), x, gm.m)
                reps = max(20, copies)
                ms = time_ms(lambda i: tk.sfc_gemm_tn(*ins[i % copies], abft=True), reps=reps, graph=True)
                off_ms = time_ms(lambda i: tk.sfc_gemm_tn(*ins[i % copies]), reps=reps, graph=True)
                ref_ms = time_ms(lambda i: [abft.tn_checksum_ref(ins[i % copies][0], d_)
                                            for d_ in ins[i % copies][1:] if d_ is not None], reps=reps, graph=True)
                sets = 2 if gm.dual else 1
                tasks = sets * math.ceil(gm.k / 64) * math.ceil(gm.n / 64)
                rows.append(_lane_row("K8 dW", gm, abs(float(on[-1][0, 0]) - float(plain[-1][0, 0])), ms, off_ms,
                                      ref_ms, plain_ms, (gm.flops(), gm.bytes(2), PEAK_BF16_FLOPS), tasks))
            del ins, x, dc, dc2, on, off, plain
            torch.cuda.empty_cache()
    # K8's update and norm modes at every layer's training shape
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device=dev),
                                 torch.tensor(0.37, device=dev))
    salt = (3 << 16) + 5

    def state(gm, dt):
        g = math.sqrt(gm.m)
        out = []
        for _ in range(gm.sets):
            mst = r(gm.k, gm.n, dtype=torch.float32, scale=0.02)
            out.append((mst, r(gm.k, gm.n, dtype=torch.float32, scale=0.5 * g),
                        r(gm.k, gm.n, dtype=torch.float32, scale=2.0 * g) ** 2 + 1.0, mst.to(dt)))
        return out

    def update(fn, x, dcs, sets, dt, **kw):
        (m1, u1, v1, w1), *rest = sets
        second = list(rest[0][:3]) if rest else [None] * 3
        return fn(x, dcs[0], dcs[1] if rest else None, m1, u1, v1, *second, hyper, w=w1,
                  w2=rest[0][3] if rest else None, salt=salt, stochastic_round=dt == torch.bfloat16, **kw)

    def clone(sets):
        return [tuple(t.clone() for t in st) for st in sets]

    for gm in [g for g in train_update_gemms(cfg) if g.name != "train/head"]:
        for dt in (torch.bfloat16, torch.float32):
            x, dcs, sets = r(gm.m, gm.k, dtype=dt), [r(gm.m, gm.n, dtype=dt) for _ in range(gm.sets)], state(gm, dt)
            on_sets, off_sets = clone(sets), clone(sets)
            norms_on, chk = update(tk.sfc_gemm_tn, x, dcs, on_sets, dt, abft=True)
            norms_off = update(tk.sfc_gemm_tn, x, dcs, off_sets, dt)
            (_, plain_chk), plain_ms = _once_ms(torch, lambda: update(tk.sfc_gemm_tn_plain, x, dcs, clone(sets), dt,
                                                                      bm=64, bn=64, abft=True))
            nnorm_on, nchk = tk.sfc_gemm_tn(x, *dcs, norm=True, abft=True)
            nnorm_off = tk.sfc_gemm_tn(x, *dcs, norm=True)
            on_all = [norms_on, *(t for st in on_sets for t in st)]
            off_all = [norms_off, *(t for st in off_sets for t in st)]
            for s, d_ in enumerate(dcs):
                ref, mag = abft.tn_checksum_ref(x, d_)
                tiles = raw_tile_sums(torch, x.float().T @ d_.float())
                wrong = _dropped(plain_chk[s, 0], tiles) if gm.name == "train/q" else None
                checks.append(_lane_check(torch, abft, f"K8 update:{gm.name}[{s}]", chk[s, 0], plain_chk[s, 0], ref,
                                          mag, gm.m, on_all, off_all, tiles, wrong, dtype=str(dt),
                                          stochastic_round=dt == torch.bfloat16))
                checks.append(_lane_check(torch, abft, f"K8 norm:{gm.name}[{s}]", nchk[s, 0], plain_chk[s, 0], ref,
                                          mag, gm.m, [nnorm_on], [nnorm_off], tiles, wrong, dtype=str(dt)))
                del tiles
            if dt == torch.bfloat16:
                if gm.name == "train/q":
                    controls["K8 update train/q"] = _negative_control(
                        torch, abft, "tn_update", norms_on, chk[0, 0], lambda a_: abft.tn_checksum_ref(a_, dcs[0]),
                        x, gm.m)
                    # an all-NaN gradient: a NaN residual, which is no detection
                    nan_dc = torch.full_like(dcs[0], float("nan"))
                    _, nan_chk = update(tk.sfc_gemm_tn, x, [nan_dc], clone(sets), dt, abft=True)
                    nan_ref, nan_mag = abft.tn_checksum_ref(x, nan_dc)
                    before = abft.runtime_sdc_total()
                    abft.verify("tn_update", norms_on, nan_chk[0, 0], nan_ref, nan_mag, contract_dim=gm.m,
                                mode="detect")  # eager: raises on a detection
                    with abft.step_scope() as scope:
                        abft.verify("tn_update", norms_on, nan_chk[0, 0], nan_ref, nan_mag, contract_dim=gm.m,
                                    mode="strict")
                    controls["K8 update, all-NaN gradient"] = {
                        "lane_is_nan": bool(torch.isnan(nan_chk).all()), "detections": scope.detections,
                        "counted": abft.runtime_sdc_total() - before}
                    if not controls["K8 update, all-NaN gradient"]["lane_is_nan"] or scope.detections:
                        raise AssertionError(f"the NaN step's lane: {controls['K8 update, all-NaN gradient']}")
                ms = time_ms(lambda i: update(tk.sfc_gemm_tn, x, dcs, on_sets, dt, abft=True), reps=20, graph=True)
                off_ms = time_ms(lambda i: update(tk.sfc_gemm_tn, x, dcs, off_sets, dt), reps=20, graph=True)
                ref_ms = time_ms(lambda i: [abft.tn_checksum_ref(x, d_) for d_ in dcs], reps=20, graph=True)
                nms = time_ms(lambda i: tk.sfc_gemm_tn(x, *dcs, norm=True, abft=True), reps=20, graph=True)
                noff_ms = time_ms(lambda i: tk.sfc_gemm_tn(x, *dcs, norm=True), reps=20, graph=True)
                tasks = gm.sets * math.ceil(gm.k / 64) * math.ceil(gm.n / 64)
                err = abs(float(chk[0, 0]) - float(plain_chk[0, 0]))
                for mode, t_on, t_off in (("update", ms, off_ms), ("norm", nms, noff_ms)):
                    g2 = dataclasses.replace(gm, mode=mode)
                    rows.append(_lane_row(f"K8 {mode}", g2, err, t_on, t_off, ref_ms, plain_ms,
                                          (g2.flops(), g2.bytes(2), PEAK_BF16_FLOPS), tasks))
            del x, dcs, sets, on_sets, off_sets
            torch.cuda.empty_cache()
    return rows, checks, controls


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
    from repro_torch.robust import abft
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.train.step import BackendConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device ---------------------------------------------------------
    run_t0 = time.perf_counter()
    phase_at = {}
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
    phase_at[2] = time.perf_counter() - run_t0
    cfg = get_config("qwen3_4b")
    gemms = main_path_gemms(cfg)
    rows, checks = phase_kernels(torch, cfg, gemms, tk, ops)
    rep_rows, rep_checks = phase_replicated(torch, cfg, replicated_gemms(cfg), tk, ops)
    phase_at["2, after the replicated form's rows"] = time.perf_counter() - run_t0
    attn_rows, attn_checks = phase_attention(torch, attention_cases(cfg), tsa, tfa, build)
    bwd_rows, bwd_checks = phase_backward_gemms(torch, train_backward_gemms(cfg), tk, ops)
    upd_rows, upd_checks = phase_update_gemms(torch, cfg, tk, opt)
    attn_bwd_rows, attn_bwd_checks = phase_attention_bwd(torch, attention_bwd_cases(cfg), tsa, build)
    ocfg = get_config(MOE_ARCH)
    grouped_rows, grouped_checks = phase_grouped_gemms(torch, moe_grouped_gemms(ocfg), tk)
    grouped_upd_rows, grouped_upd_checks = phase_grouped_update_gemms(torch, ocfg, tk, opt)
    phase_at["2, the ABFT lanes"] = time.perf_counter() - run_t0
    lane_rows, lane_checks, lane_controls = phase_abft_lanes(torch, cfg, ocfg, tk, ops, abft, opt)
    small = small_reference_check(torch, get_config, build_model, gemm_backend)
    emit({"phase": "kernels_vs_plain", "ok": True, "tolerance": {
        "float32": f"|k-p| <= {F32_RTOL}|p| + {F32_ATOL_REL} max|p|",
        "bfloat16": f"|k-p| <= 2^-7 |p| + {BF16_ATOL_REL} max|p|",
        "lse": "float32 tolerance"},
        "tn_update": "master, mu, nu and the norms at the float32 tolerance; a bf16 W bitwise the stochastic "
                     "rounding of the kernel's master with the plain version's bits and within the bfloat16 "
                     "tolerance of the plain W",
        "checks": checks + rep_checks + attn_checks + bwd_checks + upd_checks + attn_bwd_checks + grouped_checks
                  + grouped_upd_checks,
        "reduced_model_f32_vs_reference": small})
    emit({"phase": "abft_lanes", "ok": True,
          "tolerance": f"|lane - plain lane| <= min({LANE_RTOL} * sum |{LANE_TILE}x{LANE_TILE} raw tile sums|, "
                       "robust.abft.tolerance(mag, depth)), and each lane-side control (a lane of 0, the plain lane "
                       "less its last tile, the ragged case's sum after the epilogue) beyond it; "
                       "|lane - operand reference| <= robust.abft.tolerance(mag, depth); "
                       "the outputs with the lane on bitwise those with it off",
          "max_lane_vs_plain_over_limit": max(c["lane_vs_plain_over_limit"] for c in lane_checks),
          "min_lane_side_control_over_limit": min(r for c in lane_checks
                                                  for r in c.get("lane_side_controls_over_limit", {}).values()),
          "max_lane_vs_ref_over_tol": max(c["lane_vs_ref_over_tol"] for c in lane_checks),
          "checks": lane_checks, "negative_controls": lane_controls})
    torch.cuda.empty_cache()

    # ---- 3. gradients of a 4-layer full-width model in f32 -----------------
    phase_at[3] = time.perf_counter() - run_t0
    data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=1))
    gc_batch = {key: torch.from_numpy(val).cuda() for key, val in data.batch(0).items()}
    emit({"phase": "grad_check", "ok": True,
          **phase_grad_check(torch, cfg, build_model, gemm_backend, attention_backend, gc_batch)})
    torch.cuda.empty_cache()
    fc_batches = [{key: torch.from_numpy(val).cuda() for key, val in data.batch(i).items()} for i in range(3)]
    emit({"phase": "fused_step_check", "ok": True,
          **phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, fc_batches)})
    gc.collect()
    emit({"phase": "fused_step_check_abft", "ok": True,
          **phase_fused_step_check(torch, cfg, build_model, tk, make_train_step, BackendConfig, opt, fc_batches,
                                   abft="detect")})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. serve full-width qwen3-4b --------------------------------------
    phase_at[4] = time.perf_counter() - run_t0
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
                "torch": ("torch", "blockwise"), "sfc_cuda+flash_attn": ("sfc_cuda", "flash_pallas"),
                "replicated": ("replicated", "blockwise")}
    served = ("sfc_cuda", "sfc_cuda+sfc_attn", "replicated", "torch")

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

    # K1/K2 by kernel: the prefill's 6 a layer (4 x 128 rows) on the wgmma
    # kernel, the rest (4 rows: the decode steps, the prefill's head) on the
    # cluster kernel, none on the tile kernel
    want_by_kernel = {"sfc_gemm_wgmma_kernel": cfg.n_layers * 6,
                      "sfc_gemm_cluster_kernel": want_launches - cfg.n_layers * 6}

    def reset_counts():
        for fn in (tk.sfc_gemm_fused, tk.sfc_gemm_replicated, tk.add_reduce):
            fn.launches = 0
            fn.launches_by_shape.clear()
        tk.sfc_gemm_fused.launches_by_kernel.clear()
        tsa.sfc_decode_attention.launches_by_splits.clear()
        for fn in attn_kernels.values():
            fn.launches = 0

    def replicated_counts():
        by_shape = tk.sfc_gemm_replicated.launches_by_shape
        return {"K5": sum(c for key, c in by_shape.items() if key[0]), "K4": sum(c for key, c in by_shape.items()
                                                                            if not key[0]),
                "K6": tk.add_reduce.launches, "K1/K2": tk.sfc_gemm_fused.launches}

    # the blockwise path: every projection on the GEMM kernel
    reset_counts()
    done = {"sfc_cuda": engines["sfc_cuda"].run(engines["sfc_cuda"].submit_many(prompts, max_new_tokens=NEW_TOKENS))}
    torch.cuda.synchronize()
    launches = tk.sfc_gemm_fused.launches
    by_shape = dict(tk.sfc_gemm_fused.launches_by_shape)
    serve_by_kernel = {"sfc_cuda": by_kernel(tk.sfc_gemm_fused.launches_by_kernel)}
    if launches != want_launches or serve_by_kernel["sfc_cuda"] != want_by_kernel:
        raise AssertionError(f"sfc_cuda serve launched the kernel {launches} times, expected {want_launches}; "
                             f"by kernel {serve_by_kernel['sfc_cuda']}, expected {want_by_kernel}")
    # the attn_impl="sfc" path: projections on the GEMM, attention on K11 / K14
    reset_counts()
    eng = engines["sfc_cuda+sfc_attn"]
    done["sfc_cuda+sfc_attn"] = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    attn_launches = {name: fn.launches for name, fn in attn_kernels.items()}
    attn_gemm_launches = tk.sfc_gemm_fused.launches
    attn_by_kernel = {"sfc_gemm_fused": {f"{name}@{config}": n for (name, config), n in
                                         tk.sfc_gemm_fused.launches_by_kernel.items()},
                      "sfc_decode_attention": {f"S{k}": n for k, n in
                                               tsa.sfc_decode_attention.launches_by_splits.items()}}
    serve_by_kernel["sfc_cuda+sfc_attn"] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
    if (attn_gemm_launches != want_launches or any(attn_launches[k] != n for k, n in want_attn.items())
            or serve_by_kernel["sfc_cuda+sfc_attn"] != want_by_kernel):
        raise AssertionError(f"attn_impl='sfc' serve launched GEMM {attn_gemm_launches} (want {want_launches}; "
                             f"by kernel {serve_by_kernel['sfc_cuda+sfc_attn']}, want {want_by_kernel}) "
                             f"and attention {attn_launches} (want {want_attn}) times")
    # the replicated form: every projection a K5 (prefill) or K4 (decode)
    # launch, the GLU two; k_layers resolves to 1 at every shape, so no K6
    # and no K1/K2.  Then the same serve with every product split over
    # REP_SERVE_LAYERS K layers: as many K4/K5 launches, one K6 after each.
    per_layer = 7  # q, k, v, o, the GLU's two products, w_out
    want_rep = {"K5": cfg.n_layers * per_layer, "K4": cfg.n_layers * per_layer * (NEW_TOKENS - 1) + NEW_TOKENS,
                "K6": 0, "K1/K2": 0}
    want_split = dict(want_rep, K6=want_rep["K5"] + want_rep["K4"])
    eng = engines["replicated"]
    rep_counts, rep_by_shape = {}, {}
    for name, layers, want in (("replicated", None, want_rep), (f"replicated@k{REP_SERVE_LAYERS}", REP_SERVE_LAYERS,
                                                                  want_split)):
        with ops.knob_defaults(k_layers=layers):
            eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))  # warm-up: this split's task tables
            torch.cuda.synchronize()
            reset_counts()
            done[name] = eng.run(eng.submit_many(prompts, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
        rep_counts[name] = replicated_counts()
        rep_by_shape[name] = (dict(tk.sfc_gemm_replicated.launches_by_shape), dict(tk.add_reduce.launches_by_shape))
        if rep_counts[name] != want:
            raise AssertionError(f"{name} serve launched {rep_counts[name]}, expected {want}")
    # the attn_impl="sfc" serve again under ABFT "detect": the prefill in
    # abft_mode (eager checks), every decode step verified in a step scope
    # (verify_every=1); a warm-up engine, then a fresh one (its ledger at 0)
    for prompts_, new in ((prompts[:1], 2), (prompts, NEW_TOKENS)):
        abft_eng = ServingEngine(dataclasses.replace(cfg, attn_impl="sfc"), params, max_batch=BATCH,
                                 max_seq=PROMPT + NEW_TOKENS + 1, gemm_backend="sfc_cuda", device="cuda",
                                 verify_every=1)
        torch.cuda.synchronize()
        reset_counts()
        tk.sfc_gemm_fused.abft_launches = 0
        abft.reset_runtime_sdc()
        with abft.abft_mode("detect"):
            done_abft = abft_eng.run(abft_eng.submit_many(prompts_, max_new_tokens=new))
        torch.cuda.synchronize()
    abft_by_shape = dict(tk.sfc_gemm_fused.launches_by_shape)
    serve_by_kernel["sfc_cuda+sfc_attn+abft"] = by_kernel(tk.sfc_gemm_fused.launches_by_kernel)
    abft_serve = {
        "verify": abft_eng.degradation_report()["verify"], "sdc_detections": abft.runtime_sdc_total(),
        "checks": abft.runtime_check_total(), "max_residual_over_tol": abft.runtime_max_ratio(),
        "launches": {"sfc_gemm_fused": tk.sfc_gemm_fused.launches, "with_lane": tk.sfc_gemm_fused.abft_launches,
                     **{k: attn_kernels[k].launches for k in want_attn}},
        "tokens_identical_to_off": [r.output for r in done_abft] == [r.output for r in done["sfc_cuda+sfc_attn"]],
        "latency": abft_eng.latency_report(done_abft),
    }
    del abft_eng
    # one serve step (the prefill and one decode step) on "replicated" split
    # over REP_SERVE_LAYERS K layers under "detect": the op-level checks of
    # K4 / K5 + K6 (eager; a detection raises)
    eng = engines["replicated"]
    reset_counts()
    abft.reset_runtime_sdc()
    with ops.knob_defaults(k_layers=REP_SERVE_LAYERS), abft.abft_mode("detect"):
        rep_abft = eng.run(eng.submit_many(prompts, max_new_tokens=2))
    torch.cuda.synchronize()
    abft_serve[f"replicated@k{REP_SERVE_LAYERS}_one_decode_step"] = {
        "checks": abft.runtime_check_total(), "max_residual_over_tol": abft.runtime_max_ratio(),
        "launches": replicated_counts(),
        "tokens_identical_to_off": [r.output for r in rep_abft] == [r.output[:2] for r in
                                                                      done[f"replicated@k{REP_SERVE_LAYERS}"]]}
    done["torch"] = engines["torch"].run(engines["torch"].submit_many(prompts, max_new_tokens=NEW_TOKENS))
    reports = {name: engines[name.split("@")[0]].latency_report(batch) for name, batch in done.items()}
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
    split = f"replicated@k{REP_SERVE_LAYERS}"
    decode_profile = {name: profile_decode(torch, engines[name.split("@")[0]], tokens, ops, layers)
                      for name, layers in (("sfc_cuda", None), ("replicated", None), (split, REP_SERVE_LAYERS),
                                           ("torch", None))}
    logits = {name: eng._prefill(tokens)[0].float() for name, eng in engines.items()}
    with ops.knob_defaults(k_layers=REP_SERVE_LAYERS):
        logits[split] = engines["replicated"]._prefill(tokens)[0].float()
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
    for name in ("torch", "sfc_cuda", "sfc_cuda+sfc_attn", "sfc_cuda+flash_attn", "replicated"):
        logits[name + "_f32"] = engine(name, cfg32)._prefill(tokens)[0]
    with ops.knob_defaults(k_layers=REP_SERVE_LAYERS):
        logits[split + "_f32"] = engine("replicated", cfg32)._prefill(tokens)[0]
    del params_of["float32"]
    torch.cuda.synchronize()
    sfc_variants = ("sfc_cuda", "sfc_cuda+sfc_attn", "sfc_cuda+flash_attn", "replicated", split)
    for name in sfc_variants:
        if tuple(logits[name].shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(logits[name]).all()):
            raise AssertionError(f"{name} prefill logits shape {tuple(logits[name].shape)} or non-finite values")
    ref = logits["torch_f32"]
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
        "attn_impl_sfc_launches_by_kernel": attn_by_kernel,
        "sfc_gemm_fused_launches_by_kernel": serve_by_kernel, "by_kernel_expected": want_by_kernel,
        "flash_pallas_prefill_launches": attn_launches["flash_attention"],
        "replicated_launches": rep_counts, "replicated_launches_expected": {"replicated": want_rep,
                                                                           split: want_split},
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
                               for name in ("sfc_cuda", "sfc_cuda+sfc_attn", "replicated", split)},
        "greedy_token_match_sfc_attn_vs_sfc_cuda":
            float((tokens_of["sfc_cuda+sfc_attn"] == tokens_of["sfc_cuda"]).mean()),
        "latency": reports,
        "decode_step_profile": decode_profile,
        "abft_detect": abft_serve,
    }
    emit(serve)
    for name, res in f32_agree.items():
        if not res["ok"]:
            raise AssertionError(f"f32 prefill logits {name} vs torch: max err {res['max_abs_err']}, "
                                 f"err/bound {res['err_over_bound']}")
    # the split serve's bf16 copies are rounded once per K layer before the
    # sum (the JAX package's replicated result): its parity is reported,
    # not held; its f32 logits are held above like every variant's
    if not all(ok for name, ok in parity.items() if name != split):
        raise AssertionError(f"bf16 logits further from the f32 model than torch's: {noise}")
    rep_step = abft_serve[f"replicated@k{REP_SERVE_LAYERS}_one_decode_step"]
    if (abft_serve["sdc_detections"] or abft_serve["checks"] != want_launches or not abft_serve["tokens_identical_to_off"]
            or abft_serve["launches"] != {"sfc_gemm_fused": want_launches, "with_lane": want_launches, **want_attn}
            or abft_serve["verify"] != {"verify_every": 1, "decode_steps": NEW_TOKENS - 1,
                                        "verified_steps": NEW_TOKENS - 1, "sdc_detections": 0}
            or serve_by_kernel["sfc_cuda+sfc_attn+abft"] != want_by_kernel
            or not abft_serve["max_residual_over_tol"] < 1 or not rep_step["tokens_identical_to_off"]
            or not rep_step["max_residual_over_tol"] < 1 or not rep_step["checks"]):
        raise AssertionError(f"the serve under ABFT detect: {abft_serve}")
    # the serve's model and every tensor of it leave the card before training
    del model, params, params_of, logits, ref
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5. train full-width qwen3-4b --------------------------------------
    phase_at[5] = time.perf_counter() - run_t0
    counted = {"sfc_gemm_fused": tk.sfc_gemm_fused, "sfc_gemm_nt": tk.sfc_gemm_nt, "sfc_gemm_tn": tk.sfc_gemm_tn,
               "sfc_flash_fwd": tsa.sfc_flash_fwd, "sfc_flash_bwd_dq": tsa.sfc_flash_bwd_dq,
               "sfc_flash_bwd_dkv": tsa.sfc_flash_bwd_dkv}
    _, counts_by_run = phase_train(torch, cfg, build_trainer, counted)
    train_counts, fused_counts = counts_by_run["sfc_cuda+sfc_attn"], counts_by_run["sfc_cuda+sfc_attn+fused_optimizer"]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. olmoe-1b-7b: f32 gradients of a 2-layer full-width cut ---------
    phase_at[6] = time.perf_counter() - run_t0
    odata = SyntheticLM(SyntheticLMConfig(vocab=ocfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=1))
    ogc_batch = {key: torch.from_numpy(val).cuda() for key, val in odata.batch(0).items()}
    emit({"phase": "grad_check_moe", "ok": True,
          **phase_grad_check(torch, ocfg, build_model, gemm_backend, attention_backend, ogc_batch,
                             layers=MOE_CHECK_LAYERS)})
    gc.collect()
    torch.cuda.empty_cache()
    ofc_batches = [{key: torch.from_numpy(val).cuda() for key, val in odata.batch(i).items()} for i in range(3)]
    emit({"phase": "fused_step_check_moe", "ok": True,
          **phase_fused_step_check(torch, ocfg, build_model, tk, make_train_step, BackendConfig, opt, ofc_batches,
                                   layers=MOE_CHECK_LAYERS)})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. serve full-width, full-depth olmoe-1b-7b ------------------------
    phase_at[7] = time.perf_counter() - run_t0
    _, moe_serve_counts, moe_abft_counts = phase_moe_serve(torch, np, ocfg, build_model, ServingEngine, tk, tsa)

    # ---- 8. train olmoe-1b-7b at full width, 8 layers ----------------------
    phase_at[8] = time.perf_counter() - run_t0
    moe_counted = {**counted, "sfc_gemm_grouped": tk.sfc_gemm_grouped, "sfc_gemm_grouped_nt": tk.sfc_gemm_grouped_nt,
                   "sfc_gemm_grouped_tn": tk.sfc_gemm_grouped_tn}
    _, moe_train_counts = phase_moe_train(torch, ocfg, build_trainer, moe_counted)
    moe_fused_counts = moe_train_counts["sfc_cuda+sfc_attn+fused_optimizer"]["sfc_gemm_grouped_tn"]

    # ---- 9. the kernels line ------------------------------------------------
    phase_at[9] = time.perf_counter() - run_t0
    kernels = []
    for row in rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_fused:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": (train_counts["sfc_gemm_fused"] if gm.path == "train" else by_shape).get(gm.key, 0),
            "path": gm.path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            # the CUDA kernel the wrapper launched at this shape, and its
            # configuration: the cluster kernel's K layers, the wgmma kernel's C tile
            "kernel": row["kernel"],
            "config": row["config"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "glu": gm.glu, "preact": gm.preact},
        })
    # the replicated form: launches of each kernel in its serve (K4/K5 in
    # the k_layers-1 serve, K6 in the split one), and at the row's shape in
    # the serve whose split it has
    rep_serves = {1: "replicated", REP_SERVE_LAYERS: split}
    for row in rep_rows:
        gm = row["gemm"]
        k6 = row["kernel"] == "K6"
        serve_name = split if k6 else "replicated"
        at_shape = rep_by_shape[rep_serves[gm.layers]][int(k6)] if gm.layers in rep_serves else {}
        kernels.append({
            "name": f"{'add_reduce' if k6 else 'sfc_gemm_replicated'}:{gm.name}@L{gm.layers}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu",
            "replaces": ("src/repro/kernels/sfc_gemm.py:2040" if k6 else
                         "src/repro/kernels/sfc_gemm.py:772" if gm.batch else "src/repro/kernels/sfc_gemm.py:656"),
            "launches": rep_counts[serve_name][row["kernel"] if k6 else gm.kernel],
            "launches_at_shape": at_shape.get(gm.reduce_key if k6 else gm.key, 0),
            "path": f"serve {serve_name}",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": ("copies.float().sum(-3).to(dtype)" if k6 else
                        None if row["library_ms"] is None else "torch.matmul over the K slabs"),
            **({} if k6 else {"unfused_call_ms": row["together_ms"], "fused_k1_k2_ms": row["fused_ms"],
                              "torch_matmul_ms": row["matmul_ms"]}),
            "shape": gm.shape(),
        })
    for row in bwd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_{gm.kind}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row["kernel"]),
            "replaces": "src/repro/kernels/sfc_gemm.py:1219" if gm.kind == "nt" else "src/repro/kernels/sfc_gemm.py:1429",
            "launches": train_counts[f"sfc_gemm_{gm.kind}"].get(gm.key, 0),
            "path": "train",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel": row["kernel"],
            "config": row["config"],
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
    # the checksum lanes: launches in the run of their path under ABFT
    # "detect" (the qwen3-4b serve with verify_every=1, its unfused and
    # fused training runs, the olmoe serve), at the row's shape
    abft_train, abft_fused = counts_by_run["sfc_cuda+sfc_attn+abft"], counts_by_run[
        "sfc_cuda+sfc_attn+fused_optimizer+abft"]
    lanes = {"K1/K2": ("sfc_gemm_fused_abft_kernel", "src/repro/kernels/sfc_gemm.py:246"),
             "K3": ("sfc_gemm_grouped_abft_kernel", "src/repro/kernels/sfc_gemm.py:1003"),
             "K8 dW": ("tn_abft_kernel", "src/repro/kernels/sfc_gemm.py:1388"),
             "K8 update": ("tn_update_abft_kernel", "src/repro/kernels/sfc_gemm.py:1388"),
             "K8 norm": ("tn_update_abft_kernel", "src/repro/kernels/sfc_gemm.py:1388")}
    for row in lane_rows:
        gm, lane = row["gemm"], row["kernel"]
        if lane == "K1/K2":
            path = "train, abft detect" if gm.path == "train" else "serve, abft detect, verify_every=1"
            count = (abft_train["sfc_gemm_fused"] if gm.path == "train" else abft_by_shape).get(gm.key, 0)
        elif lane == "K3":
            path, count = "olmoe serve, abft detect, verify_every=1", moe_abft_counts.get(gm.key, 0)
        elif lane == "K8 dW":
            path, count = "train, abft detect", abft_train["sfc_gemm_tn"].get(gm.key, 0)
        else:
            path, count = "train, fused optimizer, abft detect", abft_fused["sfc_gemm_tn"].get(gm.key, 0)
        kernels.append({
            "name": f"{row.get('cuda_kernel', lanes[lane][0])}:{lane}:{gm.name}",
            "route": "cuda",
            "source": kernel_source(row.get("cuda_kernel", "")),
            "replaces": lanes[lane][1],
            "launches": count,
            "path": path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "lane_off_ms": row["lane_off_ms"],
            "operand_ref_ms": row["operand_ref_ms"],
            "partials": row["partials"],
            **({"config": row["config"]} if "config" in row else {}),
            "shape": dataclasses.asdict(gm),
        })
    replaces = {"sfc_flash_fwd": "src/repro/kernels/sfc_attention.py:204",
                "flash_attention": "src/repro/kernels/flash_attention.py:107",
                "sfc_decode_attention": "src/repro/kernels/sfc_attention.py:660",
                "sfc_flash_bwd_dq": "src/repro/kernels/sfc_attention.py:428",
                "sfc_flash_bwd_dkv": "src/repro/kernels/sfc_attention.py:509"}
    for row in attn_bwd_rows:
        c = row["case"]
        count = train_counts["totals"][row["kernel"]]
        kernels.append({
            "name": f"{row['kernel']}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[row["kernel"]],
            "kernel": row["cuda_kernel"],
            "config": row["config"],
            "launches": count,
            "launches_at_shape": count if c.main_path else 0,
            "path": "train",
            "main_path": c.main_path,
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
            **({"kernel": "decode_split_kernel", "splits": row["splits"]} if c.decode else {}),
            "shape": c.shape(),
        })
    for row in grouped_rows:
        gm = row["gemm"]
        counts = moe_serve_counts if gm.path == "serve" else moe_train_counts["sfc_cuda+sfc_attn"][gm.kernel]
        kernels.append({
            "name": f"{gm.kernel}:{gm.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu",
            "replaces": gm.replaces,
            "launches": counts.get(gm.key, 0),
            "path": f"olmoe {gm.path}",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.bmm over the (E, rows, .) views (dual forms on concatenated operands)",
            "shape": gm.shape(),
        })
    for row in grouped_upd_rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_grouped_tn_{gm.mode}:{gm.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu",
            "replaces": "src/repro/kernels/sfc_gemm.py:1859",
            "launches": moe_fused_counts.get(gm.key, 0),
            "path": "olmoe train, fused optimizer",
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library": "torch.bmm per set to an f32 dW stack + torch._fused_adamw_" if gm.mode == "update" else None,
            "shape": {"experts": gm.experts, "rows_per_expert": gm.rows, "k": gm.k, "n": gm.n, "dual": gm.glu,
                      "dtype": "bfloat16", "stochastic_round": gm.mode == "update"},
        })
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"main-path kernels never launched in the run of their path: {missing}")
    # seconds since phase 1 began at the start of each later phase, and
    # the whole run's (the build included)
    emit({"phase": "clock", "phase_start_s": phase_at, "total_s": time.perf_counter() - run_t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
