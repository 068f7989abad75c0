#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout (src/repro_torch/kernels/csrc: the fused GEMM and the attention
library, all parts compiled at once), then runs four phases, each printing
one JSON line and raising on failure:

1. device   the card's name and power limit (nvidia-smi) and the build time;
2. kernels  each kernel against its plain PyTorch version at the shapes the
            qwen3-4b server runs, timed beside its bound and one PyTorch
            call of the same function: the SFC fused GEMM at every GEMM
            shape (decode M=4, batched prefill 4 x 128, the LM head) and one
            ragged case with every epilogue flag; the band flash forward
            (K11) at the prefill shape and at 1 x 2000 with q_offset 0 and
            48; the dense flash forward (K15) at the prefill shape; the
            decode attention (K14) at the serve's cache (145 rows, live
            129..144) and at a 4096-row cache with live lengths 1..4096;
3. serve    ServingEngine serves full-width qwen3-4b (36 layers, bf16,
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
4. the {"kernels": [...]} line: per kernel and shape, launches in the
            phase-3 run of its path, max error, kernel / plain / library
            times and the bound.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository's src/repro_torch beside this file, it exits non-zero
and prints no result.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
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


def time_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of fn(i) over reps calls, by CUDA events.  With
    ``graph`` the reps calls are captured once in a CUDA graph and one
    replay is timed, so the host's per-call cost (Python, argument checks)
    does not leave the card idle between short kernels."""
    import torch

    for i in range(warmup):
        fn(i)
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
    mode: str  # "decode" (plain kernel mode) | "prefill" (batched mode)
    batch: int  # 0 = plain mode
    m: int
    k: int
    n: int
    glu: bool = False

    @property
    def key(self):
        return (self.batch, self.m, self.k, self.n, self.glu)

    @property
    def rows(self) -> int:
        return max(self.batch, 1) * self.m

    def flops(self) -> float:
        return 2.0 * self.rows * self.k * self.n * (2 if self.glu else 1)

    def bytes(self, elem: int) -> float:
        return elem * (self.rows * self.k + self.k * self.n * (2 if self.glu else 1) + self.rows * self.n)

    def bound(self, elem: int, peak_flops: float):
        t_ops, t_bytes = self.flops() / peak_flops, self.bytes(elem) / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def main_path_gemms(cfg):
    """Every distinct GEMM the server launches for this config: the decode
    step's (M = batch rows, flattened) and the batched prefill's, plus the
    LM head on the last position (plain mode in both phases)."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim_
    kv = cfg.kv_heads * cfg.head_dim_
    proj = [("q", d, q, False), ("k,v", d, kv, False), ("o", q, d, False),
            ("mlp_glu", d, cfg.d_ff, True), ("mlp_out", cfg.d_ff, d, False)]
    out = [Gemm(f"decode/{n}", "decode", 0, BATCH, k, nn, g) for n, k, nn, g in proj]
    out.append(Gemm("head", "decode", 0, BATCH, d, cfg.vocab))
    out += [Gemm(f"prefill/{n}", "prefill", BATCH, PROMPT, k, nn, g) for n, k, nn, g in proj]
    return out


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
        t_ops, t_bytes = 4.0 * self.d * self.pairs() / PEAK_BF16_FLOPS, self.bytes(elem) / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

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
        act = cfg.act if gm.glu else None

        def kernel(i):
            return tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies] if gs else None, activation=act)

        bm, bn, _ = ops.pick_blocks(gm.m, gm.n, gm.k)

        def plain(i):
            return tk.sfc_gemm_fused_plain(a, ws[i % copies], gs[i % copies] if gs else None,
                                           activation=act, bm=bm, bn=bn)

        got = kernel(0)
        torch.cuda.synchronize()
        ok, err, worst = within(got, plain(0), dt)
        checks.append({"case": gm.name, "shape": [gm.batch, gm.m, gm.k, gm.n], "glu": gm.glu,
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
    from repro_torch.core.gemm_backend import gemm_backend
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

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
    small = small_reference_check(torch, get_config, build_model, gemm_backend)
    emit({"phase": "kernels_vs_plain", "ok": True, "tolerance": {
        "float32": f"|k-p| <= {F32_RTOL}|p| + {F32_ATOL_REL} max|p|",
        "bfloat16": f"|k-p| <= 2^-7 |p| + {BF16_ATOL_REL} max|p|",
        "lse": "float32 tolerance"},
        "checks": checks + attn_checks, "reduced_model_f32_vs_reference": small})
    torch.cuda.empty_cache()

    # ---- 3. serve full-width qwen3-4b --------------------------------------
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

    # ---- 4. the kernels line ------------------------------------------------
    kernels = []
    for row in rows:
        gm = row["gemm"]
        kernels.append({
            "name": f"sfc_gemm_fused:{gm.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_gemm_fused.cu",
            "replaces": "src/repro/kernels/sfc_gemm.py:491" if gm.batch else "src/repro/kernels/sfc_gemm.py:355",
            "launches": by_shape.get(gm.key, 0),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {"batch": gm.batch, "m": gm.m, "k": gm.k, "n": gm.n, "glu": gm.glu},
        })
    replaces = {"sfc_flash_fwd": "src/repro/kernels/sfc_attention.py:204",
                "flash_attention": "src/repro/kernels/flash_attention.py:107",
                "sfc_decode_attention": "src/repro/kernels/sfc_attention.py:660"}
    for row in attn_rows:
        c = row["case"]
        # every launch of a path's run is at its main-path shape; a check row
        # at another shape carries its kernel's count from that run
        kernels.append({
            "name": f"{c.kernel}:{c.name}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sfc_attention.cu",
            "replaces": replaces[c.kernel],
            "launches": attn_launches[c.kernel],
            "launches_at_shape": attn_launches[c.kernel] if c.main_path else 0,
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
        raise AssertionError(f"main-path kernels never launched during serve: {missing}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
