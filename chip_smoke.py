#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernel from the sources in this checkout
(src/repro_torch/kernels/csrc), then runs four phases, each printing one
JSON line and raising on failure:

1. device   the card's name and power limit (nvidia-smi) and the build time;
2. kernels  the SFC fused-GEMM kernel against its plain PyTorch version at
            every GEMM shape the qwen3-4b server runs (decode M=4, batched
            prefill 4 x 128, the LM head) and one ragged case with every
            epilogue flag, each timed beside torch.matmul and its bound;
3. serve    ServingEngine serves full-width qwen3-4b (36 layers, bf16,
            random weights from a seeded torch.Generator) on the sfc_cuda
            backend: 4 requests, prompt 128, 16 new tokens.  The kernel's
            launch count over that run must be exactly 217 x 16.  The
            prefill logits of the same weights in f32 must agree with the
            torch backend's within the bf16 bound, and the bf16 logits must
            be as close to that f32 model as the torch backend's are;
4. the {"kernels": [...]} line: per main-path shape, launches in phase 3,
            max error, kernel / plain / torch.matmul times and the bound.

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


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn(i) over reps calls, by CUDA events."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
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
        ms = time_ms(kernel, reps=max(20, copies))
        lib_ms = time_ms(library, reps=max(20, copies))
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
    build.load_library()  # nvcc at first use: a fresh checkout has no build/
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_and_load_s": time.perf_counter() - t0})

    # ---- 2. kernel against its plain version -------------------------------
    cfg = get_config("qwen3_4b")
    gemms = main_path_gemms(cfg)
    rows, checks = phase_kernels(torch, cfg, gemms, tk, ops)
    small = small_reference_check(torch, get_config, build_model, gemm_backend)
    emit({"phase": "kernels_vs_plain", "ok": True, "tolerance": {
        "float32": f"|k-p| <= {F32_RTOL}|p| + {F32_ATOL_REL} max|p|",
        "bfloat16": f"|k-p| <= 2^-7 |p| + {BF16_ATOL_REL} max|p|"},
        "checks": checks, "reduced_model_f32_vs_reference": small})
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
    engines = {
        backend: ServingEngine(cfg, params, max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1,
                               gemm_backend=backend, device="cuda")
        for backend in ("torch", "sfc_cuda")
    }
    for eng in engines.values():  # warm-up: first launches, allocator, cuBLAS handles
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))
    torch.cuda.synchronize()

    per_step = cfg.n_layers * 6 + 1  # q, k, v, o, GLU, w_out per layer, plus the head
    want_launches = per_step * NEW_TOKENS  # one prefill and 15 decode steps
    tk.sfc_gemm_fused.launches = 0
    tk.sfc_gemm_fused.launches_by_shape.clear()
    done = engines["sfc_cuda"].run(engines["sfc_cuda"].submit_many(prompts, max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    launches = tk.sfc_gemm_fused.launches
    by_shape = dict(tk.sfc_gemm_fused.launches_by_shape)
    if launches != want_launches:
        raise AssertionError(f"sfc_cuda serve launched the kernel {launches} times, expected {want_launches}")
    reports = {"sfc_cuda": engines["sfc_cuda"].latency_report(done)}
    done_torch = engines["torch"].run(engines["torch"].submit_many(prompts, max_new_tokens=NEW_TOKENS))
    reports["torch"] = engines["torch"].latency_report(done_torch)
    for batch in (done, done_torch):
        for r in batch:
            if r.status != "completed" or len(r.output) != NEW_TOKENS or not all(0 <= t < cfg.vocab for t in r.output):
                raise AssertionError(f"request {r.uid} ended {r.status} with {len(r.output or [])} tokens")
    tokens_sfc = np.array([r.output for r in done])
    tokens_torch = np.array([r.output for r in done_torch])

    # prefill logits against the torch backend.  In bf16 both backends sit
    # about 3% of a logit's spread away from the f32 model after 36 layers
    # (rounding noise that no bf16 implementation avoids), so the bf16
    # bound is asserted where only the implementations differ: the same
    # weights in f32 on both backends.  The bf16 logits must be no further
    # from that f32 reference than the torch backend's are.
    tokens = torch.from_numpy(np.stack(prompts)).long().cuda()
    logits = {b: eng._prefill(tokens)[0].float() for b, eng in engines.items()}
    del engines
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    for backend in ("torch", "sfc_cuda"):
        eng = ServingEngine(cfg32, params32, max_batch=BATCH, max_seq=PROMPT + NEW_TOKENS + 1,
                            gemm_backend=backend, device="cuda")
        logits[backend + "_f32"] = eng._prefill(tokens)[0]
    del eng, params32
    torch.cuda.synchronize()
    if tuple(logits["sfc_cuda"].shape) != (BATCH, cfg.vocab) or not bool(torch.isfinite(logits["sfc_cuda"]).all()):
        raise AssertionError(f"prefill logits shape {tuple(logits['sfc_cuda'].shape)} or non-finite values")
    ok32, err32, worst32 = within(logits["sfc_cuda_f32"], logits["torch_f32"], torch.bfloat16)
    ok16, err16, worst16 = within(logits["sfc_cuda"], logits["torch"], torch.bfloat16)
    ref = logits["torch_f32"]
    noise = {b: float((logits[b] - ref).abs().mean()) for b in ("sfc_cuda", "torch")}
    parity_ok = noise["sfc_cuda"] <= ACCURACY_PARITY * noise["torch"]
    argmax = {b: float((logits[b].argmax(-1) == ref.argmax(-1)).float().mean()) for b in ("sfc_cuda", "torch")}
    serve = {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "dtype": cfg.param_dtype, "params": n_params, "init_s": init_s,
        "requests": BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
        "launches": launches, "launches_expected": want_launches,
        "prefill_logits": {
            "f32_sfc_cuda_vs_torch": {"ok": ok32, "max_abs_err": err32, "err_over_bound": worst32},
            "bf16_sfc_cuda_vs_torch": {"within_bound": ok16, "max_abs_err": err16, "err_over_bound": worst16,
                                       "mean_abs_err": float((logits["sfc_cuda"] - logits["torch"]).abs().mean())},
            "bf16_mean_abs_err_vs_f32": noise, "parity_ok": parity_ok,
            "argmax_match_vs_f32": argmax, "max_abs_logit": float(ref.abs().max()),
        },
        "first_token_match": float((logits["sfc_cuda"].argmax(-1) == logits["torch"].argmax(-1)).float().mean()),
        "greedy_token_match": float((tokens_sfc == tokens_torch).mean()),
        "latency": reports,
    }
    emit(serve)
    if not ok32:
        raise AssertionError(f"f32 prefill logits sfc_cuda vs torch: max err {err32}, err/bound {worst32}")
    if not parity_ok:
        raise AssertionError(f"bf16 sfc_cuda logits further from the f32 model than torch's: {noise}")

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
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"main-path GEMMs never launched during serve: {missing}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
