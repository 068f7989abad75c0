#!/usr/bin/env python3
"""Host cost of knob resolution on the serve and the step: one source tree's
untuned qwen3-4b on one NVIDIA GPU.

    python3 scripts/resolve_overhead_ab.py --src PATH/TO/src [--label NAME]

Imports ``repro_torch`` from ``--src`` (so that two trees, say a parent
commit unpacked beside this one, run the same measurement) and points the
tune cache at an empty temporary file, so that every launch is its rule's.
Then, on full-width, full-depth qwen3-4b (36 layers, bf16, weights from a
seeded torch.Generator), as ``chip_smoke.py``'s serve and train phases
measure them:

* the serve of 4 requests, prompt 128, 16 new tokens, under sfc_cuda with
  blockwise and with "sfc" attention, after one warm-up serve: TTFT and
  the p50 gap between tokens (`ServingEngine.latency_report`), the median
  of ``--serves`` serves;
* one training step of 2 x 256 under sfc_cuda with "sfc" attention, fused
  optimizer and not: the wall time of each of ``--steps`` steps after one
  warm-up step, synchronised;
* the host's cost of one `sfc_matmul` call, where the device's is
  negligible: 2,000 calls of a 4 x 64 @ 64 x 64 product (the decode's
  2-D form, the cluster kernel) and of a 4 x 8 x 64 batch over a shared
  weight (the prefill's form, the wgmma kernel), timed on the host's clock
  with one synchronisation at the end, the median of 7 loops in µs a
  call.

Prints the card's name and power limit, then one JSON line.  Compare two
trees only within one call (parent, change, change, parent): the card's
host is shared, so times move between calls.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src directory (holds repro_torch)")
    ap.add_argument("--label", default="", help="a name for the tree in the output")
    ap.add_argument("--serves", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    tmp = tempfile.TemporaryDirectory(prefix="resolve_ab_")
    os.environ["REPRO_TORCH_SFC_TUNE_CACHE"] = str(Path(tmp.name) / "knobs.json")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.train import build_trainer
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.load_all()
    cfg = get_config("qwen3_4b")
    batch, prompt, new = 4, 128, 16
    out = {"label": args.label, "src": str(src), "nvidia_smi": smi, "serve": {}, "step": {}}

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 64, generator=gen, device="cuda").to(torch.bfloat16)
    out["host_us_a_call"] = {}
    for name, shape in (("decode_2d_4x64", (4, 64)), ("batched_4x8x64", (4, 8, 64))):
        a = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(50):
            ops.sfc_matmul(a, w)
        torch.cuda.synchronize()
        loops = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(2000):
                ops.sfc_matmul(a, w)
            torch.cuda.synchronize()
            loops.append((time.perf_counter() - t0) / 2000 * 1e6)
        out["host_us_a_call"][name] = {"median": float(np.median(loops)), "each": loops}

    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    params = model.state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=prompt).astype(np.int32) for _ in range(batch)]
    for impl in ("blockwise", "sfc"):
        eng = ServingEngine(dataclasses.replace(cfg, attn_impl=impl), params, max_batch=batch,
                            max_seq=prompt + new + 1, gemm_backend="sfc_cuda", device="cuda")
        eng.run(eng.submit_many(prompts[:1], max_new_tokens=2))
        torch.cuda.synchronize()
        reps = []
        for _ in range(args.serves):
            done = eng.run(eng.submit_many(prompts, max_new_tokens=new))
            torch.cuda.synchronize()
            reps.append(ServingEngine.latency_report(done))
        out["serve"][f"sfc_cuda+{impl}"] = {
            key: float(np.median([r[key] for r in reps])) for key in ("ttft_mean_s", "token_p50_s", "tokens_per_s")}
        out["serve"][f"sfc_cuda+{impl}"]["token_p50_s_each"] = [r["token_p50_s"] for r in reps]
        del eng
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    for fused in (True, False):
        model, opt_state, step_fn, batch_fn = build_trainer(
            cfg, batch=2, seq=256, total_steps=10, seed=0, gemm_backend="sfc_cuda", attn_impl="sfc",
            fused_optimizer=fused, device="cuda")
        opt_state, _ = step_fn(opt_state, batch_fn(0))
        torch.cuda.synchronize()
        times = []
        for i in range(args.steps):
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(opt_state, batch_fn(i + 1))
            float(metrics["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["step"]["fused" if fused else "unfused"] = {"median_s": float(np.median(times)), "each_s": times}
        del model, opt_state, step_fn, batch_fn, metrics
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
