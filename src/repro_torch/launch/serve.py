"""Serving launcher: batched-request demo driver on the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --requests 4 --prompt-len 128 --max-new 16 --backend sfc_cuda

Weights are random, drawn from ``--seed``.  ``--device`` defaults to the
card; ``--device cpu --reduced`` runs a tiny model on the CPU, where the
``sfc_cuda`` and ``replicated`` backends take the kernels' plain versions.
``--backend replicated`` serves on the replicated 2.5D form (split-K
partial copies, their sum, the epilogue after).  ``--layers N`` cuts the
model to its first N layers: qwen2-72b and qwen2-vl-72b (80 layers, 145 GB
in bf16) fit one 80 GB card at 16.  The VLM is served as text, as the JAX
engine serves it.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.namespaces import BACKENDS, BACKEND_TORCH
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--backend", default=BACKEND_TORCH, choices=list(BACKENDS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None, help="cut the model to its first N layers")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.is_encoder_decoder:
        raise SystemExit("an encoder-decoder is not served by the engine: drive EncDecLM.prefill and decode_step")

    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.embed.device).manual_seed(args.seed))
    engine = ServingEngine(
        cfg,
        model.state_dict(),
        max_batch=args.max_batch,
        max_seq=args.prompt_len + args.max_new + 1,
        gemm_backend=args.backend,
        device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    prompts = [
        rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        for _ in range(args.requests)
    ]
    reqs = engine.submit_many(prompts, max_new_tokens=args.max_new)
    done = engine.run(reqs)
    rep = engine.latency_report(done)
    print(
        f"[serve] backend={args.backend} device={engine.device} n={rep['n_requests']} "
        f"ttft={rep['ttft_mean_s']*1e3:.1f}ms latency={rep['latency_mean_s']*1e3:.1f}ms "
        f"throughput={rep['tokens_per_s']:.1f} tok/s"
    )
    return rep


if __name__ == "__main__":
    main()
