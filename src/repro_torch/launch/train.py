"""Training launcher on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --backend sfc_cuda --attn-impl sfc --steps 3 --batch 2 --seq 256

Weights are random, drawn from ``--seed``; batches come from `SyntheticLM`.
``--device`` defaults to the card; ``--device cpu --reduced`` trains a tiny
model on the CPU, where the ``sfc_cuda`` backend takes each kernel's plain
version.  The JAX CLI's ``--backend xla`` / ``sfc_pallas`` are ``torch`` /
``sfc_cuda`` here, and ``--attn-impl`` sets the step's attention backend.
``--fused-optimizer`` runs AdamW of every routed projection weight inside
the TN kernel's flush (dW never reaches device memory; the clip stays
exact), and ``--no-stochastic-round`` makes its bf16 write-back round to
nearest; ``--remat`` (JAX's choices and CLI default, "none") recomputes
each layer, or each group of the hybrid and xLSTM families, in the
backward (`models.remat`):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --device cpu --fused-optimizer --backend sfc_cuda --steps 8 --batch 4 --seq 32

On the MoE config (olmoe-1b-7b) the fused optimizer also runs each expert
stack's AdamW inside the grouped TN kernel's flush (K10):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced \
      --device cpu --fused-optimizer --backend sfc_cuda --steps 4 --batch 2 --seq 16

Every family trains: the encoder-decoder's batch carries the JAX package's
stub frame embeddings (``src_embeds``, as many frames as tokens), the VLM's its M-RoPE
positions and stub vision rows:

  PYTHONPATH=src python -m repro_torch.launch.train --arch seamless-m4t-medium --reduced \
      --device cpu --backend sfc_cuda --remat dots --steps 2 --batch 2 --seq 16

The steps run in `train.fault_tolerance.TrainLoop` (a `StepWatchdog`
logs stragglers).  ``--ckpt-dir DIR`` resumes from DIR's latest committed
checkpoint and saves there every ``--ckpt-every`` steps (default 50) and at
the end (`train.checkpoint.CheckpointManager`: the parameters, the AdamW
state and the loop's lr scale and data offset); ``--fail-at N`` simulates
a preemption at step N.  Without ``--ckpt-dir`` nothing is saved (the JAX
CLI saves to a fixed directory).  A checkpoint holds 14 bytes a parameter
(bf16 weights, f32 master, mu and nu):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --device cpu --backend sfc_cuda --steps 8 --ckpt-dir /tmp/ck --ckpt-every 2 --fail-at 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --device cpu --backend sfc_cuda --steps 8 --ckpt-dir /tmp/ck --ckpt-every 2

The mesh (ROADMAP item 16) is not ported.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.attention_backend import ATTN_IMPLS
from repro_torch.core.namespaces import BACKENDS
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.models.registry import build_model
from repro_torch.models.remat import REMAT_POLICIES
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import StepWatchdog, TrainLoop, model_step
from repro_torch.train.step import BackendConfig, make_train_step


def make_batch_fn(cfg, *, batch: int, seq: int, seed: int = 0, device=None):
    """``batch_fn(step) -> batch`` on ``device``: `SyntheticLM`'s tokens and
    labels, and the family's inputs as the JAX package's trainer draws
    them."""
    data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed))

    def batch_fn(step: int):
        out = {k: torch.from_numpy(v) for k, v in data.batch(step).items()}
        if cfg.family == "audio":
            # the JAX package's encoder-decoder inputs: ``seq`` stub frame embeddings
            rng = np.random.default_rng(step)
            out["src_embeds"] = torch.from_numpy(
                rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32) * 0.1)
        if cfg.family == "vlm":
            # the JAX package's VLM inputs: text positions on every M-RoPE
            # axis and up to 8 stub patch embeddings drawn from the step
            out["mrope_positions"] = torch.arange(seq, dtype=torch.int32)[None, None].expand(3, batch, seq)
            n_img = min(8, seq)
            rng = np.random.default_rng(step)
            out["vision_embeds"] = torch.from_numpy(
                rng.normal(size=(batch, n_img, cfg.d_model)).astype(np.float32) * 0.1)
        return {k: v.to(device) for k, v in out.items()}

    return batch_fn


def build_trainer(
    cfg,
    *,
    batch: int,
    seq: int,
    lr: float = 3e-4,
    total_steps: int = 1000,
    remat: str = "none",
    microbatches: int = 1,
    seed: int = 0,
    gemm_backend: Optional[str] = None,
    attn_impl: Optional[str] = None,
    fused_optimizer: bool = False,
    stochastic_round: bool = True,
    abft: Optional[str] = None,
    device=None,
):
    """Returns (model, opt_state, step, batch_fn): the model with random
    weights from ``seed`` on ``device`` (the card unless named), the AdamW
    state, ``step(opt_state, batch) -> (opt_state, metrics)`` and
    ``batch_fn(step) -> batch`` on the model's device.  ``fused_optimizer``,
    ``stochastic_round`` and ``abft`` are `train.step.BackendConfig`'s."""
    model = build_model(cfg, device=device)
    model.init(torch.Generator(device=model.embed.device).manual_seed(seed))
    opt_cfg = AdamWConfig(lr=lr, total_steps=total_steps, warmup_steps=min(100, total_steps // 10 + 1))
    step_fn = make_train_step(
        model, opt_cfg, remat=remat, microbatches=microbatches,
        backend=BackendConfig(gemm_backend=gemm_backend, attn_impl=attn_impl, fused_optimizer=fused_optimizer,
                              stochastic_round=stochastic_round, abft=abft),
    )
    opt_state = adamw_init(dict(model.named_parameters()))
    batch_fn = make_batch_fn(cfg, batch=batch, seq=seq, seed=seed, device=model.embed.device)
    return model, opt_state, step_fn, batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none", choices=list(REMAT_POLICIES),
                    help="activation recomputation of each layer (group) in the backward")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None, help="resume from and save checkpoints in this directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None, help="simulate preemption")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="GEMM backend for the train step (forward and backward)")
    ap.add_argument("--attn-impl", default=None, choices=list(ATTN_IMPLS),
                    help="attention backend for the train step (default: the config's)")
    ap.add_argument("--fused-optimizer", action="store_true",
                    help="AdamW inside the TN kernel flush for routed 2-D weights and expert stacks (dW "
                         "never reaches device memory; exact grad clipping in two phases)")
    ap.add_argument("--no-stochastic-round", action="store_true",
                    help="round-to-nearest bf16 write-back in the fused flush")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model, opt_state, step_fn, batch_fn = build_trainer(
        cfg, batch=args.batch, seq=args.seq, lr=args.lr, total_steps=args.steps, remat=args.remat,
        microbatches=args.microbatches, seed=args.seed, gemm_backend=args.backend,
        attn_impl=args.attn_impl, fused_optimizer=args.fused_optimizer,
        stochastic_round=not args.no_stochastic_round, device=args.device,
    )
    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_every) if args.ckpt_dir else None
    loop = TrainLoop(train_step=model_step(step_fn), batch_fn=batch_fn, ckpt=ckpt, watchdog=StepWatchdog())
    _, _, history = loop.run(dict(model.named_parameters()), opt_state, num_steps=args.steps,
                             resume=ckpt is not None, fail_at=args.fail_at)
    print(f"final loss: {history[-1][1]:.4f}  (from {history[0][1]:.4f})")
    return history


if __name__ == "__main__":
    main()
