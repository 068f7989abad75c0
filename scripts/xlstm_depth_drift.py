"""Where xlstm-1.3b's bf16 serve parts from its f32 model, block by block.

Full-width, full-depth xlstm-1.3b (48 blocks: 6 groups of 7 mLSTM blocks
and one sLSTM block, d_model 2048, seeded random weights as in
`chip_smoke.py`) runs its prefill three ways on one card: in f32 under the
torch backend (the reference, 3.53 B parameters as the JAX config reckons
them, about 14 GB), and in bf16 under sfc_cuda and under torch.  For each
block it reports how far each bf16 run's hidden state is from the
reference's, relative to the reference's size (mean |h - h_f32| / mean
|h_f32|):

* ``carried``: each run feeds its own previous block's output forward, as
  the serve does, so the error compounds over the depth;
* ``local``: every block takes the reference's input (cast to bf16) and
  its output is held to the reference block's, so each block's own error
  shows apart from what it inherits.

Both on the 4 x 128 prompts and on the 1 x 600 prompt of `chip_smoke.py`'s
xlstm phase; beside them the last-position logits' error, the first-token
and greedy-token agreement of a 16-token (8 for 1 x 600) serve with the f32
model's, and the verdict: sfc_cuda departs more than torch where its
carried error at the last block, or its logits' error, exceeds
``PARITY`` (1.25, chip_smoke's accuracy parity) times torch's; the block
whose local error first does so bisects it.

    python3 scripts/xlstm_depth_drift.py

Needs a CUDA device and nvcc.  Writes build/xlstm_depth_drift.json
and prints one JSON line per prompt set and a verdict line.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

PARITY = 1.25
PROMPT, BATCH, NEW_TOKENS = 128, 4, 16
LONG_PROMPT, LONG_NEW = 600, 8


def rel(torch, got, want) -> float:
    return float((got.float() - want).abs().mean() / want.abs().mean().clamp_min(1e-30))


def block_states(torch, model, tokens, backend, gemm_backend, xlstm, inputs=None):
    """(each block's output in f32, last-position logits in f32) of one
    prefill under ``backend``.  With ``inputs`` (the reference's block
    inputs) every block takes its own input from there, cast to the
    model's type (the local error)."""
    cfg = model.cfg
    dt = model.embed.dtype
    outs, ins = [], []
    with torch.no_grad(), gemm_backend(backend):
        x = model.embed[tokens]
        blocks = []
        for group, s_block in zip(model.mlstm, model.slstm):
            blocks += [("m", b) for b in group] + [("s", s_block)]
        for i, (kind, block) in enumerate(blocks):
            if inputs is not None:
                x = inputs[i].to(dt)
            ins.append(x.float())
            if kind == "m":
                x = xlstm.mlstm_block_forward(block, x, n_heads=cfg.n_heads, chunk=cfg.ssm_chunk)
            else:
                x = xlstm.slstm_block_forward(block, x, n_heads=cfg.n_heads)
            outs.append(x.float())
        logits = model._logits(x[:, -1:])[:, 0].float()
    return outs, ins, logits


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("xlstm_depth_drift: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.gemm_backend import gemm_backend
    from repro_torch.kernels import build
    from repro_torch.models import xlstm
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load_all()
    cfg = get_config("xlstm_1_3b")
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    params = model.state_dict()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    model32 = build_model(cfg32, device="meta")
    model32.load_state_dict({k: v.float() for k, v in params.items()}, assign=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=PROMPT).astype(np.int32) for _ in range(BATCH)]
    long_prompt = [rng.integers(0, cfg.vocab, size=LONG_PROMPT).astype(np.int32)]
    report = {"arch": cfg.name, "blocks": cfg.n_layers, "params": sum(p.numel() for p in params.values()),
              "setup_s": time.perf_counter() - t0, "sets": {}}
    for label, batch, new in ((f"{BATCH}x{PROMPT}", prompts, NEW_TOKENS), (f"1x{LONG_PROMPT}", long_prompt, LONG_NEW)):
        tokens = torch.from_numpy(np.stack(batch)).long().cuda()
        ref, ref_in, ref_logits = block_states(torch, model32, tokens, "torch", gemm_backend, xlstm)
        row = {"carried": {}, "local": {}, "logits_rel_err": {}, "first_token_match": {}, "greedy_token_match": {}}
        for backend in ("sfc_cuda", "torch"):
            outs, _, logits = block_states(torch, model, tokens, backend, gemm_backend, xlstm)
            row["carried"][backend] = [rel(torch, o, r) for o, r in zip(outs, ref)]
            row["logits_rel_err"][backend] = rel(torch, logits, ref_logits)
            row["first_token_match"][backend] = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
            local, _, _ = block_states(torch, model, tokens, backend, gemm_backend, xlstm, inputs=ref_in)
            row["local"][backend] = [rel(torch, o, r) for o, r in zip(local, ref)]
            del outs, local
        served = {}
        for name, conf, backend in (("f32", cfg32, "torch"), ("sfc_cuda", cfg, "sfc_cuda"), ("torch", cfg, "torch")):
            eng = ServingEngine(conf, params, max_batch=BATCH, max_seq=tokens.shape[1] + new + 1,
                                gemm_backend=backend, device="cuda")
            served[name] = np.array([r.output for r in eng.run(eng.submit_many(batch, max_new_tokens=new))])
            del eng
        for backend in ("sfc_cuda", "torch"):
            row["greedy_token_match"][backend] = float((served[backend] == served["f32"]).mean())
        row["greedy_token_match"]["sfc_cuda_vs_torch"] = float((served["sfc_cuda"] == served["torch"]).mean())
        sfc, tch = row["carried"]["sfc_cuda"], row["carried"]["torch"]
        row["last_block_ratio"] = sfc[-1] / tch[-1]
        row["logits_ratio"] = row["logits_rel_err"]["sfc_cuda"] / row["logits_rel_err"]["torch"]
        worse = [i for i, (a, b) in enumerate(zip(row["local"]["sfc_cuda"], row["local"]["torch"])) if a > PARITY * b]
        row["first_block_local_over_parity"] = worse[0] if worse else None
        row["departs_more_than_torch"] = row["last_block_ratio"] > PARITY or row["logits_ratio"] > PARITY
        report["sets"][label] = row
        print(json.dumps({"set": label, **{k: v for k, v in row.items() if k not in ("carried", "local")},
                          "carried_every_8th": {b: v[7::8] for b, v in row["carried"].items()},
                          "local_max": {b: max(v) for b, v in row["local"].items()}}), flush=True)
        torch.cuda.empty_cache()
    report["verdict"] = ("sfc_cuda departs more than torch" if any(r["departs_more_than_torch"]
                                                                  for r in report["sets"].values())
                         else "a property of the model: sfc_cuda within parity of torch at every block")
    report["seconds"] = time.perf_counter() - t0
    out = ROOT / "build" / "xlstm_depth_drift.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"verdict": report["verdict"], "seconds": report["seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
