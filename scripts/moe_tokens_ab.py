"""Compare the greedy tokens of two source trees' olmoe-1b-7b serve on one
card: `chip_smoke.py`'s olmoe serve (full width and depth, bf16, the
weights of a seeded torch.Generator, 4 prompts of 128 tokens, 16 new
tokens) under sfc_cuda with blockwise attention, and the same under ABFT
"detect" with every decode step verified, in each tree.

    python3 scripts/moe_tokens_ab.py build/parent .

Each tree runs in a process of its own with its `src/` and `chip_smoke.py`
first on its path, so each builds its own kernels.  Prints one JSON line
per tree (its tokens and K3 launches) and, last, whether the two trees'
tokens are identical and how many differ.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path


def worker(tree: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import sfc_gemm as tk
    from repro_torch.models.registry import build_model
    from repro_torch.robust import abft
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(cs.MOE_ARCH), attn_impl="blockwise")
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    params = model.state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=cs.PROMPT).astype(np.int32) for _ in range(cs.BATCH)]
    out = {}
    for name, verify_every in (("sfc_cuda", None), ("sfc_cuda+abft", 1)):
        for _ in range(2):  # a warm-up engine, then the one read
            eng = ServingEngine(cfg, params, max_batch=cs.BATCH, max_seq=cs.PROMPT + cs.NEW_TOKENS + 1,
                                gemm_backend="sfc_cuda", device="cuda",
                                **({"verify_every": verify_every} if verify_every else {}))
            tk.sfc_gemm_grouped.launches = 0
            with abft.abft_mode("detect" if verify_every else "off"):
                done = eng.run(eng.submit_many(prompts, max_new_tokens=cs.NEW_TOKENS))
            torch.cuda.synchronize()
        out[name] = [[int(t) for t in r.output] for r in done]
        out[f"{name}:k3_launches"] = tk.sfc_gemm_grouped.launches
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--worker"]:
        print(json.dumps(worker(Path(args[1]).resolve())), flush=True)
        return 0
    if len(args) != 2:
        raise SystemExit("usage: moe_tokens_ab.py TREE_A TREE_B")
    res = []
    for tree in args:
        run = subprocess.run([sys.executable, __file__, "--worker", tree], capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": ""})
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            raise SystemExit(f"the serve of {tree} failed with exit code {run.returncode}")
        res.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps({"tree": tree, **res[-1]}), flush=True)
    differing = {name: sum(x != y for ra, rb in zip(res[0][name], res[1][name]) for x, y in zip(ra, rb))
                 for name in ("sfc_cuda", "sfc_cuda+abft")}
    print(json.dumps({"identical": {k: res[0][k] == res[1][k] for k in res[0]}, "tokens_differing": differing}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
