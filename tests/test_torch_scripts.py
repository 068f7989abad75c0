"""CPU checks of helpers that the card-side scripts run: `chip_smoke.py`'s
routing reading where two backends' greedy tokens part, on reduced
olmoe-1b-7b, and the ptxas log parser of `scripts/dense_kernel_ab.py`."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up here
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_counts_reads_registers_and_spills(tmp_path):
    ab = _load(ROOT / "scripts" / "dense_kernel_ab.py", "dense_kernel_ab")
    log = tmp_path / "build" / "sfc_gemm_fused-0" / "nvcc.log"
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : Compiling entry function '_Z9nt_kernelIfLb0EEv9BwdParams' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z9nt_kernelIfLb0EEv9BwdParams\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 552 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z9tn_kernelIfLb1EEv9BwdParams' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z9tn_kernelIfLb1EEv9BwdParams\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 552 bytes cmem[0]\n")
    counts = ab.ptxas_counts(tmp_path)
    assert sorted(counts.values()) == [[96, 8, 12], [128, 0, 0]]
    assert [k for k in counts if "nt_kernel" in k] and [k for k in counts if "tn_kernel" in k]


def test_routing_at_divergence_replays_both_backends():
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(), param_dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=8).astype(np.int32) for _ in range(2)]
    engines = {name: ServingEngine(cfg, params, max_batch=2, max_seq=13, gemm_backend=name, device="cpu")
               for name in ("sfc_cuda", "torch")}
    batch = engines["torch"].run(engines["torch"].submit_many(prompts, max_new_tokens=4))
    torch_tokens = np.array([r.output for r in batch])
    route = tmoe.route
    same = {"sfc_cuda": torch_tokens.copy(), "torch": torch_tokens}
    assert cs.moe_routing_at_divergence(torch, np, engines, prompts, same, cfg.moe_top_k) == {"diverged_requests": 0}
    parted = torch_tokens.copy()
    parted[1, 2] = (parted[1, 2] + 1) % cfg.vocab
    out = cs.moe_routing_at_divergence(torch, np, engines, prompts, {"sfc_cuda": parted, "torch": torch_tokens},
                                       cfg.moe_top_k)
    assert tmoe.route is route
    assert out["diverged_requests"] == 1
    (req,) = out["requests"]
    assert (req["request"], req["first_divergent_token"], req["step"]) == (1, 2, "decode 2")
    assert req["layers"] == cfg.n_layers
    assert 0 <= req["layers_with_different_topk"] == len(req["swapped_prob_gap_torch"]) <= cfg.n_layers
    # the prompt's 8 tokens at the prefill, then one token at each of 2 decode steps
    assert req["sets_through_step"] == (8 + 2) * cfg.n_layers
    assert 0 <= req["sets_different_through_step"] <= req["sets_through_step"]
    assert req["topk_margin_median_torch"] >= 0 and req["torch_top1_logit_margin"] >= 0
