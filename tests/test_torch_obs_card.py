"""The port's spans in a torch profile on the card (marked ``cuda``: they
skip on the CPU; run them there with ``python -m pytest -q --noconftest -m
cuda tests/test_torch_obs_card.py``), through the trace readers
``chip_smoke.py`` uses: a decode step and a train step of qwen3-4b at full
width cut to 2 layers (bf16, "sfc" attention) hold one ``ladder/run``
annotation for each ladder call the ledger counted, every launch of the
port's kernels inside one, and the step's busy time (kernels, memcpy,
memset) is the same with the spans on and off, within 10% of each other."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

LAYERS = 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _gate():
    obs.set_enabled(None)
    yield
    obs.set_enabled(None)


def _cut():
    return dataclasses.replace(get_config("qwen3_4b"), n_layers=LAYERS, attn_impl="sfc")


@pytest.mark.cuda
def test_a_decode_steps_spans_enclose_its_k1_and_k14_launches_on_card():
    _card()
    smoke = _smoke()
    cfg = _cut()
    params = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0)).state_dict()
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=145, gemm_backend="sfc_cuda", device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 128))).long().cuda()
    profiles = {"on": [], "off": []}
    for gate in ("on", "off", "on", "off"):
        obs.set_enabled(gate == "on")
        profiles[gate].append(smoke.profile_decode(torch, eng, tokens, ops))
    for p in profiles["on"]:
        print(p["annotations"], p["device_busy_ms"], p["every_device_event_ms"])
    out = smoke.spans_in_profile(profiles, {"K1 cluster": 6 * LAYERS + 1, "K14": LAYERS})
    assert all(out["annotations_ok"])


@pytest.mark.cuda
def test_a_train_steps_spans_enclose_the_ports_launches_on_card():
    _card()
    from repro_torch.launch.train import build_trainer

    smoke = _smoke()
    model, opt_state, step_fn, batch_fn = build_trainer(_cut(), batch=2, seq=256, total_steps=3, seed=0,
                                                        gemm_backend="sfc_cuda", attn_impl="sfc", device="cuda")
    opt_state, _ = step_fn(opt_state, batch_fn(0))
    opt_state, prof = smoke.profile_step(torch, step_fn, opt_state, batch_fn(1))
    print(prof["annotations"], prof["device_busy_s"], prof["every_device_event_ms"])
    assert smoke.annotations_ok(prof["annotations"])
    assert prof["device_busy_s"] * 1e3 <= prof["every_device_event_ms"]
