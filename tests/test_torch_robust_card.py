"""The fallback ladder on the card (marked ``cuda``: they skip on the CPU;
run them there with ``python -m pytest -q --noconftest -m cuda
tests/test_torch_robust_card.py``).  On the card no degradation is silent
by default: a launch the runtime refuses, which is not the fault harness's,
raises `StrictFallbackError` out of `gemm_backend.matmul` and out of the
engine, unless ``REPRO_ALLOW_FALLBACK=1`` allows the descent; then the
replicated rung serves, within one bf16 output rounding (2^-7 |p| + 1e-3
max|p|) of the plain product.  An injected fault keeps its amnesty."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import robust  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.core.namespaces import RUNG_SFC_CUDA  # noqa: E402
from repro_torch.kernels.build import KernelLaunchError  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The card's default: neither strict mode nor a fallback permission in
    the environment; a fresh ledger around each test."""
    monkeypatch.delenv("REPRO_STRICT", raising=False)
    monkeypatch.delenv("REPRO_ALLOW_FALLBACK", raising=False)
    robust.get_registry().reset()
    yield
    robust.get_registry().reset()


def _agree(got, want):
    err = (got.float() - want.float()).abs()
    p = want.float().abs()
    return bool(torch.isfinite(got.float()).all()) and bool((err <= 2.0**-7 * p + 1e-3 * p.max()).all())


def _refused(monkeypatch):
    """The sfc_cuda rung of `matmul` refuses its launch (an invalid
    configuration), as the runtime would at a shape it cannot take."""
    calls = []

    def refused(x, w, kw):
        calls.append(1)
        raise KernelLaunchError("sfc_gemm_fused kernel", 9)

    monkeypatch.setattr(tgb, "_MATMUL_RUNGS", ((RUNG_SFC_CUDA, refused), *tgb._MATMUL_RUNGS[1:]))
    return calls


@pytest.mark.cuda
def test_a_refused_launch_raises_on_the_card_unless_fallback_is_allowed(monkeypatch):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(64, 512, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(512, 256, generator=gen, device="cuda").to(torch.bfloat16)
    calls = _refused(monkeypatch)
    with tgb.gemm_backend("sfc_cuda"), pytest.raises(robust.StrictFallbackError, match="REPRO_ALLOW_FALLBACK"):
        tgb.matmul(x, w)
    assert calls == [1]
    monkeypatch.setenv("REPRO_ALLOW_FALLBACK", "1")
    robust.get_registry().reset()
    with tgb.gemm_backend("sfc_cuda"):
        got = tgb.matmul(x, w)
    torch.cuda.synchronize()
    rep = robust.degradation_report()
    assert rep["served"] == {"gemm": {"replicated": 1}} and rep["fallback_calls"] == 1
    assert [(r["rung"], r["reason"], r["injected"]) for r in rep["quarantined"]] == [("sfc_cuda", "compile", False)]
    assert _agree(got, x.float() @ w.float())


@pytest.mark.cuda
def test_an_injected_fault_keeps_its_amnesty_on_the_card():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(64, 512, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(512, 256, generator=gen, device="cuda").to(torch.bfloat16)
    with robust.fault_injection(robust.FaultSpec("gemm", kind="compile", rungs=("sfc_cuda",))), \
            tgb.gemm_backend("sfc_cuda"):
        got = tgb.matmul(x, w)
    torch.cuda.synchronize()
    assert robust.degradation_report()["served"] == {"gemm": {"replicated": 1}}
    assert _agree(got, x.float() @ w.float())


@pytest.mark.cuda
def test_the_engine_on_the_card_raises_instead_of_quarantining():
    """A classified failure that reaches the engine's `_run_healed` (one no
    ladder covered) raises on the card and quarantines nothing."""
    _card()
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), n_layers=1)
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, model.state_dict(), max_batch=1, max_seq=16, gemm_backend="sfc_cuda", device="cuda")
    launch = KernelLaunchError("sfc_gemm_fused kernel", 701)

    def refused(tokens):
        raise launch

    eng._prefill = refused
    with pytest.raises(robust.StrictFallbackError) as info:
        eng._run_healed("_prefill", torch.zeros(1, 8, dtype=torch.long, device="cuda"))
    assert info.value.__cause__ is launch
    assert not robust.degradation_report()["quarantined"]
