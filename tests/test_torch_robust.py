"""The port's fallback ladder, health registry and fault injection
(`repro_torch.robust`, the ladders of `core.gemm_backend`,
`core.attention_backend`, `kernels.ops` and `optim.fused`, the engine's
self-healing, the tuner's lift) against the JAX package's
(``repro.robust``, interpret mode on the CPU), and `obs.metrics` against
``repro.obs.metrics``.

Tolerances: every rung differential in f32 at rtol 1e-4 (atol 1e-5;
gradients: plus 1e-5 of their largest |value|, as in test_torch_train); a
ledger and a classification exactly the JAX package's, with the rung names
mapped ("sfc_pallas" -> "sfc_cuda", "xla" -> "torch"); the engine's tokens
exactly; a redone step's recurrent state bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import robust as jrobust  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import attention_backend as jab  # noqa: E402
from repro.core import gemm_backend as jgb  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.robust import abft as jabft  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import robust  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import attention_backend as tab  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    FallbackError,
    FaultSpec,
    HealthRegistry,
    StrictFallbackError,
    abft,
    classify_failure,
    fault_injection,
    get_registry,
    run_with_fallback,
)
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import tuner as ttuner  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
TO_JAX = {"sfc_cuda": "sfc_pallas", "torch": "xla"}


def _jax_rung(rung):
    return TO_JAX.get(rung, rung)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No ambient strict mode or fallback permission (the tests that need
    them set them), fresh registries and runtime counters in both packages
    before and after each test: a quarantine left behind would reroute
    later calls."""
    monkeypatch.delenv("REPRO_STRICT", raising=False)
    monkeypatch.delenv("REPRO_ALLOW_FALLBACK", raising=False)
    for reset in (get_registry().reset, jrobust.get_registry().reset, abft.reset_runtime_sdc,
                  jabft.reset_runtime_sdc):
        reset()
    yield
    for reset in (get_registry().reset, jrobust.get_registry().reset, abft.reset_runtime_sdc,
                  jabft.reset_runtime_sdc):
        reset()


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, grad=False):
    """f32 at rtol 1e-4, atol 1e-5; a gradient's atol is 1e-5 of its
    largest |value| (an element near zero carries its large terms'
    rounding), as in tests/test_torch_train.py."""
    want = np.asarray(want)
    atol = max(ATOL, 1e-5 * float(np.abs(want).max())) if grad else ATOL
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), want, rtol=RTOL,
                               atol=atol)


def _specs(ns, faulted, kind="compile", jax_side=False):
    if not faulted:
        return []
    rungs = tuple(_jax_rung(r) for r in faulted) if jax_side else tuple(faulted)
    return [(jrobust.FaultSpec if jax_side else FaultSpec)(ns, kind=kind, rungs=rungs)]


# ---------------------------------------------------------------------------
# the fault injection harness
# ---------------------------------------------------------------------------


def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultSpec("gemm", kind="segfault")


def test_injection_targets_namespace_and_call_index():
    fired = []
    with fault_injection(FaultSpec("ns_a", kind="compile", calls=(1,))):
        for _ in range(3):
            try:
                run_with_fallback("ns_a", (("sfc_cuda", lambda: "kernel"),), registry=HealthRegistry())
                fired.append(False)
            except FallbackError:
                fired.append(True)
        assert run_with_fallback("ns_b", (("sfc_cuda", lambda: "ok"),), registry=HealthRegistry()) == "ok"
    assert fired == [False, True, False]


def test_injection_glob_pattern_matches_many_namespaces():
    with fault_injection(FaultSpec("attn_*", kind="compile")):
        for ns in ("attn_fwd", "attn_decode"):
            got = run_with_fallback(ns, (("sfc_cuda", lambda: "kernel"), ("torch", lambda: "torch")),
                                    registry=HealthRegistry())
            assert got == "torch"
        assert run_with_fallback("gemm", (("sfc_cuda", lambda: "kernel"),), registry=HealthRegistry()) == "kernel"


@pytest.mark.parametrize("kind", ["nan", "bitflip"])
def test_poisons_match_jax(kind):
    """"nan" poisons every floating output, "bitflip" with ABFT off flips
    bit 30 of the first element of the first floating output (bitwise the
    JAX harness's); integer outputs are left alone."""
    x = _rand(3, 5, seed=1)
    outs = []
    for pkg, arr in ((robust, (_t(x), torch.arange(3))), (jrobust, (jnp.asarray(x), jnp.arange(3)))):
        with pkg.fault_injection(pkg.FaultSpec("ns", kind=kind, rungs=None)):
            outs.append(pkg.run_with_fallback("ns", (("r", lambda: arr),), registry=pkg.HealthRegistry()))
    (tx, ti), (jx, ji) = outs
    if kind == "nan":
        assert torch.isnan(tx).all() and np.isnan(np.asarray(jx)).all()
    else:
        np.testing.assert_array_equal(tx.numpy().view(np.int32), np.asarray(jx).view(np.int32))
        assert (tx.numpy() != x).sum() == 1
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_bitflip_with_abft_raises_outside_a_scope_and_records_inside():
    """With ABFT on, an injected flip outside a step scope raises
    `InjectedSdc` (the ladder retries the rung), inside one it is recorded
    in the scope and counted at its exit as a detection (the port's
    deliberate difference: the scope is its traced program)."""
    reg = HealthRegistry()
    calls = []
    with abft.abft_mode("detect"), fault_injection(FaultSpec("gemm", kind="bitflip", fires=1)):
        got = run_with_fallback("gemm", (("sfc_cuda", lambda: calls.append(1) or "kernel"),), registry=reg)
    assert got == "kernel" and calls == [1] and reg.sdc_counts() == {"gemm": {"detected": 1, "healed": 1}}
    with abft.abft_mode("detect"), abft.step_scope() as scope, fault_injection(
            FaultSpec("gemm", kind="bitflip", fires=1)):
        got = run_with_fallback("gemm", (("sfc_cuda", lambda: "kernel"),), registry=reg)
    assert got == "kernel" and scope.detections == {"gemm": 1} and abft.runtime_sdc_total() == 1
    assert get_registry().sdc_counts() == {"gemm": {"detected": 1, "healed": 0}}  # the scope's mirror


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

_JAX_TABLE = [  # (port exception, JAX exception): JAX's table (tests/test_robust.py)
    (lambda: robust.InjectedCompileError("gemm", "sfc_cuda", 0),
     lambda: jrobust.InjectedCompileError("gemm", "sfc_pallas", 0)),
    (lambda: robust.InjectedResourceExhausted("gemm", "sfc_cuda", 0),
     lambda: jrobust.InjectedResourceExhausted("gemm", "sfc_pallas", 0)),
    # VmemBudgetError has no counterpart (the port plans no VMEM): the port's
    # side is its message, which the JAX markers classify alike
    (lambda: RuntimeError("fused plan exceeds the VMEM budget"),
     lambda: jrobust.VmemBudgetError("fused plan exceeds the VMEM budget")),
    (lambda: NotImplementedError("no lowering for op"), lambda: NotImplementedError("no lowering for op")),
    (lambda: RuntimeError("RESOURCE_EXHAUSTED: Ran out of memory in VMEM"),
     lambda: RuntimeError("RESOURCE_EXHAUSTED: Ran out of memory in VMEM")),
    (lambda: RuntimeError("Mosaic lowering failed: Unsupported op"),
     lambda: RuntimeError("Mosaic lowering failed: Unsupported op")),
    (lambda: AssertionError("Bounds check failed"), lambda: AssertionError("Bounds check failed")),
    (lambda: RuntimeError("block shape not divisible"), lambda: RuntimeError("block shape not divisible")),
    (lambda: ValueError("a plain bug"), lambda: ValueError("a plain bug")),
    (lambda: KeyError("missing"), lambda: KeyError("missing")),
    (lambda: abft.SdcDetected("gemm", 1.0, 0.1), lambda: jabft.SdcDetected("gemm", 1.0, 0.1)),
    (lambda: abft.InjectedSdc("gemm", "sfc_cuda", 0), lambda: jabft.InjectedSdc("gemm", "sfc_pallas", 0)),
]


@pytest.mark.parametrize("case", range(len(_JAX_TABLE)))
def test_classify_failure_matches_jax(case):
    port, jax_ = _JAX_TABLE[case]
    want = jrobust.classify_failure(jax_())
    assert classify_failure(port()) == want
    assert want in ("compile", "oom", "interpret", "sdc", None)


@pytest.mark.parametrize("exc,kind", [
    (KernelLaunchError("k", 2), "oom"),  # cudaErrorMemoryAllocation
    *[(KernelLaunchError("k", code), "compile") for code in (1, 9, 98, 209, 701, 720, 912)],
    *[(KernelLaunchError("k", code), None) for code in (214, 700, 702, 710, 714, 715, 716, 717, 718, 719)],
    (KernelLaunchError("k", 999), None),  # unknown: not classified
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), None),
    (RuntimeError("CUDA error: device-side assert triggered"), None),
    (KernelBuildError("nvcc failed:\nerror: unsupported feature in lowering"), None),
    (KernelBuildError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is"), None),
], ids=lambda v: getattr(v, "code", None) if isinstance(v, KernelLaunchError) else None)
def test_classify_card_failures(exc, kind):
    """The card's failures by type: OOM and a launch refused at its shape
    are classified; a sticky CUDA error (the context is dead) and a failed
    build (the installation is broken) never are, whatever their message."""
    assert classify_failure(exc) == kind


@pytest.mark.parametrize("exc", [KernelLaunchError("sfc_gemm_fused kernel", 700),
                                 KernelBuildError("nvcc failed: unsupported"),
                                 RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_sticky_errors_and_build_failures_reraise_through_the_ladder(exc):
    reg = HealthRegistry()

    def bad():
        raise exc

    with pytest.raises(type(exc)):
        run_with_fallback("gemm", (("sfc_cuda", bad), ("torch", lambda: 1)), registry=reg)
    assert not reg.export_state() and reg.degradation_report()["total_calls"] == 0


def test_launch_error_keeps_its_message_and_code():
    exc = KernelLaunchError("sfc_gemm_fused cluster kernel", 701)
    assert exc.code == 701 and isinstance(exc, RuntimeError)
    assert str(exc) == "sfc_gemm_fused cluster kernel launch failed with CUDA error 701"


def test_unclassified_errors_propagate_through_ladder():
    def bad():
        raise ValueError("a plain bug, not platform breakage")

    with pytest.raises(ValueError, match="plain bug"):
        run_with_fallback("ns", (("sfc_cuda", bad), ("torch", lambda: 1)), registry=HealthRegistry())


# ---------------------------------------------------------------------------
# ladder + quarantine
# ---------------------------------------------------------------------------


def test_ladder_degrades_and_quarantines_then_skips():
    reg = HealthRegistry()
    calls = {"kernel": 0, "torch": 0}

    def kernel():
        calls["kernel"] += 1
        raise KernelLaunchError("sfc_gemm_fused kernel", 701)

    def torch_rung():
        calls["torch"] += 1
        return "torch"

    rungs = (("sfc_cuda", kernel), ("torch", torch_rung))
    for _ in range(3):
        assert run_with_fallback("ns", rungs, shape_key="64x64", registry=reg) == "torch"
    assert calls == {"kernel": 1, "torch": 3}  # quarantined after the first failure
    rec = reg.get_quarantine("ns", "sfc_cuda", "64x64")
    assert rec is not None and rec.reason == "compile"
    rep = reg.degradation_report()
    assert rep["fallback_calls"] == 3 and rep["total_calls"] == 3
    assert reg.clear("ns") == 1  # the re-tune hook lifts it
    assert run_with_fallback("ns", (("sfc_cuda", lambda: "kernel"), ("torch", torch_rung)), shape_key="64x64",
                             registry=reg) == "kernel"


def test_quarantine_none_shape_covers_every_shape():
    reg = HealthRegistry()
    reg.quarantine("ns", "sfc_cuda", None, "oom")
    assert reg.is_quarantined("ns", "sfc_cuda", "anything")
    got = run_with_fallback("ns", (("sfc_cuda", lambda: "kernel"), ("torch", lambda: "torch")),
                            shape_key="128x128", registry=reg)
    assert got == "torch"


def test_every_rung_exhausted_raises_fallback_error():
    def bad():
        raise NotImplementedError("no kernel for this shape")

    with pytest.raises(FallbackError):
        run_with_fallback("ns", (("sfc_cuda", bad), ("torch", bad)), registry=HealthRegistry())


def test_shape_key_is_computed_only_when_the_walk_needs_it():
    seen = []

    def key():
        seen.append(1)
        return "k"

    reg = HealthRegistry()
    run_with_fallback("ns", (("sfc_cuda", lambda: 1),), shape_key=key, registry=reg)
    assert not seen  # the healthy path builds no key
    reg.quarantine("other", "sfc_cuda", None, "oom")
    run_with_fallback("ns", (("sfc_cuda", lambda: 1),), shape_key=key, registry=reg)
    assert seen == [1]
    assert reg.degradation_report()["served"] == {"ns": {"sfc_cuda": 2}}


def test_sdc_retries_the_rung_once_unless_it_wrote_in_place():
    """"sdc" is retried once on the same rung (a transient flip heals),
    except on a ladder whose rungs write state in place before their check
    (``in_place=True``: the fused update), whose detection goes up."""
    reg = HealthRegistry()
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            raise abft.SdcDetected("tn_update", 1.0, 0.1)
        return "ok"

    assert run_with_fallback("tn_update", (("sfc_cuda", flaky), ("torch", lambda: "oracle")), registry=reg) == "ok"
    assert len(attempts) == 2 and reg.sdc_counts() == {"tn_update": {"detected": 1, "healed": 1}}
    attempts.clear()
    with pytest.raises(abft.SdcDetected):
        run_with_fallback("tn_update", (("sfc_cuda", flaky), ("torch", lambda: "oracle")), registry=reg,
                          in_place=True)
    assert len(attempts) == 1 and not reg.export_state()


@pytest.mark.parametrize("exc, moves_on", [
    (torch.OutOfMemoryError("CUDA out of memory"), False),
    (AssertionError("after the write"), False),
    (abft.SdcDetected("tn_update", 1.0, 0.1), False),
    (KernelLaunchError("sfc_gemm_tn update kernel", 9), True),
    (KernelLaunchError("sfc_gemm_tn update kernel", 2), True),
    (None, True),  # an injected fault: raised before the rung runs
], ids=["oom", "assert", "sdc", "launch-refused", "launch-oom", "injected"])
def test_an_in_place_ladder_moves_on_only_before_its_rung_wrote(exc, moves_on):
    """``in_place=True``: a classified failure after the rung ran (it may
    have written its state) re-raises, and the oracle, which would apply
    the update a second time, never runs; a launch the runtime refused (the
    kernel never ran) and an injected fault (raised before the rung) still
    descend.  The same holds on the healthy path and in the walk."""
    for quarantined_elsewhere in (False, True):
        reg, wrote, oracle = HealthRegistry(), [], []
        if quarantined_elsewhere:  # the walk instead of the healthy path
            reg.quarantine("other", "sfc_cuda", None, "oom")

        def kernel():
            wrote.append(1)
            if exc is not None:
                raise exc
            return "kernel"

        rungs = (("sfc_cuda", kernel), ("torch", lambda: oracle.append(1) or "oracle"))
        specs = [FaultSpec("tn_update", kind="compile")] if exc is None else []
        with fault_injection(*specs):
            if moves_on:
                assert run_with_fallback("tn_update", rungs, registry=reg, in_place=True) == "oracle"
                assert oracle == [1] and len(wrote) == (exc is not None)
            else:
                with pytest.raises(type(exc)):
                    run_with_fallback("tn_update", rungs, registry=reg, in_place=True)
                assert wrote == [1] and not oracle
                assert not reg.degradation_report(["tn_update"])["quarantined"]


def test_strict_mode_raises_on_real_degradation(monkeypatch):
    monkeypatch.setenv("REPRO_STRICT", "1")

    def bad():
        raise KernelLaunchError("k", 9)

    with pytest.raises(StrictFallbackError):
        run_with_fallback("ns", (("sfc_cuda", bad), ("torch", lambda: "torch")), registry=HealthRegistry())


@pytest.mark.parametrize("allow", [None, "1"], ids=["default", "allowed"])
def test_a_degradation_on_the_card_raises_unless_fallback_is_allowed(monkeypatch, allow):
    """Without ``REPRO_STRICT``, a degradation whose output lies on the card
    raises unless ``REPRO_ALLOW_FALLBACK=1``; an injected fault keeps its
    amnesty; on the CPU the descent stays silent, as JAX's.  (The output's
    device is faked: the CPU has no card.)"""
    from repro_torch.robust import ladder

    if allow is not None:
        monkeypatch.setenv("REPRO_ALLOW_FALLBACK", allow)

    def bad():
        raise KernelLaunchError("k", 9)

    rungs = (("sfc_cuda", bad), ("torch", lambda: "torch"))
    assert run_with_fallback("ns", rungs, registry=HealthRegistry()) == "torch"  # the CPU: silent
    monkeypatch.setattr(ladder, "_on_card", lambda out: True)
    if allow is None:
        with pytest.raises(StrictFallbackError, match="REPRO_ALLOW_FALLBACK"):
            run_with_fallback("ns", rungs, registry=HealthRegistry())
    else:
        assert run_with_fallback("ns", rungs, registry=HealthRegistry()) == "torch"
    with fault_injection(FaultSpec("ns", kind="compile")):
        assert run_with_fallback("ns", (("sfc_cuda", lambda: "kernel"), ("torch", lambda: "torch")),
                                 registry=HealthRegistry()) == "torch"
    assert ladder.strict_mode(on_card=True) is (allow is None) and not ladder.strict_mode()


def test_strict_mode_amnesty_for_injected_faults(monkeypatch):
    monkeypatch.setenv("REPRO_STRICT", "1")
    with fault_injection(FaultSpec("ns", kind="compile")):
        got = run_with_fallback("ns", (("sfc_cuda", lambda: "kernel"), ("torch", lambda: "torch")),
                                registry=HealthRegistry())
    assert got == "torch"


def test_health_registry_knob_cache_roundtrip(tmp_path):
    path = str(tmp_path / "knobs.json")
    reg = HealthRegistry()
    reg.quarantine("gemm", "sfc_cuda", "64x64x64|float32", "compile", error=KernelLaunchError("k", 701))
    reg.save_to_cache(tcache.KnobCache(path))
    reg2 = HealthRegistry()
    reg2.load_from_cache(tcache.KnobCache(path))  # a fresh process: new cache object, new registry
    rec = reg2.get_quarantine("gemm", "sfc_cuda", "64x64x64|float32")
    assert rec.reason == "compile" and "CUDA error 701" in rec.error
    assert reg2.export_state() == reg.export_state()


def test_malformed_health_entries_are_dropped():
    reg = HealthRegistry()
    reg.load_state({"bad": {"rung": "sfc_cuda"}, "worse": {"namespace": 3}, "ok": {
        "namespace": "gemm", "rung": "sfc_cuda", "shape": None, "reason": "oom"}})
    assert list(reg.export_state()) == ["ok"]


def test_a_confirmed_winner_lifts_the_quarantines(tmp_path, monkeypatch):
    """`tune_gemm`'s measured winner lifts its namespace's quarantines, and
    only its, and persists the lift (JAX: test_retune_lifts_ladder_quarantine,
    test_sdc_quarantine_cross_process_roundtrip_lifted_by_retune)."""
    cache = tcache.KnobCache(str(tmp_path / "knobs.json"))
    monkeypatch.setattr(ttuner, "_DEFAULT_CACHE", cache)
    reg = get_registry()
    reg.quarantine("gemm", "sfc_cuda", None, "compile")
    reg.quarantine("gemm", "replicated", "64x64x64|float32", "sdc")
    reg.quarantine("glu", "sfc_cuda", None, "compile")
    reg.save_to_cache(cache)
    ttuner.tune_gemm(64, 64, 64, torch.float32, measure_fn=lambda m, n, k, d, kn, op="gemm": 1e-3, device="cpu")
    assert reg.quarantined_namespaces() == ("glu",)
    fresh = HealthRegistry()
    fresh.load_from_cache(tcache.KnobCache(cache.path))
    assert fresh.quarantined_namespaces() == ("glu",)


# ---------------------------------------------------------------------------
# rung differentials against the JAX package, f32
# ---------------------------------------------------------------------------

_FORWARD_FAULTS = [(), ("sfc_cuda",), ("sfc_cuda", "replicated"), ("sfc_cuda", "replicated", "sfc_reference")]
_FORWARD_IDS = ["sfc_cuda", "replicated", "sfc_reference", "torch"]


def _served(pkg_registry, ns):
    return {_jax_rung(r): n for r, n in pkg_registry.degradation_report()["served"].get(ns, {}).items()}


@pytest.mark.parametrize("faulted", _FORWARD_FAULTS, ids=_FORWARD_IDS)
def test_matmul_rung_differential_f32(faulted):
    x, w, bias = _rand(16, 48, seed=1), _rand(48, 32, seed=2), _rand(32, seed=3) * 0.1
    with jrobust.fault_injection(*_specs("gemm", faulted, jax_side=True)), jgb.gemm_backend("sfc_pallas"):
        want = jgb.matmul(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(bias), activation="gelu")
    with fault_injection(*_specs("gemm", faulted)), tgb.gemm_backend("sfc_cuda"):
        got = tgb.matmul(_t(x), _t(w), bias=_t(bias), activation="gelu")
    _close(got, want)
    assert _served(get_registry(), "gemm") == {k: v for k, v in jrobust.get_registry().degradation_report()[
        "served"]["gemm"].items()} == {_jax_rung(_FORWARD_IDS[len(faulted)]): 1}


@pytest.mark.parametrize("faulted", _FORWARD_FAULTS, ids=_FORWARD_IDS)
def test_glu_matmul_rung_differential_f32(faulted):
    x, wg, wv = _rand(8, 32, seed=4), _rand(32, 24, seed=5), _rand(32, 24, seed=6)
    with jrobust.fault_injection(*_specs("glu", faulted, jax_side=True)), jgb.gemm_backend("sfc_pallas"):
        want = jgb.glu_matmul(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wv), activation="silu")
    with fault_injection(*_specs("glu", faulted)), tgb.gemm_backend("sfc_cuda"):
        got = tgb.glu_matmul(_t(x), _t(wg), _t(wv), activation="silu")
    _close(got, want)
    assert _served(get_registry(), "glu") == {_jax_rung(_FORWARD_IDS[len(faulted)]): 1}


@pytest.mark.parametrize("faulted", [(), ("sfc_cuda",), ("sfc_cuda", "sfc_reference")],
                         ids=["sfc_cuda", "sfc_reference", "torch"])
def test_grouped_matmul_rung_differential_f32(faulted):
    x, w = _rand(2, 4, 8, 16, seed=7), _rand(4, 16, 12, seed=8)  # (G, E, C, K), (E, K, N)
    with jrobust.fault_injection(*_specs("grouped", faulted, jax_side=True)), jgb.gemm_backend("sfc_pallas"):
        want = jgb.grouped_matmul(jnp.asarray(x), jnp.asarray(w))
    with fault_injection(*_specs("grouped", faulted)), tgb.gemm_backend("sfc_cuda"):
        got = tgb.grouped_matmul(_t(x), _t(w))
    _close(got, want)
    assert _served(get_registry(), "grouped") == _served(jrobust.get_registry(), "grouped")


@pytest.mark.parametrize("namespaces", [("nt", "tn"), ("nt",), ("tn",)])
def test_backward_ladder_differential_f32(namespaces):
    """Grads of an sfc_cuda projection survive NT / TN kernel faults, equal
    to JAX's grads under the same faults."""
    x, w = _rand(16, 48, seed=1), _rand(48, 32, seed=2)

    def jloss(x_, w_):
        with jgb.gemm_backend("sfc_pallas"):
            return jnp.sum(jgb.matmul(x_, w_, activation="gelu") ** 2)

    with jrobust.fault_injection(*[jrobust.FaultSpec(ns, kind="compile") for ns in namespaces]):
        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    with fault_injection(*[FaultSpec(ns, kind="compile") for ns in namespaces]), tgb.gemm_backend("sfc_cuda"):
        tgb.matmul(xt, wt, activation="gelu").square().sum().backward()
    _close(xt.grad, want[0], grad=True)
    _close(wt.grad, want[1], grad=True)
    assert set(namespaces) <= set(get_registry().quarantined_namespaces())
    assert get_registry().quarantined_namespaces() == jrobust.get_registry().quarantined_namespaces()


def test_grouped_backward_ladder_differential_f32():
    x, wg, wv = _rand(1, 4, 8, 16, seed=9), _rand(4, 16, 12, seed=10), _rand(4, 16, 12, seed=11)

    def jloss(x_, g_, v_):
        with jgb.gemm_backend("sfc_pallas"):
            return jnp.sum(jgb.grouped_glu_matmul(x_, g_, v_) ** 2)

    faults = ("grouped_nt", "grouped_tn")
    with jrobust.fault_injection(*[jrobust.FaultSpec(ns, kind="oom") for ns in faults]):
        want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wv))
    leaves = [_t(a).requires_grad_() for a in (x, wg, wv)]
    with fault_injection(*[FaultSpec(ns, kind="oom") for ns in faults]), tgb.gemm_backend("sfc_cuda"):
        tgb.grouped_glu_matmul(*leaves).square().sum().backward()
    for got, w_ in zip(leaves, want):
        _close(got.grad, w_, grad=True)
    assert set(get_registry().quarantined_namespaces()) == set(jrobust.get_registry().quarantined_namespaces()) \
        == set(faults)


def _qkv(seed, b=1, s=16, t=16, h=4, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]


def test_attention_forward_rung_differential_f32():
    q, k, v = _qkv(0, s=12, t=20)
    with jrobust.fault_injection(jrobust.FaultSpec("attn_fwd")):
        want = jab.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True, q_offset=8)
    with fault_injection(FaultSpec("attn_fwd")):
        got = tab.flash_attention(*map(_t, (q, k, v)), causal=True, q_offset=8)
    _close(got, want)
    assert _served(get_registry(), "attn_fwd") == _served(jrobust.get_registry(), "attn_fwd") == {"xla": 1}


def test_attention_backward_rung_differential_f32():
    q, k, v, do = *_qkv(1), _qkv(2)[0]

    def jloss(q_, k_, v_):
        return jnp.sum(jab.flash_attention(q_, k_, v_, causal=True) * jnp.asarray(do))

    with jrobust.fault_injection(jrobust.FaultSpec("attn_bwd")):
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    with fault_injection(FaultSpec("attn_bwd")):
        (tab.flash_attention(*leaves, causal=True) * _t(do)).sum().backward()
    for got, w_ in zip(leaves, want):
        _close(got.grad, w_, grad=True)
    assert _served(get_registry(), "attn_bwd") == _served(jrobust.get_registry(), "attn_bwd") == {"xla": 1}


def test_decode_attention_rung_differential_f32():
    q, k, v = _qkv(3, b=2, s=1, t=40)
    valid = np.array([17, 40], np.int32)
    with jrobust.fault_injection(jrobust.FaultSpec("attn_decode")):
        want = jab.decode_attention(*map(jnp.asarray, (q, k, v, valid)))
    with fault_injection(FaultSpec("attn_decode")):
        got = tab.decode_attention(*map(_t, (q, k, v)), torch.from_numpy(valid))
    _close(got, want)
    assert _served(get_registry(), "attn_decode") == _served(jrobust.get_registry(), "attn_decode") == {"xla": 1}


# ---------------------------------------------------------------------------
# the same ledger
# ---------------------------------------------------------------------------


def _scripted(pkg, gb, backend, arr):
    """One scripted sequence of faulted calls: a compile fault on gemm's
    kernel rung at one shape (then skipped there), a healthy call at
    another shape, an OOM on glu's second call, a transient flip under
    ABFT detect."""
    x16, x8, w = arr(_rand(16, 48, seed=1)), arr(_rand(8, 48, seed=2)), arr(_rand(48, 32, seed=3))
    wg, wv = arr(_rand(48, 24, seed=4)), arr(_rand(48, 24, seed=5))
    kernel = _jax_rung("sfc_cuda") if pkg is jrobust else "sfc_cuda"
    with gb.gemm_backend(backend):
        with pkg.fault_injection(pkg.FaultSpec("gemm", kind="compile", calls=(0,), rungs=(kernel,)),
                                 pkg.FaultSpec("glu", kind="oom", calls=(1,), rungs=(kernel,))):
            for x in (x16, x16, x8):
                gb.matmul(x, w)
            for _ in range(2):
                gb.glu_matmul(x8, wg, wv)
        abft_mod = jabft if pkg is jrobust else abft
        with abft_mod.abft_mode("detect"), pkg.fault_injection(
                pkg.FaultSpec("gemm", kind="bitflip", calls=(0,), fires=1, rungs=(kernel,))):
            gb.matmul(x8, w)
    return pkg.degradation_report()


def _mapped(rep):
    def rung(r):
        return {"sfc_pallas": "sfc_cuda", "xla": "torch"}.get(r, r)

    out = dict(rep)
    out["served"] = {ns: {rung(r): n for r, n in rungs.items()} for ns, rungs in rep["served"].items()}
    out["quarantined"] = [dict(q, rung=rung(q["rung"]), error=q["error"].replace("sfc_pallas", "sfc_cuda"))
                          for q in rep["quarantined"]]
    return out


def test_the_ledger_of_a_scripted_fault_sequence_is_jaxs():
    want = _mapped(_scripted(jrobust, jgb, "sfc_pallas", jnp.asarray))
    got = _scripted(robust, tgb, "sfc_cuda", _t)
    assert got == want
    assert got["fallback_calls"] == 3 and got["sdc"] == {"gemm": {"detected": 1, "healed": 1}}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_model():
    jcfg = j_get_config("qwen3_4b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("qwen3_4b").reduced()
    return jcfg, jparams, cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def test_serving_total_kernel_failure_serves_jaxs_tokens(shared_model):
    """Every kernel rung of every namespace faulted, attention "sfc": the
    port's engine serves the JAX engine's tokens under the same faults, on
    the torch rung, and reports what degraded."""
    jcfg, jparams, cfg, params = shared_model
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, size=8).astype(np.int32)
    jcfg, cfg = (dataclasses.replace(c, attn_impl="sfc") for c in (jcfg, cfg))
    with jrobust.fault_injection(jrobust.FaultSpec("*", kind="compile", rungs=("sfc_pallas", "replicated",
                                                                                "sfc_reference"))):
        jeng = JServingEngine(jcfg, jparams, max_batch=1, max_seq=16, gemm_backend="sfc_pallas")
        [want] = jeng.run(jeng.submit_many([prompt], max_new_tokens=4))
    with fault_injection(FaultSpec("*", kind="compile", rungs=("sfc_cuda", "replicated", "sfc_reference"))):
        eng = ServingEngine(cfg, params, max_batch=1, max_seq=16, gemm_backend="sfc_cuda", device="cpu")
        [got] = eng.run(eng.submit_many([prompt], max_new_tokens=4))
    assert got.status == want.status == "completed" and got.output == want.output
    rep = eng.degradation_report()
    assert rep["fallback_calls"] == rep["total_calls"] > 0
    assert {rung for rungs in rep["served"].values() for rung in rungs} == {"torch"}
    assert set(rep["served"]) == {"gemm", "glu", "attn_fwd", "attn_decode"}


def test_a_classified_failure_reaching_the_engine_quarantines_and_retries(shared_model):
    """`_run_healed`: a classified failure in a call the ladders do not
    cover quarantines the kernel rungs of every routed namespace (shape
    None) and retries once; a decode step of a model with recurrent state
    and no snapshot re-raises instead."""
    _, _, cfg, params = shared_model
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=16, gemm_backend="sfc_cuda", device="cpu")
    real, calls = eng._prefill, []

    def flaky(tokens):
        calls.append(1)
        if len(calls) == 1:
            raise KernelLaunchError("sfc_gemm_fused kernel", 701)
        return real(tokens)

    eng._prefill = flaky
    prompt = np.arange(8, dtype=np.int32)
    [done] = eng.run(eng.submit_many([prompt], max_new_tokens=2))
    assert done.status == "completed" and len(calls) == 2
    q = {(r["namespace"], r["rung"], r["shape"], r["reason"]) for r in eng.degradation_report()["quarantined"]}
    assert q == {(ns, rung, None, "compile") for ns in ("gemm", "glu", "grouped", "grouped_glu", "attn_fwd",
                                                         "attn_decode") for rung in ("sfc_cuda", "replicated")}
    def bug(tokens):
        raise ValueError("a plain bug")

    eng._prefill = bug
    with pytest.raises(ValueError, match="plain bug"):  # unclassified: propagates untouched
        eng._run_healed("_prefill", None)


def test_a_strict_engine_raises_instead_of_quarantining(shared_model, monkeypatch):
    """Where no degradation is allowed (the card by default; here the CPU
    under ``REPRO_STRICT=1``), a classified failure that reaches the engine
    raises `StrictFallbackError` and quarantines nothing; an injected one
    still quarantines and retries."""
    from repro_torch.robust.inject import InjectedCompileError

    monkeypatch.setenv("REPRO_STRICT", "1")
    _, _, cfg, params = shared_model
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=16, gemm_backend="sfc_cuda", device="cpu")
    real = eng._prefill
    for exc, raises in ((KernelLaunchError("sfc_gemm_fused kernel", 701), True),
                        (InjectedCompileError("gemm", "sfc_cuda", 0), False)):
        get_registry().reset()
        calls = []

        def flaky(tokens, exc=exc, calls=calls):
            calls.append(1)
            if len(calls) == 1:
                raise exc
            return real(tokens)

        eng._prefill = flaky
        tokens = torch.arange(8).long()[None]
        if raises:
            with pytest.raises(StrictFallbackError) as info:
                eng._run_healed("_prefill", tokens)
            assert info.value.__cause__ is exc and len(calls) == 1
            assert not eng.degradation_report()["quarantined"]
        else:
            eng._run_healed("_prefill", tokens)
            rep = eng.degradation_report()
            assert len(calls) == 2 and rep["quarantined"] and all(r["injected"] for r in rep["quarantined"])


def _state_leaves(cache):
    from repro_torch.serving.engine import _recurrent_state

    return [t.clone() for t in _recurrent_state(cache)]


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "xlstm_1_3b"])
def test_a_redone_verified_step_takes_the_recurrent_state_one_step(arch):
    """A detection in a verified decode step of the hybrid or the xLSTM (an
    injected one, recorded in the step's scope): the engine restores the
    recurrent state from the step's snapshot and redoes the step on the
    healed rungs, so every state leaf and the logits are bitwise what one
    step from the state before gives on those rungs, not two steps."""
    from repro_torch.serving.engine import _recurrent_state

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, model.state_dict(), max_batch=2, max_seq=24, gemm_backend="sfc_cuda", device="cpu",
                        verify_every=1)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))).long()
    _, cache = eng._prefill(tokens)
    token = tokens[:, -1:]
    before = [t.clone() for t in _recurrent_state(cache)]
    assert before  # the model keeps recurrent state
    real, hits = eng._decode, []

    def decode(tok, c):
        out = real(tok, c)
        if not hits:  # the first pass: a detection in the verified step's scope
            hits.append(1)
            assert abft.record_injected("gemm")
        return out

    eng._decode = decode
    logits, after = eng._verified_decode(token, cache)
    rep = eng.degradation_report()
    assert rep["verify"]["sdc_detections"] == 1 and rep["snapshot"]["count"] == 1
    assert rep["quarantined"] and all(r["injected"] for r in rep["quarantined"])  # the detection was injected
    redone = [t.clone() for t in _recurrent_state(after)]
    assert any(not torch.equal(a, b) for a, b in zip(redone, before))  # the step did advance the state
    for t, b in zip(_recurrent_state(cache), before):  # one step from the state before, on the same rungs
        t.copy_(b)
    want_logits, cache = real(token, cache)
    for got, want in zip(redone, _recurrent_state(cache)):
        assert torch.equal(got, want)
    assert torch.equal(logits, want_logits)


def test_a_detected_update_flush_is_not_retried_in_place(monkeypatch):
    """A detection raised by the fused optimizer's update flush, after it
    wrote W, master, mu and nu, goes up to the step: the flush ran once,
    and nothing was quarantined or applied twice.  The norm flush (phase 1
    of the clip), which writes nothing, is retried."""
    from repro_torch.launch.train import build_trainer

    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), n_layers=1)
    model, opt, step, batch_fn = build_trainer(cfg, batch=2, seq=8, seed=0, gemm_backend="sfc_cuda",
                                               fused_optimizer=True, device="cpu")
    real_update, real_norm = tops.sfc_matmul_tn_update, tops.sfc_matmul_tn_norm
    updates, norms = [], []

    def detected_update(*args, **kw):
        updates.append(1)
        real_update(*args, **kw)
        raise abft.SdcDetected("tn_update", 1.0, 0.1)

    def transient_norm(*args, **kw):
        norms.append(1)
        if len(norms) == 1:
            raise abft.SdcDetected("tn_update", 1.0, 0.1)
        return real_norm(*args, **kw)

    monkeypatch.setattr(tops, "sfc_matmul_tn_update", detected_update)
    monkeypatch.setattr(tops, "sfc_matmul_tn_norm", transient_norm)
    with pytest.raises(abft.SdcDetected):
        step(opt, batch_fn(0))
    assert len(updates) == 1 and len(norms) > 1
    rep = get_registry().degradation_report()
    assert not rep["quarantined"] and rep["sdc"]["tn_update"] == {"detected": 2, "healed": 1}


@pytest.mark.parametrize("exc", [torch.OutOfMemoryError("CUDA out of memory"), AssertionError("after the write")],
                         ids=["oom", "assert"])
def test_a_failure_after_the_update_flush_wrote_is_not_handed_to_the_oracle(monkeypatch, exc):
    """A classified failure raised after the fused update flush wrote W,
    master, mu and nu (an OOM summing its partials, an assertion) goes up
    to the step: the oracle, which would apply AdamW a second time, never
    runs, and nothing is quarantined."""
    from repro_torch.launch.train import build_trainer

    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), n_layers=1)
    model, opt, step, batch_fn = build_trainer(cfg, batch=2, seq=8, seed=0, gemm_backend="sfc_cuda",
                                               fused_optimizer=True, device="cpu")
    real_update, updates, oracle = tops.sfc_matmul_tn_update, [], []

    def failing_update(*args, **kw):
        updates.append(1)
        real_update(*args, **kw)
        raise exc

    monkeypatch.setattr(tops, "sfc_matmul_tn_update", failing_update)
    monkeypatch.setattr(tops, "plain_update", lambda *a, **k: oracle.append(1))
    with pytest.raises(type(exc)):
        step(opt, batch_fn(0))
    assert len(updates) == 1 and not oracle
    assert not get_registry().degradation_report()["quarantined"]


# ---------------------------------------------------------------------------
# obs.metrics
# ---------------------------------------------------------------------------


def test_metrics_registry_matches_jax():
    """The same writes give the same snapshot; the gate drops facade writes
    but not a private registry's (the health ledger's)."""
    snaps = []
    for m in (tmetrics, jmetrics):
        reg = m.Registry()
        reg.counter("c").inc(2, op="a")
        reg.counter("c").inc(op="b")
        reg.gauge("g").set(1.5, ns="x")
        for v in (1.0, 2.0, 3.0, 10.0):
            reg.histogram("h").observe(v, op="a")
        with pytest.raises(TypeError):
            reg.gauge("c")
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    tmetrics.reset()
    tmetrics.set_enabled(False)
    try:
        tmetrics.inc("x")
        assert tmetrics.require_series(["x"]) == ["x"]
        reg = HealthRegistry()
        reg.record_served("gemm", "sfc_cuda", degraded=False)
        assert reg.degradation_report()["total_calls"] == 1
    finally:
        tmetrics.set_enabled(None)
    tmetrics.inc("x")
    assert tmetrics.require_series(["x"]) == []
    tmetrics.reset()


def test_the_process_registry_counts_every_served_call():
    """The ledger's ``ladder.served`` is mirrored into the process registry
    (the series an exporter reads) for healthy and degraded calls alike, as
    JAX's `record_served` mirrors it, and ``ladder.fallback`` only for the
    degraded ones; with the gate shut, the ledger alone counts."""
    tmetrics.reset()
    reg = HealthRegistry()
    rungs = (("sfc_cuda", lambda: 1), ("torch", lambda: 2))
    for _ in range(3):
        run_with_fallback("gemm", rungs, registry=reg)
    with fault_injection(FaultSpec("gemm", kind="compile")):
        run_with_fallback("gemm", rungs, registry=reg)
    want = {(("namespace", "gemm"), ("rung", "sfc_cuda")): 3.0, (("namespace", "gemm"), ("rung", "torch")): 1.0}
    assert tmetrics.registry().counter("ladder.served").series() == reg._served.series() == want
    assert tmetrics.registry().counter("ladder.fallback").series() == {(("namespace", "gemm"),): 1.0}
    tmetrics.set_enabled(False)
    try:
        reg.reset()
        run_with_fallback("gemm", rungs, registry=reg)
    finally:
        tmetrics.set_enabled(None)
    assert reg.degradation_report()["served"] == {"gemm": {"sfc_cuda": 1}}
    assert tmetrics.registry().counter("ladder.served").series() == want
    tmetrics.reset()


def test_a_single_writer_counts_exactly_under_a_concurrent_reader():
    """The ladder's counts are written without a lock by one thread at a
    time (the model's thread, or autograd's device thread while it waits):
    a writer on another thread, as a backward runs, while a reader copies
    the series and snapshots the registry, loses no count and breaks no
    read."""
    import threading

    tmetrics.reset()
    reg, n = HealthRegistry(), 20000
    rungs = (("sfc_cuda", lambda: 1), ("torch", lambda: 2))

    def writer():
        for i in range(n):
            run_with_fallback(("gemm", "glu", "nt", "tn")[i % 4], rungs, registry=reg)

    thread = threading.Thread(target=writer)
    thread.start()
    reads = 0
    while thread.is_alive():
        reg.degradation_report()
        tmetrics.snapshot()
        reads += 1
    thread.join()
    want = {ns: {"sfc_cuda": n // 4} for ns in ("gemm", "glu", "nt", "tn")}
    assert reads > 0 and reg.degradation_report()["served"] == want
    assert sum(tmetrics.registry().counter("ladder.served").series().values()) == n
    tmetrics.reset()


@pytest.mark.parametrize("faulted", [(), ("sfc_cuda",), ("sfc_cuda", "replicated")],
                         ids=["sfc_cuda", "replicated", "torch"])
def test_chunk_einsum_rung_differential_f32(faulted):
    """The chunked recurrences' intra-chunk product degrades through JAX's
    rungs under its schedule-qualified namespace (``gemm@<key>``)."""
    a, b = _rand(2, 3, 16, 8, seed=12), _rand(2, 3, 16, 8, seed=13)  # SSD scores: C·Bᵀ per (batch, chunk)
    subs = "bcin,bcjn->bcij"
    with jrobust.fault_injection(*_specs("gemm@*", faulted, jax_side=True)), jgb.gemm_backend("sfc_pallas"):
        want = jgb.chunk_einsum(subs, jnp.asarray(a), jnp.asarray(b))
    with fault_injection(*_specs("gemm@*", faulted)), tgb.gemm_backend("sfc_cuda"):
        got = tgb.chunk_einsum(subs, _t(a), _t(b))
    _close(got, want)
    (ns,) = get_registry().degradation_report()["served"]
    assert ns.startswith("gemm@") and _served(get_registry(), ns) == _served(jrobust.get_registry(), ns)
