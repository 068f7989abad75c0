"""The port's telemetry (`repro_torch.obs`: spans, exporters, the drift
monitor, the structured log) and its instrumented paths (the fallback
ladder, ABFT, the knob cache, calibration and the tuner, the serving engine,
the train loop and its CLI) against the JAX package's (``repro.obs``) on the
CPU.

The same event sequence goes through both packages: the registries'
snapshots, the JSONL rows (span durations left out: they are wall times),
the Prometheus text and the CLI's exit codes must be equal; the drift
verdicts and medians on one seeded sequence, `latency_report` on the same
seeded requests and a dummy `TrainLoop`'s series and ``log.events`` kinds
equal too (histogram values exactly: both packages compute them with the
same numpy calls).  The port's reduced qwen3-4b engine must export every
series family the JAX package's end-to-end test requires, with its counts
held to the run's own.  Spans reach a torch profile as user annotations and
never enter ``record_function`` outside one.  The card's cases are
`test_torch_obs_card.py`'s."""

import importlib
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import robust as jrobust  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.robust import abft as jabft  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import fault_tolerance as jft  # noqa: E402
from repro.tune import cache as jcache  # noqa: E402
from repro.tune import tuner as jtuner  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import robust  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.robust import abft  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import fault_tolerance as tft  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import tuner as ttuner  # noqa: E402

jcal = importlib.import_module("repro.tune.calibrate")
tcal = importlib.import_module("repro_torch.tune.calibrate")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Fresh registries, drift monitors, ledgers and default knob caches in
    both packages around each test, the gate deferring to the environment
    (unset: on)."""
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.setattr(ttuner, "_DEFAULT_CACHE", tcache.KnobCache(str(tmp_path / "port_knobs.json")))
    monkeypatch.setattr(jtuner, "_DEFAULT_CACHE", jcache.KnobCache(str(tmp_path / "jax_knobs.json")))
    resets = (obs.reset_all, jobs.reset_all, robust.get_registry().reset, jrobust.get_registry().reset,
              abft.reset_runtime_sdc, jabft.reset_runtime_sdc)
    for reset in resets:
        reset()
    obs.set_enabled(None)
    jobs.set_enabled(None)
    yield
    for reset in resets:
        reset()
    obs.set_enabled(None)
    jobs.set_enabled(None)


def _feed(pkg):
    """One event sequence through a package's facade."""
    pkg.inc("tune.cache.hit", op="gemm", backend="cpu")
    pkg.inc("tune.cache.hit", 2, op="glu", backend="cpu")
    pkg.inc("ladder.served", namespace="gemm", rung="sfc")
    pkg.set_gauge("drift.median_rel_err", 0.25, namespace="gemm")
    pkg.set_gauge("drift.median_rel_err", 0.75, namespace="gemm")
    rng = np.random.default_rng(0)
    for v in rng.exponential(100.0, size=257):
        pkg.observe("serving.ttft_us", float(v))
    for v in rng.exponential(5.0, size=33):
        pkg.observe("serving.token_us", float(v), kind="decode")
    with pkg.span("serving/prefill", batch=4):
        pass
    with pytest.raises(ValueError):
        with pkg.span("train/step", step=1):
            raise ValueError("boom")


def _rows_without_span_times(rows):
    out = []
    for row in rows:
        if row["series"].startswith("span."):
            row = {k: v for k, v in row.items() if k in ("series", "type", "labels", "count")}
        out.append(row)
    return out


def test_facade_and_taxonomy_are_jaxs():
    assert set(obs.__all__) == set(jobs.__all__)
    assert obs.SPAN_NAMES == jobs.SPAN_NAMES


def test_the_same_events_give_the_same_snapshot_rows_and_prometheus_text(tmp_path):
    _feed(obs)
    _feed(jobs)
    tsnap, jsnap = obs.snapshot(), jobs.snapshot()
    for kind in ("counters", "gauges"):
        assert tsnap[kind] == jsnap[kind]
    assert set(tsnap["histograms"]) == set(jsnap["histograms"])
    for name, rows in jsnap["histograms"].items():
        if not name.startswith("span."):
            assert tsnap["histograms"][name] == rows
        else:
            assert [r["count"] for r in tsnap["histograms"][name]] == [r["count"] for r in rows] == [1]
    paths = {pkg: str(tmp_path / f"{name}.jsonl") for name, pkg in (("port", obs), ("jax", jobs))}
    assert obs.to_jsonl(paths[obs]) == jobs.to_jsonl(paths[jobs]) == 8
    assert (_rows_without_span_times(obs.read_jsonl(paths[obs]))
            == _rows_without_span_times(jobs.read_jsonl(paths[jobs])))
    assert texport.jsonl_series_names(paths[obs]) == jexport.jsonl_series_names(paths[jobs])
    for pkg in (obs, jobs):
        pkg.registry().reset()
        pkg.inc("tune.cache.hit", op="gemm", backend="cpu")
        pkg.set_gauge("tune.calibration_fit_err", 0.125, backend='c"pu')
        pkg.observe("span.ladder/run_us", 5.0)
        pkg.observe("serving.ttft_us", 7.0, kind="a")
        pkg.observe("serving.ttft_us", 9.0, kind="b")
    assert obs.to_prometheus().splitlines() == jobs.to_prometheus().splitlines()


def test_the_export_cli_exits_as_jaxs(tmp_path, capsys):
    obs.inc("ladder.served", namespace="gemm", rung="sfc_cuda")
    path = str(tmp_path / "t.jsonl")
    obs.to_jsonl(path)
    for argv in (["--check", path, "--require", "ladder.served"], ["--check", path, "--require", "absent"],
                 ["--check", path, "--list"], ["--check", path]):
        assert texport.main(argv) == jexport.main(argv)
    assert "absent" in capsys.readouterr().err
    for module in (texport, jexport):
        with pytest.raises(SystemExit) as exc:
            module.main([])
        assert exc.value.code == 2
    assert obs.missing_series(path, ["ladder.served", "nope"]) == jobs.missing_series(path, ["ladder.served",
                                                                                            "nope"]) == ["nope"]


def test_spans_record_on_exception_and_cost_no_clock_read_when_off(monkeypatch):
    with pytest.raises(RuntimeError):
        with obs.span("ladder/run"):
            raise RuntimeError("x")
    assert obs.registry().histogram("span.ladder/run_us").count() == 1
    obs.reset()

    class NoClock:
        @staticmethod
        def perf_counter():
            raise AssertionError("a clock read with the gate off")

    obs.set_enabled(False)
    monkeypatch.setattr(ttrace, "time", NoClock)
    with obs.span("serving/decode", step=1):
        pass
    x = torch.ones(2, 2)
    with tgb.gemm_backend("sfc_cuda"):
        tgb.matmul(x, x)
    assert obs.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert robust.degradation_report()["total_calls"] == 1  # the ledger itself never goes dark


def test_record_function_is_entered_only_under_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    real = torch.autograd.profiler.record_function

    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered outside a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    x = torch.ones(4, 8)
    w = torch.ones(8, 8)
    with obs.span("tune/calibrate", backend="cpu"):
        pass
    with tgb.gemm_backend("sfc_cuda"):
        tgb.matmul(x, w)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", real)
    before = robust.degradation_report()["total_calls"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("serving/decode", step=3):
            with tgb.gemm_backend("sfc_cuda"):
                tgb.matmul(x, w)
                tgb.matmul(x, w)
    calls = robust.degradation_report()["total_calls"] - before
    events = list(prof.profiler.kineto_results.events())
    ann = [e for e in events if e.is_user_annotation()]
    assert [e.name() for e in ann].count("ladder/run") == calls == 2
    (decode,) = [e for e in ann if e.name() == "serving/decode"]
    for e in ann:
        if e.name() == "ladder/run":
            assert decode.start_ns() <= e.start_ns() and e.end_ns() <= decode.end_ns()
    assert obs.registry().histogram("span.ladder/run_us").count() == 3


def test_the_ladder_span_counts_every_call_in_both_packages():
    for _ in range(3):
        robust.run_with_fallback("gemm", (("sfc_cuda", lambda: 1), ("torch", lambda: 2)))
        jrobust.run_with_fallback("gemm", (("sfc_pallas", lambda: 1), ("xla", lambda: 2)))
    for pkg, rung in ((obs, "sfc_cuda"), (jobs, "sfc_pallas")):
        assert pkg.registry().histogram("span.ladder/run_us").count() == 3
        assert pkg.registry().counter("ladder.served").value(namespace="gemm", rung=rung) == 3.0


def test_drift_verdicts_and_medians_are_jaxs():
    rng = np.random.default_rng(7)
    pairs = [(ns, float(p), float(p * m))
             for ns, p, m in zip(rng.choice(["gemm", "glu", "tn"], size=200), rng.uniform(1e-5, 1e-3, size=200),
                                 np.concatenate([rng.uniform(0.8, 1.2, 60), rng.uniform(0.1, 0.4, 80),
                                                 rng.uniform(0.9, 1.1, 60)]))]
    pairs += [("gemm", float("nan"), 1.0), ("glu", 1.0, 0.0), ("tn", None, 1.0)]
    mons = (obs.DriftMonitor(threshold=0.5, window=16, min_samples=5),
            jobs.DriftMonitor(threshold=0.5, window=16, min_samples=5))
    seen = ([], [])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for ns, p, m in pairs:
            for mon, log in zip(mons, seen):
                log.append((mon.observe(ns, p, m), mon.flagged()))
    assert seen[0] == seen[1]
    assert any(flagged for _, flagged in seen[0])
    assert mons[0].report() == mons[1].report()
    for ns in ("gemm", "glu", "tn"):
        assert mons[0].median_error(ns) == mons[1].median_error(ns)
    for kind in ("counters", "gauges"):
        assert obs.snapshot()[kind] == jobs.snapshot()[kind]


def test_invalidate_calibration_purges_the_cards_constants_not_the_cpus(tmp_path):
    cache = tcache.KnobCache(str(tmp_path / "k.json"), device="nvidia_h100_80gb_hbm3")
    constants = {"time_scale": 1.5, "launch_overhead_s": 6e-6, "flush_overhead_s": 0.0, "vmem_penalty": 0.0}
    for backend in ("gpu", "cpu"):
        cache.put_platform(backend, constants)
    mon = obs.DriftMonitor(min_samples=1)
    assert not mon.invalidate_calibration(cache)  # nothing flagged: nothing purged
    with pytest.warns(RuntimeWarning, match="perf drift"):
        mon.observe("gemm", predicted_s=10.0, measured_s=1.0)
    assert mon.invalidate_calibration(cache)
    assert cache.get_platform("gpu") is None and cache.get_platform("cpu") is not None
    assert mon.flagged() == ()
    counters = obs.snapshot()["counters"]
    assert counters["drift.calibration_purged"] == [{"labels": {"backend": "gpu"}, "value": 1.0}]
    assert counters["tune.cache.platform_purge"] == [{"labels": {"backend": "gpu"}, "value": 1.0}]


def test_a_miscalibrated_constant_flags_in_both_packages(tmp_path):
    """The JAX package's acceptance case on both tuners (the CPU's
    simulated measurement): a 300x derate flags "gemm" and the same
    samples and medians land in both registries."""
    fields = dict(time_scale=300.0, launch_overhead_s=0.0, flush_overhead_s=0.0, vmem_penalty=0.0,
                  n_samples=8, median_abs_rel_err=0.01)
    tc = tcache.KnobCache(str(tmp_path / "port.json"))
    jc = jcache.KnobCache(str(tmp_path / "jax.json"))
    tc.put_platform("cpu", tcal.PlatformConstants(device_kind=tc.device, backend="cpu", **fields).as_dict())
    jc.put_platform("cpu", jcal.PlatformConstants(device_kind=jc.device, backend="cpu", **fields).as_dict())
    with pytest.warns(RuntimeWarning, match="perf drift"):
        for shape in ((256, 256, 256), (512, 256, 128), (128, 512, 512)):
            ttuner.tune_gemm(*shape, np.float32, cache=tc, measure_fn=ttuner._measure_simulated, device="cpu")
    with pytest.warns(RuntimeWarning, match="perf drift"):
        for shape in ((256, 256, 256), (512, 256, 128), (128, 512, 512)):
            jtuner.tune_gemm(*shape, np.float32, cache=jc, measure_fn=jtuner._measure_simulated)
    assert obs.get_monitor().flagged() == jobs.get_monitor().flagged() == ("gemm",)
    assert obs.get_monitor().report() == jobs.get_monitor().report()
    tsnap, jsnap = obs.snapshot(), jobs.snapshot()
    for name in ("drift.samples", "drift.flagged", "tune.sweep", "tune.cache.miss"):
        assert tsnap["counters"][name] == jsnap["counters"][name], name
    assert tsnap["gauges"]["drift.median_rel_err"] == jsnap["gauges"]["drift.median_rel_err"]
    assert [r["count"] for r in tsnap["histograms"]["span.tune/tune_gemm_us"]] == [3]
    assert obs.get_monitor().invalidate_calibration(tc, backend="cpu")
    assert tc.get_platform("cpu") is None


def test_calibration_and_the_quarantine_lift_count_as_jaxs(tmp_path, capsys):
    def measure(m, n, k, dtype, knobs):
        return 1e-5 + 1e-12 * m * n * k

    tc = tcache.KnobCache(str(tmp_path / "port.json"))
    jc = jcache.KnobCache(str(tmp_path / "jax.json"))
    tfit = tcal.calibrate(tc, measure_fn=measure, device="cpu")
    jfit = jcal.calibrate(jc, measure_fn=measure)
    tcal.calibrate(tc, measure_fn=measure, device="cpu")  # persisted: no second fit
    tsnap, jsnap = obs.snapshot(), jobs.snapshot()
    assert tsnap["counters"]["tune.calibrations"] == jsnap["counters"]["tune.calibrations"] == [
        {"labels": {"backend": "cpu"}, "value": 1.0}]
    (tgauge,), (jgauge,) = tsnap["gauges"]["tune.calibration_fit_err"], jsnap["gauges"]["tune.calibration_fit_err"]
    assert tgauge["value"] == tfit.median_abs_rel_err and jgauge["value"] == jfit.median_abs_rel_err
    assert np.isclose(tgauge["value"], jgauge["value"], rtol=1e-9, atol=1e-12)
    assert [r["count"] for r in tsnap["histograms"]["span.tune/calibrate_us"]] == [1]
    for reg, rung in ((robust.get_registry(), "sfc_cuda"), (jrobust.get_registry(), "sfc_pallas")):
        reg.quarantine("gemm", rung, None, "compile")
        reg.quarantine("gemm", rung, "4x64", "compile")
    ttuner.tune_gemm(64, 64, 64, np.float32, cache=tc, measure_fn=ttuner._measure_simulated, device="cpu")
    jtuner.tune_gemm(64, 64, 64, np.float32, cache=jc, measure_fn=jtuner._measure_simulated)
    assert obs.snapshot()["counters"]["tune.quarantine_lifted"] == jobs.snapshot()["counters"][
        "tune.quarantine_lifted"] == [{"labels": {"op": "gemm"}, "value": 2.0}]


def test_knob_cache_counters_are_jaxs(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    for d in ("p", "j"):
        (tmp_path / d / "bad.json").write_text("{not json")
    key = tcache.KnobCache.key(64, 64, 64, np.float32, "cpu", device="cpu")
    entry = tcache.Knobs(32, 32, 1, 1).as_dict()
    (tmp_path / "p" / "stale.json").write_text(json.dumps({tcache.META_KEY: {"kernel_version": 999}, key: entry}))
    (tmp_path / "j" / "stale.json").write_text(json.dumps({"__meta__": {"kernel_version": 999}, key: entry}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for pkg_cache, d in ((tcache, "p"), (jcache, "j")):
            for name in ("bad.json", "stale.json"):
                c = pkg_cache.KnobCache(str(tmp_path / d / name))
                c.get(64, 64, 64, np.float32, "cpu")  # a miss
            c = pkg_cache.KnobCache(str(tmp_path / d / "k.json"))
            c.put(64, 64, 64, np.float32, "cpu", pkg_cache.Knobs(32, 32, 1, 1))
            c.get(64, 64, 64, np.float32, "cpu")  # a hit
            c.get(64, 64, 64, np.float32, "cpu", op="glu")  # a miss
            c.put_platform("cpu", {"time_scale": 1.0, "launch_overhead_s": 0.0, "flush_overhead_s": 0.0,
                                   "vmem_penalty": 0.0})
            assert c.purge_platform("cpu") and not c.purge_platform("cpu")
    tsnap, jsnap = obs.snapshot()["counters"], jobs.snapshot()["counters"]
    for name in ("tune.cache.hit", "tune.cache.miss", "tune.cache.platform_purge"):
        assert tsnap[name] == jsnap[name], name
    for name in ("tune.cache.corrupt", "tune.cache.stale_purge"):
        assert [r["value"] for r in tsnap[name]] == [r["value"] for r in jsnap[name]] == [1.0], name


def test_abft_checks_and_detections_count_as_jaxs():
    ones = torch.ones(4, 4)
    for ok in (True, False):
        ref = 16.0 if ok else 20.0
        if ok:
            abft.verify("gemm", ones, torch.tensor(16.0), torch.tensor(ref), torch.tensor(16.0), contract_dim=4,
                        mode="detect")
            jabft.verify("gemm", jnp.ones((4, 4)), jnp.asarray(16.0), jnp.asarray(ref), jnp.asarray(16.0),
                         contract_dim=4, mode="detect")
        else:
            with pytest.raises(abft.SdcDetected):
                abft.verify("gemm", ones, torch.tensor(16.0), torch.tensor(ref), torch.tensor(16.0),
                            contract_dim=4, mode="detect")
            with pytest.raises(jabft.SdcDetected):
                jabft.verify("gemm", jnp.ones((4, 4)), jnp.asarray(16.0), jnp.asarray(ref), jnp.asarray(16.0),
                             contract_dim=4, mode="detect")
    abft.verify("gemm", ones, torch.tensor(1.0), torch.tensor(9.0), torch.tensor(1.0), contract_dim=4, mode="off")
    tsnap, jsnap = obs.snapshot(), jobs.snapshot()
    for name in ("abft.checks", "abft.sdc"):
        assert tsnap["counters"][name] == jsnap["counters"][name], name
    assert [r["count"] for r in tsnap["histograms"]["span.abft/verify_us"]] == [2]


def test_a_step_scope_counts_its_detections_at_the_exit_with_no_host_read_a_check(monkeypatch):
    reads = []
    for name in ("tolist", "item", "__bool__", "__float__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    out = torch.ones(4, 4)
    with abft.step_scope() as scope:
        for ns, chk in (("gemm", 16.0), ("gemm", 30.0), ("glu", 16.0), ("glu", 40.0), ("glu", 50.0)):
            abft.verify(ns, out, torch.tensor(chk), torch.tensor(16.0), torch.tensor(16.0), contract_dim=4,
                        mode="detect")
        assert reads == [] and "abft.sdc" not in obs.snapshot()["counters"]
    assert reads == ["tolist"]
    assert scope.detections == {"gemm": 1, "glu": 2}
    counters = obs.snapshot()["counters"]
    assert counters["abft.checks"] == [{"labels": {"mode": "detect", "namespace": "gemm"}, "value": 2.0},
                                       {"labels": {"mode": "detect", "namespace": "glu"}, "value": 3.0}]
    assert counters["abft.sdc"] == [{"labels": {"mode": "detect", "namespace": "gemm"}, "value": 1.0},
                                    {"labels": {"mode": "detect", "namespace": "glu"}, "value": 2.0}]
    assert counters["abft.runtime_sdc"] == [{"labels": {"namespace": "gemm"}, "value": 1.0},
                                            {"labels": {"namespace": "glu"}, "value": 2.0}]
    assert abft.runtime_check_total() == 5 and abft.runtime_sdc_total() == 3


def test_structured_log_counts_by_kind_as_jaxs():
    for pkg in (obs, jobs):
        lines = []
        log = pkg.as_structured(lines.append)
        log.event("ft.rollback", "[ft] oops: rolled back 5 -> 3", step=5)
        log.event("ft.rollback", "[ft] again", step=6)
        log("plain line")
        verbose = pkg.StructuredLog(lines.append, verbose_fields=True)
        verbose.event("ft.resume", "[ft] resumed", step=4, lr=0.5)
        assert lines == ["[ft] oops: rolled back 5 -> 3", "[ft] again", "plain line", "[ft] resumed lr=0.5 step=4"]
        assert pkg.as_structured(log) is log
    assert obs.snapshot()["counters"]["log.events"] == jobs.snapshot()["counters"]["log.events"]


def _seeded_requests(cls, seed):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(9):
        r = cls(uid=uid, prompt=np.zeros(4, np.int32), max_new_tokens=6)
        r.submitted_at = float(rng.uniform(0.0, 1.0))
        n = int(rng.integers(0, 7))
        if uid == 3:  # shed before serving
            r.status, r.output, r.done_at = "timed_out", [], r.submitted_at + 0.5
        else:
            r.first_token_at = r.submitted_at + float(rng.uniform(0.01, 0.2))
            r.done_at = r.first_token_at + float(rng.uniform(0.0, 0.5))
            r.output = list(range(n))
            r.status = "timed_out" if uid == 5 else "completed"
        out.append(r)
    return out


def test_latency_report_and_the_retired_series_are_jaxs():
    for seed in (0, 1):
        treqs, jreqs = _seeded_requests(Request, seed), _seeded_requests(JRequest, seed)
        assert ServingEngine.latency_report(treqs) == JServingEngine.latency_report(jreqs)
        for r in treqs:
            ServingEngine._record_retired(r)
        for r in jreqs:
            JServingEngine._record_retired(r)
    assert ServingEngine.latency_report([]) == JServingEngine.latency_report([])
    assert obs.snapshot() == jobs.snapshot()


def _dummy_loop_series(ft, ckpt_mod, tmp_path):
    """The JAX package's dummy TrainLoop scenario: a nonfinite loss at the
    second step, a recovery, a [train] line every 2 steps."""

    def train_step(params, opt_state, batch, lr_scale=1.0):
        loss = float("inf") if batch["step"] == 1 else 1.0 / (1 + batch["step"])
        return params, opt_state, {"loss": loss}

    logs = []
    loop = ft.TrainLoop(train_step=train_step, batch_fn=lambda step: {"step": step},
                        ckpt=ckpt_mod.CheckpointManager(str(tmp_path), interval=100),
                        corruption_policy=ft.CorruptionPolicy(skip_steps=2, rollback_on_sdc=False))
    loop.run({}, {}, num_steps=5, resume=False, log_every=2, logger=logs.append)
    return logs


def test_a_dummy_train_loop_emits_jaxs_series_and_events(tmp_path):
    tlogs = _dummy_loop_series(tft, tckpt, tmp_path / "port")
    jlogs = _dummy_loop_series(jft, jckpt, tmp_path / "jax")
    assert tlogs == [line for line in jlogs]
    assert any("nonfinite loss at step 2" in line for line in tlogs)
    tsnap, jsnap = obs.snapshot(), jobs.snapshot()
    for kind in ("counters", "gauges"):
        assert tsnap[kind] == jsnap[kind], kind
    assert {r["labels"]["kind"]: r["value"] for r in tsnap["counters"]["log.events"]} == {
        "ft.nonfinite": 1.0, "ft.recovered": 1.0, "train.step": 2.0}
    assert set(tsnap["histograms"]) == set(jsnap["histograms"]) == {
        "span.train/batch_us", "span.train/step_us", "span.train/checkpoint_us", "train.step_us"}
    for name, rows in jsnap["histograms"].items():
        assert [r["count"] for r in tsnap["histograms"][name]] == [r["count"] for r in rows], name


def test_the_train_cli_writes_its_telemetry(tmp_path, capsys):
    from repro_torch.launch import train as ttrain

    path = str(tmp_path / "telemetry.jsonl")
    ttrain.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--backend", "sfc_cuda", "--steps", "2",
                 "--batch", "1", "--seq", "8", "--obs-export", path])
    assert f"series to {path}" in capsys.readouterr().out
    assert texport.main(["--check", path, "--require", "train.steps", "--require", "span.train/step_us",
                         "--require", "span.ladder/run_us", "--require", "ladder.served"]) == 0
    rows = {r["series"]: r for r in obs.read_jsonl(path)}
    assert rows["train.steps"]["value"] == 2.0


def test_the_reduced_engine_exports_every_series_family(tmp_path):
    """The JAX package's end-to-end families on the port's reduced qwen3-4b
    engine (sfc_cuda, every decode step verified), plus a dummy TrainLoop
    and tune-cache traffic; the counts the run itself knows held exactly."""
    cfg = get_config("qwen3_4b").reduced()
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=24, gemm_backend="sfc_cuda", device="cpu",
                        verify_every=1)
    prompts = [np.arange(6, dtype=np.int32) + i for i in range(3)]
    obs.reset_all()
    calls0 = robust.degradation_report()["total_calls"]
    done = eng.run(eng.submit_many(prompts, max_new_tokens=4))
    calls = robust.degradation_report()["total_calls"] - calls0
    snap = obs.snapshot()
    counter = {name: sum(r["value"] for r in rows) for name, rows in snap["counters"].items()}
    hist = {name: sum(r["count"] for r in rows) for name, rows in snap["histograms"].items()}
    assert counter["serving.requests"] == 3 and counter["serving.completed"] == len(done) == 3
    assert counter["serving.tokens"] == sum(len(r.output) for r in done) == 12
    assert hist["span.serving/decode_us"] == eng.degradation_report()["verify"]["decode_steps"] == 6
    assert hist["span.serving/prefill_us"] == hist["span.serving/retire_us"] == 2
    assert hist["serving.ttft_us"] == hist["serving.e2e_us"] == hist["serving.token_us"] == 3
    assert counter["abft.checks"] == abft.runtime_check_total() > 0
    assert counter["ladder.served"] == hist["span.ladder/run_us"] == calls > 0
    assert "abft.sdc" not in counter and "serving.sdc_redo" not in counter

    cache = tcache.KnobCache(str(tmp_path / "k.json"))
    cache.get(64, 64, 64, np.float32, "cpu")
    cache.put(64, 64, 64, np.float32, "cpu", tcache.Knobs(32, 32, 1, 1))
    cache.get(64, 64, 64, np.float32, "cpu")
    tft.TrainLoop(train_step=lambda p, o, b: (p, o, {"loss": 0.5}), batch_fn=lambda step: {},
                  ckpt=tckpt.CheckpointManager(str(tmp_path / "ckpt"), interval=100)).run(
        {}, {}, num_steps=3, resume=False, logger=lambda _line: None)
    path = str(tmp_path / "telemetry.jsonl")
    obs.to_jsonl(path)
    assert obs.missing_series(path, [
        "tune.cache.miss", "tune.cache.hit", "ladder.served", "abft.checks", "serving.ttft_us",
        "serving.completed", "serving.tokens", "train.steps", "train.step_us", "span.train/step_us",
        "span.serving/prefill_us", "span.serving/decode_us", "span.serving/admission_us", "span.ladder/run_us",
        "span.abft/verify_us", "span.train/checkpoint_us"]) == []
    spans = {row["series"][len("span."):-len("_us")] for row in obs.read_jsonl(path)
             if row["series"].startswith("span.")}
    assert spans <= set(obs.SPAN_NAMES)
    for line in open(path):
        assert {"series", "type", "labels"} <= set(json.loads(line))


def test_a_detection_in_a_verified_step_counts_its_redo():
    """An injected detection recorded in the first verified step's scope:
    the engine redoes the step (``serving.sdc_redo``) and the scope's exit
    counts ``abft.runtime_sdc``, as the JAX engine's runtime channel does."""
    cfg = get_config("qwen3_4b").reduced()
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=16, gemm_backend="sfc_cuda", device="cpu",
                        verify_every=1)
    real, hits = eng._decode, []

    def decode(tok, c):
        out = real(tok, c)
        if not hits:
            hits.append(1)
            assert abft.record_injected("gemm")
        return out

    eng._decode = decode
    done = eng.run(eng.submit_many([np.arange(5, dtype=np.int32)], max_new_tokens=3))
    assert done[0].status == "completed" and len(done[0].output) == 3
    counters = obs.snapshot()["counters"]
    assert counters["serving.sdc_redo"] == [{"labels": {}, "value": 1.0}]
    assert counters["abft.runtime_sdc"] == [{"labels": {"namespace": "gemm"}, "value": 1.0}]
    assert "abft.sdc" not in counters  # an injected detection is no checksum mismatch
