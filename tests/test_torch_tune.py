"""The port's tuner (`repro_torch.tune`) and knob resolution against the JAX
package's on the CPU: shape buckets and cache keys as strings, the
candidate lists, `tune_gemm` with one injected measurement (the same winner
and the same cache entries), the calibration fit on the same records,
`predict_candidate`, the corrupt-file quarantine and the stale-version
purge, `resolve_knobs` / `chunk_gemm_plan` / `resolve_attn_knobs` with and
without a cache entry, `tune_table` for reduced qwen3-4b and olmoe-1b-7b,
and a CPU `warmup(tune=True)` filling exactly its table's keys; and the
port's own parts: the resolvers' memo, the in-memory scratch cache and the
card's table, keyed by the rows a launch runs.  The card's cases are
`test_torch_tune_card.py`'s."""

import dataclasses
import importlib
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import attention_backend as jab  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.tune import cache as jcache  # noqa: E402
from repro.tune import tuner as jtuner  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import attention_backend as tab  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import tuner as ttuner  # noqa: E402

# the packages export the function `calibrate`, which hides the module's name
jcal = importlib.import_module("repro.tune.calibrate")
tcal = importlib.import_module("repro_torch.tune.calibrate")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Fresh default caches of both packages in ``tmp_path``: (port, JAX)."""
    port = tcache.KnobCache(str(tmp_path / "port.json"))
    jax_ = jcache.KnobCache(str(tmp_path / "jax.json"))
    monkeypatch.setattr(ttuner, "_DEFAULT_CACHE", port)
    monkeypatch.setattr(jtuner, "_DEFAULT_CACHE", jax_)
    return port, jax_


def knob_entries(path):
    """A cache file's knob entries (no stamps, no platform constants)."""
    with open(path) as f:
        raw = json.load(f)
    return {k: v for k, v in raw.items() if not k.startswith("__")}


def fake_measure(m, n, k, dtype, knobs, op="gemm"):
    """A deterministic score that tells every candidate apart."""
    return 1e-6 * (1 + ((knobs.bm * 7 + knobs.bn * 3 + knobs.k_layers * 11 + knobs.k_block_factor * 5
                         + len(op)) % 17))


SHAPES = [(1, 1, 1), (3, 5, 7), (128, 2560, 2560), (4, 151936, 2560), (24, 24, 16), (512, 9728, 2560),
          (129, 1000, 3000), (2560, 2560, 128)]


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_shape_buckets_and_keys_are_the_jax_strings(m, n, k):
    assert tcache.shape_bucket(m, n, k) == jcache.shape_bucket(m, n, k)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32), (np.float32, np.float32)):
        for backend in ("cpu", "gpu", "tpu"):
            for op in ("gemm", "glu", "tn_update_dual", "attn_decode", "gemm@abc123"):
                for device in ("", "cpu", "nvidia_h100_80gb_hbm3"):
                    assert (tcache.KnobCache.key(m, n, k, tdt, backend, op, device)
                            == jcache.KnobCache.key(m, n, k, jdt, backend, op, device))
    assert tcache.KnobCache.platform_key("gpu", "nvidia_h100_80gb_hbm3") == (
        "__platform__|repro_torch|gpu@nvidia_h100_80gb_hbm3")


@pytest.mark.parametrize("m,n,k", SHAPES + [(0, 5, 0)])
def test_backward_shape_keys_are_the_jax_strings(m, n, k):
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert tops.bwd_shape_key(m, n, k, tdt) == jops._bwd_shape_key(m, n, k, jdt)


def test_device_kinds_and_knob_records():
    assert tcache.detect_device_kind("cpu") == jcache.detect_device_kind() == "cpu"
    assert tcache.KnobCache(device="").device == "" and tcache.KnobCache().device == "cpu"
    kn = tcache.Knobs(bm=64, bn=128, k_layers=2, k_block_factor=4, source="measured", time_s=1.5e-5)
    assert kn.as_dict() == jcache.Knobs(64, 128, 2, 4, "measured", 1.5e-5).as_dict()
    assert tcache.Knobs.from_dict(kn.as_dict()) == dataclasses.replace(kn)
    card = dataclasses.replace(kn, launch={"wide": 1, "group": 2})
    assert card.as_dict()["launch"] == {"wide": 1, "group": 2}
    assert tcache.Knobs.from_dict(card.as_dict()).launch == {"wide": 1, "group": 2}
    assert tcache.dtype_name(torch.bfloat16) == "bfloat16" == tcache.dtype_name(jnp.bfloat16)


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_candidate_lists_are_the_jax_modules(m, n, k):
    for dtype_bytes in (2, 4):
        for cap in (3, 12, 40):
            got = ttuner.candidate_knobs(m, n, k, dtype_bytes=dtype_bytes, max_candidates=cap, device="cpu")
            want = jtuner.candidate_knobs(m, n, k, dtype_bytes=dtype_bytes, max_candidates=cap)
            assert [c.as_dict() for c in got] == [c.as_dict() for c in want]


@pytest.mark.parametrize("op", ["gemm", "glu", "nt_dual", "tn_update", "attn_fwd", "attn_decode"])
@pytest.mark.parametrize("strategy,confirm", [("predict", 2), ("predict", 0), ("exhaustive", 2)])
def test_tune_gemm_with_one_measurement_matches_jax(caches, op, strategy, confirm):
    port, jax_ = caches
    shapes = [(128, 256, 512), (64, 1024, 256)] if not op.startswith("attn") else [(128, 128, 64), (32, 145, 128)]
    treport, jreport = [], []
    for m, n, k in shapes:
        got = ttuner.tune_gemm(m, n, k, torch.float32, op=op, strategy=strategy, confirm_top=confirm,
                               measure_fn=fake_measure, report=treport, device="cpu")
        want = jtuner.tune_gemm(m, n, k, jnp.float32, op=op, strategy=strategy, confirm_top=confirm,
                                measure_fn=fake_measure, report=jreport)
        assert got.as_dict() == want.as_dict()
    assert treport == jreport
    assert knob_entries(port.path) == knob_entries(jax_.path)
    hit = ttuner.tune_gemm(*shapes[0], torch.float32, op=op, measure_fn=fake_measure, device="cpu")
    assert hit.source == "cached"


def test_a_failed_measurement_raises_and_caches_nothing(caches):
    port, _ = caches

    def broken(m, n, k, dtype, knobs, op="gemm"):
        raise RuntimeError("candidate failed to launch")

    with pytest.raises(RuntimeError, match="failed to launch"):
        ttuner.tune_gemm(128, 256, 512, torch.float32, measure_fn=broken, device="cpu")
    assert port.get(128, 256, 512, torch.float32, "cpu") is None
    with pytest.raises(ValueError, match="unknown tune namespace"):
        ttuner.tune_gemm(128, 256, 512, torch.float32, op="gemmm", device="cpu")


def jax_records(records):
    return [jcal.CalibrationRecord(**{**dataclasses.asdict(r), "knobs": jcache.Knobs(**{
        k: v for k, v in dataclasses.asdict(r.knobs).items() if k != "launch"})}) for r in records]


def test_calibration_sweep_and_fit_match_jax():
    def measure(m, n, k, dtype, knobs):
        return 2e-6 + 1.7 * jtuner._measure_simulated(m, n, k, dtype, jcache.Knobs(
            knobs.bm, knobs.bn, knobs.k_layers, knobs.k_block_factor)) + 1e-7 * knobs.k_block_factor

    got = tcal.calibration_sweep(measure_fn=measure, device="cpu")
    want = jcal.calibration_sweep(measure_fn=measure)
    assert [dataclasses.asdict(r) | {"knobs": None} for r in got] == [
        dataclasses.asdict(r) | {"knobs": None} for r in want]
    for recs in (got, got[::2], got[:3]):
        tfit = tcal.fit_constants(recs, backend="cpu", device_kind="cpu")
        jfit = jcal.fit_constants(jax_records(recs), backend="cpu", device_kind="cpu")
        for key, val in jfit.as_dict().items():
            if isinstance(val, float):
                assert np.isclose(tfit.as_dict()[key], val, rtol=1e-12, atol=0.0), key
            else:
                assert tfit.as_dict()[key] == val
    assert tcal.fit_constants([]).as_dict() == jcal.fit_constants([]).as_dict()
    constants = tcal.fit_constants(got, backend="cpu", device_kind="cpu")
    assert (dataclasses.asdict(tcal.calibrated_hardware(constants))
            == dataclasses.asdict(jcal.calibrated_hardware(jcal.PlatformConstants(**constants.as_dict()))))


def test_calibrate_persists_once_and_the_model_uses_it(caches):
    port, _ = caches
    calls = []

    def measure(m, n, k, dtype, knobs):
        calls.append((m, n, k))
        return 1e-5 + 1e-12 * m * n * k

    first = tcal.calibrate(measure_fn=measure, device="cpu")
    assert calls and first.n_samples == len(calls) and first.device_kind == "cpu"
    again = tcal.calibrate(measure_fn=measure, device="cpu")
    assert again == first and len(calls) == first.n_samples
    hw = tcal.resolve_hardware_model(device="cpu")
    assert hw.calibrated == "cpu" and hw.launch_overhead_s == first.launch_overhead_s
    assert "__platform__|repro_torch|cpu@cpu" in json.load(open(port.path))


@pytest.mark.parametrize("op", ["gemm", "glu", "nt", "tn_dual", "tn_update_dual", "attn_fwd", "attn_bwd",
                                "attn_decode"])
def test_predict_candidate_matches_jax(op):
    thw, jhw = tcal.calibrated_hardware(tcal.PlatformConstants(
        "cpu", "cpu", 1.4, 3e-6, 2e-7, 1e-12, 1e-13, 2e-13)), None
    jhw = jcal.calibrated_hardware(jcal.PlatformConstants("cpu", "cpu", 1.4, 3e-6, 2e-7, 1e-12, 1e-13, 2e-13))
    for m, n, k in [(128, 256, 512), (100, 700, 300), (32, 145, 128)]:
        for cand in jtuner.candidate_knobs(m, n, k, max_candidates=6):
            tk = tcache.Knobs(cand.bm, cand.bn, cand.k_layers, cand.k_block_factor)
            for dt in (np.float32, jnp.bfloat16):
                got = ttuner.predict_candidate(m, n, k, dt, tk, op=op, hw=thw)
                want = jtuner.predict_candidate(m, n, k, dt, cand, op=op, hw=jhw)
                assert np.isclose(got, want, rtol=1e-12, atol=0.0)
                assert ttuner.predict_candidate(m, n, k, dt, tk, op=op, hw=tcal.TPU_V5E) == \
                    jtuner.predict_candidate(m, n, k, dt, cand, op=op, hw=jcal.TPU_V5E)


def test_a_corrupt_cache_file_is_quarantined(tmp_path):
    path = tmp_path / "knobs.json"
    path.write_text("{not json")
    cache = tcache.KnobCache(str(path))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert cache.get(128, 128, 128, torch.float32, "cpu") is None
    assert not path.exists() and list(tmp_path.glob("knobs.json.corrupt-*"))
    cache.put(128, 128, 128, torch.float32, "cpu", tcache.Knobs(64, 64, 1, 1))
    assert tcache.KnobCache(str(path)).get(128, 128, 128, torch.float32, "cpu").bm == 64


def test_stale_entries_are_purged_by_this_packages_stamp_only(tmp_path):
    key = tcache.KnobCache.key(128, 128, 128, torch.float32, "cpu", device="cpu")
    entry = tcache.Knobs(64, 64, 1, 1, "measured", 1e-5).as_dict()
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({tcache.META_KEY: {"kernel_version": 999}, "__meta__": {"kernel_version": 7},
                                 key: entry}))
    with pytest.warns(RuntimeWarning, match="stale"):
        assert tcache.KnobCache(str(stale)).get(128, 128, 128, torch.float32, "cpu") is None
    # the JAX package's stamp, whatever its version, does not purge the port's entries
    shared = tmp_path / "shared.json"
    shared.write_text(json.dumps({"__meta__": {"kernel_version": 999}, key: entry}))
    cache = tcache.KnobCache(str(shared))
    assert cache.get(128, 128, 128, torch.float32, "cpu").bm == 64
    cache.put(256, 256, 256, torch.float32, "cpu", tcache.Knobs(128, 128, 1, 1))
    raw = json.load(open(shared))
    assert raw["__meta__"] == {"kernel_version": 999} and raw[tcache.META_KEY]["kernel_version"] == (
        tcache.current_kernel_version())
    assert len(cache) == 2


def test_stale_platform_constants_are_purged(tmp_path):
    cache = tcache.KnobCache(str(tmp_path / "k.json"))
    cache.put_platform("cpu", {"time_scale": 1.0, "launch_overhead_s": 0.0, "flush_overhead_s": 0.0,
                               "vmem_penalty": 0.0})
    assert cache.get_platform("cpu") is not None
    raw = json.load(open(cache.path))
    raw[cache.platform_key("cpu", "cpu")]["kernel_version"] = 999
    json.dump(raw, open(cache.path, "w"))
    fresh = tcache.KnobCache(cache.path)
    with pytest.warns(RuntimeWarning, match="purged"):
        assert fresh.get_platform("cpu") is None
    assert fresh.platform_key("cpu", "cpu") not in json.load(open(cache.path))
    assert not fresh.purge_platform("cpu")
    fresh.put_health({"gemm|sfc_cuda": {"reason": "sdc"}})
    assert fresh.get_health() == {"gemm|sfc_cuda": {"reason": "sdc"}}
    fresh.put_health({})
    assert fresh.get_health() == {}


RESOLVE = [(16, 16, 16), (128, 2560, 2560), (24, 24, 16), (3, 77, 203), (512, 64, 70000), (4, 151936, 2560)]


@pytest.mark.parametrize("m,n,k", RESOLVE)
def test_resolve_knobs_and_the_chunk_plan_match_jax_with_and_without_an_entry(caches, m, n, k):
    port, jax_ = caches
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for op in ("gemm", "glu", "nt", "tn_update"):
            assert tops.resolve_knobs(m, n, k, "cpu", dtype=tdt, op=op) == jops.resolve_knobs(m, n, k, jdt, op=op)
        assert tops.chunk_gemm_plan(m, n, k, tdt) == jops.chunk_gemm_plan(m, n, k, jdt)
    entry = dict(bm=32, bn=64, k_layers=2, k_block_factor=2, source="measured", time_s=1e-5)
    for op in ("gemm", "nt"):
        port.put(m, n, k, torch.float32, "cpu", tcache.Knobs(**entry), op)
        jax_.put(m, n, k, jnp.float32, "cpu", jcache.Knobs(**entry), op)
        got = tops.resolve_knobs(m, n, k, "cpu", dtype=torch.float32, op=op)
        assert got == jops.resolve_knobs(m, n, k, jnp.float32, op=op) == (32, 64, 2, 2)
        assert got.launch is None
        # explicit knobs and knob_defaults win over the entry
        assert tops.resolve_knobs(m, n, k, "cpu", bm=16, dtype=torch.float32, op=op)[0] == 16
        with tops.knob_defaults(k_layers=4):
            assert tops.resolve_knobs(m, n, k, "cpu", dtype=torch.float32, op=op)[2:] == (4, 2)
    assert tops.chunk_gemm_plan(m, n, k, torch.float32) == jops.chunk_gemm_plan(m, n, k, jnp.float32)
    assert tops.resolve_knobs(m, n, k, "cpu") == jops.resolve_knobs(m, n, k, jnp.float16)  # no dtype: no lookup


def test_the_chunk_plan_follows_a_k_layers_winner_as_jax(caches):
    port, jax_ = caches
    entry = dict(bm=8, bn=8, k_layers=2, k_block_factor=1, source="measured", time_s=1e-6)
    port.put(24, 24, 16, torch.float32, "cpu", tcache.Knobs(**entry))
    jax_.put(24, 24, 16, jnp.float32, "cpu", jcache.Knobs(**entry))
    got, want = tops.chunk_gemm_plan(24, 24, 16, torch.float32), jops.chunk_gemm_plan(24, 24, 16, jnp.float32)
    # the base winner's two K layers name the schedule; the knobs re-resolve under it (no entry there)
    assert got == want and got[1]["k_layers"] == 1
    assert got[0] != tops.chunk_gemm_plan(24, 24, 16, torch.bfloat16)[0]


@pytest.mark.parametrize("op", ["attn_fwd", "attn_bwd", "attn_decode"])
def test_resolve_attn_knobs_matches_jax_with_and_without_an_entry(caches, op):
    port, jax_ = caches
    for sq, sk, d in [(128, 128, 64), (40, 300, 16), (32, 145, 128)]:
        for hint in (None, 16, 64):
            assert tab.resolve_attn_knobs(sq, sk, d, torch.float32, op=op, q_chunk=hint, k_chunk=hint) == \
                jab.resolve_attn_knobs(sq, sk, d, jnp.float32, op=op, q_chunk=hint, k_chunk=hint)
        port.put(sq, sk, d, torch.float32, "cpu", tcache.Knobs(32, 16, 1, 1, "measured", 1e-6), op)
        jax_.put(sq, sk, d, jnp.float32, "cpu", jcache.Knobs(32, 16, 1, 1, "measured", 1e-6), op)
        got = tab.resolve_attn_knobs(sq, sk, d, torch.float32, op=op, q_chunk=128, k_chunk=128)
        assert got == jab.resolve_attn_knobs(sq, sk, d, jnp.float32, op=op, q_chunk=128, k_chunk=128)
        assert got.launch is None


def test_a_resolution_is_answered_once_until_the_cache_changes(caches, monkeypatch):
    port, _ = caches
    calls = []
    real = tops.lookup_knobs

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(tops, "lookup_knobs", counted)
    first = tops.resolve_knobs(128, 2560, 2560, "cpu", dtype=torch.bfloat16, op="glu")
    assert tops.resolve_knobs(128, 2560, 2560, "cpu", dtype=torch.bfloat16, op="glu") is first
    assert len(calls) == 1 and port.resolved[(128, 2560, 2560, torch.bfloat16, "glu", "cpu")] is first
    # another exact shape, type or namespace is another answer
    tops.resolve_knobs(127, 2560, 2560, "cpu", dtype=torch.bfloat16, op="glu")
    tops.resolve_knobs(128, 2560, 2560, "cpu", dtype=torch.float32, op="glu")
    assert len(calls) == 3
    # explicit knobs and knob_defaults are not memoised
    tops.resolve_knobs(128, 2560, 2560, "cpu", bm=16, dtype=torch.bfloat16, op="glu")
    with tops.knob_defaults(k_layers=2):
        assert tops.resolve_knobs(128, 2560, 2560, "cpu", dtype=torch.bfloat16, op="glu")[2] == 2
    assert len(calls) == 5 and len(port.resolved) == 3
    # a put empties the memo, and the next call sees the entry
    port.put(128, 2560, 2560, torch.bfloat16, "cpu", tcache.Knobs(32, 64, 2, 2, "measured", 1e-6), "glu")
    assert not port.resolved
    assert tops.resolve_knobs(128, 2560, 2560, "cpu", dtype=torch.bfloat16, op="glu") == (32, 64, 2, 2)
    got = tab.resolve_attn_knobs(128, 128, 64, torch.bfloat16, op="attn_fwd")
    assert tab.resolve_attn_knobs(128, 128, 64, torch.bfloat16, op="attn_fwd") is got
    port.put(128, 128, 64, torch.bfloat16, "cpu", tcache.Knobs(32, 16, 1, 1, "measured", 1e-6), "attn_fwd")
    assert tab.resolve_attn_knobs(128, 128, 64, torch.bfloat16, op="attn_fwd") == (32, 16)
    port.clear()
    assert not port.resolved and tab.resolve_attn_knobs(128, 128, 64, torch.bfloat16, op="attn_fwd") == got


def test_an_in_memory_cache_reads_and_writes_no_file(tmp_path):
    path = tmp_path / "knobs.json"
    path.write_text(json.dumps({"4x4x4|float32|cpu@cpu": {"bm": 8, "bn": 8, "k_layers": 1, "k_block_factor": 1}}))
    scratch = tcache.KnobCache(str(path), persist=False)
    assert scratch.get(4, 4, 4, torch.float32, "cpu") is None and len(scratch) == 0
    knobs = tcache.Knobs(8, 16, 1, 1, "measured", 1e-6, launch={"group": 2})
    scratch.put(5, 6, 7, torch.bfloat16, "gpu", knobs, "tn")
    assert scratch.get(8, 8, 8, torch.bfloat16, "gpu", "tn") == dataclasses.replace(knobs, source="cached")
    scratch.put_platform("cpu", {"gamma": 1.0})
    assert scratch.get_platform("cpu") == {"gamma": 1.0} and len(scratch) == 2
    assert json.loads(path.read_text()) == {"4x4x4|float32|cpu@cpu": {"bm": 8, "bn": 8, "k_layers": 1,
                                                                       "k_block_factor": 1}}
    scratch.clear()
    assert len(scratch) == 0 and path.exists()


def jax_table(cfg, prompt_len, max_batch, max_seq, **kw):
    """The JAX engine's `tune_table` on a stand-in engine (the table reads
    only the config and the engine's sizes)."""
    stub = types.SimpleNamespace(cfg=cfg, max_batch=max_batch, max_seq=max_seq)
    stub.projection_gemm_shapes = lambda p: jengine.ServingEngine.projection_gemm_shapes(stub, p)
    return jengine.ServingEngine.tune_table(stub, prompt_len, **kw)


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
@pytest.mark.parametrize("impl", ["blockwise", "sfc"])
def test_tune_table_matches_jax(arch, impl):
    from repro.configs import get_config as jget

    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl=impl)
    jcfg = dataclasses.replace(jget(arch).reduced(), attn_impl=impl)
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, model.state_dict(), max_batch=3, max_seq=40, gemm_backend="sfc_cuda", device="cpu")
    for kw in ({}, {"backward": True}, {"update": True}, {"backward": True, "update": True}):
        assert eng.tune_table(12, **kw) == jax_table(jcfg, 12, 3, 40, **kw)
    assert eng.projection_gemm_shapes(12) == jax_table(jcfg, 12, 3, 40)[:4]


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
def test_the_cards_table_keys_the_rows_a_launch_runs(arch):
    from repro.configs import get_config as jget

    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="sfc")
    jcfg = dataclasses.replace(jget(arch).reduced(), attn_impl="sfc")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, model.state_dict(), max_batch=3, max_seq=40, gemm_backend="sfc_cuda", device="cpu")
    eng.device = torch.device("cuda")  # the table reads only the device's type; nothing runs
    d, v = cfg.d_model, cfg.vocab
    # the serve: a shared weight's batch of 3 x 12 rows folds into one launch of 36
    want = jax_table(jcfg, 36, 3, 40)
    want = [row for row in want if row[0] != "attn_fwd"] + [("attn_fwd", 12, 12, cfg.head_dim_)]
    assert sorted(eng.tune_table(12)) == sorted(want)
    assert eng.projection_gemm_shapes(12)[0] == ("gemm", 36, d, d)
    assert eng.projection_gemm_shapes(12)[-1] == ("gemm", 3, v, d)  # the head: each sequence's last row
    # a training step runs the head at every row: its forward and backward buckets there
    got = eng.tune_table(12, backward=True, update=True)
    head = [row for row in got if v in row[1:]]
    assert head == [("gemm", 3, v, d), ("gemm", 36, v, d), ("nt", 36, d, v), ("tn", d, v, 36),
                    ("tn_update", d, v, 36)]
    rest = [row for row in got if v not in row[1:] and not row[0].startswith("attn")]
    assert rest == [row for row in jax_table(jcfg, 36, 3, 40, backward=True, update=True)
                    if v not in row[1:] and not row[0].startswith("attn")]
    assert [row for row in got if row[0].startswith("attn")] == [
        row for row in jax_table(jcfg, 12, 3, 40, backward=True, update=True) if row[0].startswith("attn")]


def test_a_cpu_warmup_tunes_exactly_its_table(caches):
    port, _ = caches
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), attn_impl="sfc")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, model.state_dict(), max_batch=2, max_seq=24, gemm_backend="sfc_cuda", device="cpu")
    stats = eng.warmup(8, tune=True, tune_update=True)
    table = eng.tune_table(8, backward=True, update=True)
    assert stats["n_namespaces"] == len(table) and stats["n_measured"] == len(stats["report"]) > 0
    assert stats["median_rel_err"] == 0.0  # the CPU measures with the model it predicts with
    want = {tcache.KnobCache.key(m, n, k, torch.float32, "cpu", op, "cpu") for op, m, n, k in table}
    assert set(knob_entries(port.path)) == want
    assert "__platform__|repro_torch|cpu@cpu" in json.load(open(port.path))
    assert eng.warmup(8, tune=True, tune_update=True)["n_measured"] == 0
    assert eng.warmup(8) is None
    assert ServingEngine(cfg, model.state_dict(), max_batch=2, max_seq=24, gemm_backend="torch",
                         device="cpu").warmup(8, tune=True) is None
