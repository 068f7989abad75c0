"""The port's ServingEngine and serve CLI against the JAX package's engine:
identical greedy tokens, the same latency-report keys, the same deadline
semantics; and the port's entry points default to the card."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


@pytest.fixture(scope="module")
def shared_model():
    jcfg = j_get_config("qwen3_4b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("qwen3_4b").reduced()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(seed, n, length, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=length).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_served(shared_model):
    """The JAX engine's greedy outputs for 5 requests (two prompt lengths,
    max_batch 2, so grouping and slot refill are both exercised)."""
    jcfg, jparams, _, _ = shared_model
    prompts = _prompts(0, 3, 10, jcfg.vocab) + _prompts(1, 2, 7, jcfg.vocab)
    engine = JServingEngine(jcfg, jparams, max_batch=2, max_seq=24, gemm_backend="xla")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=5))
    return prompts, {tuple(r.prompt.tolist()): r.output for r in done}, engine.latency_report(done)


@pytest.mark.parametrize("backend", ["sfc_cuda", "torch", "sfc_reference"])
def test_engine_greedy_tokens_match_jax(shared_model, jax_served, backend):
    _, _, cfg, params = shared_model
    prompts, want, want_report = jax_served
    engine = ServingEngine(cfg, params, max_batch=2, max_seq=24, gemm_backend=backend, device="cpu")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=5))
    assert len(done) == len(prompts)
    for r in done:
        assert r.status == "completed"
        assert r.output == want[tuple(r.prompt.tolist())]
        assert r.done_at >= r.first_token_at >= r.submitted_at
    report = engine.latency_report(done)
    assert set(report) == set(want_report)
    assert report["tokens_total"] == want_report["tokens_total"] == 25
    assert report["n_timed_out"] == 0 and report["tokens_per_s"] > 0


def test_engine_matches_jax_on_pallas_backend(shared_model):
    """One request through the JAX engine's sfc_pallas path (interpreted
    Pallas) and the port's sfc_cuda path (plain version on the CPU)."""
    jcfg, jparams, cfg, params = shared_model
    [prompt] = _prompts(2, 1, 8, jcfg.vocab)
    jengine = JServingEngine(jcfg, jparams, max_batch=1, max_seq=16, gemm_backend="sfc_pallas")
    [want] = jengine.run(jengine.submit_many([prompt], max_new_tokens=4))
    engine = ServingEngine(cfg, params, max_batch=1, max_seq=16, gemm_backend="sfc_cuda", device="cpu")
    [got] = engine.run(engine.submit_many([prompt], max_new_tokens=4))
    assert got.output == want.output


@pytest.mark.parametrize("impl", ["sfc", "flash_pallas"])
def test_engine_attn_impl_tokens_match_jax(shared_model, impl):
    """The JAX engine and the port's, both with the config's attn_impl set
    (prefill on K11 / K15, decode on K14 / plain), give the same greedy
    tokens for requests of two prompt lengths."""
    jcfg, jparams, cfg, params = shared_model
    prompts = _prompts(5, 2, 9, jcfg.vocab) + _prompts(6, 1, 6, jcfg.vocab)
    jengine = JServingEngine(dataclasses.replace(jcfg, attn_impl=impl), jparams, max_batch=2, max_seq=16)
    want = {tuple(r.prompt.tolist()): r.output for r in jengine.run(jengine.submit_many(prompts, max_new_tokens=4))}
    engine = ServingEngine(dataclasses.replace(cfg, attn_impl=impl), params, max_batch=2, max_seq=16,
                           gemm_backend="sfc_cuda", device="cpu")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=4))
    assert [r.status for r in done] == ["completed"] * 3
    for r in done:
        assert r.output == want[tuple(r.prompt.tolist())]


def test_deadline_sheds_waiting_and_retires_live(shared_model):
    _, _, cfg, params = shared_model
    engine = ServingEngine(cfg, params, max_batch=2, max_seq=32, device="cpu")
    reqs = engine.submit_many(_prompts(3, 3, 8, cfg.vocab), max_new_tokens=4, deadline_s=60.0)
    reqs[1].submitted_at -= 120.0  # already past its budget when run() starts
    done = engine.run(reqs)
    by_uid = {r.uid: r for r in done}
    shed = by_uid[reqs[1].uid]
    assert shed.status == "timed_out" and shed.output == [] and shed.first_token_at == 0.0
    for r in (by_uid[reqs[0].uid], by_uid[reqs[2].uid]):
        assert r.status == "completed" and len(r.output) == 4
    rep = engine.latency_report(done)
    assert (rep["n_requests"], rep["n_timed_out"], rep["tokens_total"]) == (3, 1, 8)

    [req] = engine.submit_many(_prompts(4, 1, 8, cfg.vocab), max_new_tokens=16)
    orig = engine._decode

    def slow_decode(*args):
        req.submitted_at -= 1.0  # burn the budget during serving
        return orig(*args)

    engine._decode = slow_decode
    req.deadline_s = 0.5
    [late] = engine.run([req])
    assert late.status == "timed_out" and 1 <= len(late.output) < 16


def test_latency_report_empty_is_zeros_with_jax_keys(shared_model, jax_served):
    rep = ServingEngine.latency_report([])
    assert set(rep) == set(jax_served[2])
    assert all(v == 0 for v in rep.values())


def test_engine_and_cli_default_to_the_card(shared_model, monkeypatch):
    _, _, cfg, params = shared_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", "qwen3-4b", "--reduced"])
    with pytest.raises(ValueError):
        ServingEngine(cfg, params, gemm_backend="xla", device="cpu")


def test_serve_cli_runs_on_cpu(capsys):
    rep = serve_cli.main(["--arch", "qwen3-4b", "--reduced", "--requests", "3", "--prompt-len", "6",
                          "--max-new", "3", "--backend", "sfc_cuda", "--device", "cpu"])
    assert rep["n_requests"] == 3 and rep["tokens_total"] == 9
    assert "backend=sfc_cuda" in capsys.readouterr().out
