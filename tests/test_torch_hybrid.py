"""The port's hybrid family (``models/hybrid.py``, zamba2-1.2b's Mamba2
layers and shared attention block) against the JAX package, on the CPU.

Reduced zamba2-1.2b with 5 layers (two groups of two Mamba2 blocks, each
followed by the shared block, and one tail block; d_model 64, 4 heads of
16, SSM state 16, heads of 16, chunk 8, f32), the JAX package's own
parameters carried across by `convert.params_from_jax`: the forward's
logits and the loss; the prefill's last-position logits and every cache
leaf (SSM states, conv tails, KV caches) at a 21-token prompt (three
chunks, the last padded) and a 2-token one (shorter than the conv's
window); four decode steps, their logits and caches.  Port "sfc_cuda" (the
kernels' plain versions) against JAX "sfc_pallas" (interpret mode), port
"torch" against JAX "xla": f32 at rtol 1e-4, atol 1e-5 (logits of order
0.01-1 after five layers of sums taken in another order).  Also the
hybrid tree's conversion both ways, the registry, and `ServingEngine`
serving reduced zamba2 under all four backends with the JAX engine's
greedy tokens.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import jax_leaf_path, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.hybrid import HybridLM  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
LAYERS = 5
BACKEND_PAIRS = [("sfc_cuda", "sfc_pallas"), ("torch", "xla")]
CACHE_LEN = 32


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref):
    assert tuple(np.shape(_np(port))) == tuple(np.shape(ref))
    np.testing.assert_allclose(_np(port), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def zamba():
    """Reduced zamba2-1.2b at 5 layers: the JAX config, its parameters from
    its own init as numpy, the port's config and model holding them."""
    jcfg = dataclasses.replace(j_get_config("zamba2_1_2b").reduced(), n_layers=LAYERS)
    jparams = jax.tree_util.tree_map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(get_config("zamba2_1_2b").reduced(), n_layers=LAYERS)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    return jcfg, jparams, cfg, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def test_registry_builds_the_hybrid_with_the_jax_layout(zamba):
    jcfg, jparams, cfg, model = zamba
    assert "zamba2_1_2b" in ARCH_IDS and get_config("zamba2-1.2b") == get_config("zamba2_1_2b")
    assert isinstance(model, HybridLM) and (model.n_groups, model.n_tail) == (2, 1)
    full = get_config("zamba2_1_2b")
    assert dataclasses.asdict(full) == dataclasses.asdict(j_get_config("zamba2_1_2b"))
    fresh = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    converted = params_from_jax(jparams, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in converted.items()} == {k: tuple(v.shape) for k, v in
                                                                fresh.state_dict().items()}
    assert {k: v.dtype for k, v in converted.items()} == {k: v.dtype for k, v in fresh.state_dict().items()}


def test_hybrid_tree_converts_both_ways(zamba):
    """``groups`` (G, E) -> ``groups.{g}.{e}.*``, ``tail`` -> ``tail.{i}.*``,
    ``shared_attn.*`` as it is; back to the same tree bitwise.  In bf16 the
    mixers' A_log, D and dt_bias stay f32."""
    _, jparams, cfg, _ = zamba
    params = params_from_jax(jparams, cfg, device="cpu")
    assert "groups.1.0.mixer.in_proj" in params and "tail.0.mixer.A_log" in params
    assert "shared_attn.attn.wq" in params and "shared_attn.mlp.w_gate" in params
    np.testing.assert_array_equal(_np(params["groups.1.0.mixer.in_proj"]), jparams["groups"]["mixer"]["in_proj"][1, 0])
    np.testing.assert_array_equal(_np(params["tail.0.norm.scale"]), jparams["tail"]["norm"]["scale"][0])
    back = params_to_jax(params, cfg)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert set(flat_back) == set(flat_want)
    for path, arr in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(arr, np.float32), err_msg=str(path))
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    typed = params_from_jax(jparams, bf16, device="cpu")
    assert {k.rsplit(".", 1)[-1] for k, v in typed.items() if v.dtype == torch.float32} == set(ssm.F32_PARAMS)
    assert jax_leaf_path("groups.1.0.mixer.in_proj") == ("groups/mixer/in_proj", (1, 0))
    assert jax_leaf_path("tail.0.norm.scale") == ("tail/norm/scale", 0)
    assert jax_leaf_path("shared_attn.attn.wq") == ("shared_attn/attn/wq", None)
    assert jax_leaf_path("layers.3.attn.wq") == ("layers/attn/wq", 3)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
def test_forward_logits_and_loss_match_jax(zamba, backends):
    jcfg, jparams, cfg, model = zamba
    tokens = _tokens(3, 2, 21, cfg.vocab)
    labels = _tokens(4, 2, 21, cfg.vocab)
    jmodel = j_build_model(jcfg)
    with j_gemm_backend(backends[1]):
        jlogits, _ = jmodel.forward(jparams, jnp.asarray(tokens))
        jloss = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    with gemm_backend(backends[0]), torch.no_grad():
        logits, aux = model(batch["tokens"])
        loss = model.loss(batch)
    assert aux == {}
    _close(logits, jlogits)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)


def _cache_leaves(cache):
    """{name: array} of a port or JAX cache, ``index`` included."""
    out = {"index": np.asarray(int(cache["index"]))}
    for part in ("mamba", "tail", "kv"):
        if cache[part] is not None:
            for key, val in cache[part].items():
                out[f"{part}.{key}"] = _np(val)
    return out


def _check_cache(port, ref):
    got, want = _cache_leaves(port), _cache_leaves(ref)
    assert set(got) == set(want) == {"index", "mamba.ssm", "mamba.conv", "tail.ssm", "tail.conv", "kv.k", "kv.v"}
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("s", [21, 2])
def test_prefill_logits_and_cache_match_jax(zamba, s, backends):
    jcfg, jparams, cfg, model = zamba
    tokens = _tokens(s, 2, s, cfg.vocab)
    with j_gemm_backend(backends[1]):
        jlogits, jcache = j_build_model(jcfg).prefill(jparams, jnp.asarray(tokens), cache_len=CACHE_LEN)
    with gemm_backend(backends[0]):
        logits, cache = model.prefill(torch.from_numpy(tokens).long(), cache_len=CACHE_LEN)
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    assert cache["mamba"]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
def test_decode_steps_match_jax(zamba, backends):
    """Four decode steps after a 21-token prefill, both fed JAX's greedy
    tokens: each step's logits and the whole cache after it."""
    jcfg, jparams, cfg, model = zamba
    jmodel = j_build_model(jcfg)
    tokens = _tokens(7, 2, 21, cfg.vocab)
    with j_gemm_backend(backends[1]):
        jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), cache_len=CACHE_LEN)
    with gemm_backend(backends[0]):
        _, cache = model.prefill(torch.from_numpy(tokens).long(), cache_len=CACHE_LEN)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)
        with j_gemm_backend(backends[1]):
            jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache)
        with gemm_backend(backends[0]):
            logits, cache = model.decode_step(torch.from_numpy(nxt).long(), cache)
        _close(logits, jlogits)
        _check_cache(cache, jcache)


def test_decode_updates_the_cache_in_place(zamba):
    """A decode step writes the new states into the prefill's tensors (the
    port's in-place cache, ROADMAP section 3) and returns them."""
    _, _, cfg, model = zamba
    logits, cache = model.prefill(torch.from_numpy(_tokens(8, 1, 5, cfg.vocab)).long(), cache_len=8)
    ssm_before = cache["mamba"]["ssm"].clone()
    tensors = [cache["mamba"]["ssm"], cache["mamba"]["conv"], cache["tail"]["ssm"], cache["kv"]["k"]]
    _, new = model.decode_step(logits.argmax(-1)[:, None], cache)
    assert [new["mamba"]["ssm"], new["mamba"]["conv"], new["tail"]["ssm"], new["kv"]["k"]] == tensors
    assert new["index"] == 6 and not torch.equal(ssm_before, new["mamba"]["ssm"])
    assert torch.count_nonzero(new["kv"]["k"][:, :, 5]) > 0
    with pytest.raises(ValueError, match="full"):
        model.decode_step(logits.argmax(-1)[:, None], dict(new, index=8))


@pytest.fixture(scope="module")
def jax_served(zamba):
    """The JAX engine's greedy outputs under "xla" for 4 requests of two
    prompt lengths (max_batch 2)."""
    jcfg, jparams, cfg, _ = zamba
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 9, 9, 4)]
    engine = JServingEngine(jcfg, jparams, max_batch=2, max_seq=20, gemm_backend="xla")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=5))
    return prompts, {tuple(r.prompt.tolist()): r.output for r in done}


@pytest.mark.parametrize("backend", ["torch", "sfc_cuda", "replicated", "sfc_reference"])
def test_engine_serves_reduced_zamba2_with_jax_tokens(zamba, jax_served, backend):
    _, jparams, cfg, _ = zamba
    prompts, want = jax_served
    engine = ServingEngine(cfg, params_from_jax(jparams, cfg, device="cpu"), max_batch=2, max_seq=20,
                           gemm_backend=backend, device="cpu")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=5))
    assert len(done) == len(prompts)
    for r in done:
        assert r.status == "completed" and r.output == want[tuple(r.prompt.tolist())]


def test_engine_keeps_the_mixers_f32_parameters_in_bf16(zamba):
    """A bf16 engine holds every parameter in bf16 but the mixers' A_log, D
    and dt_bias, which stay f32 as in the JAX package, and serves."""
    _, jparams, cfg, _ = zamba
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    engine = ServingEngine(bf16, params_from_jax(jparams, cfg, device="cpu"), max_batch=2, max_seq=12,
                           gemm_backend="sfc_cuda", device="cpu")
    types = {name.rsplit(".", 1)[-1] for name, p in engine.model.state_dict().items() if p.dtype == torch.float32}
    assert types == set(ssm.F32_PARAMS)
    done = engine.run(engine.submit_many([np.arange(5, dtype=np.int32)], max_new_tokens=3))
    assert done[0].status == "completed" and len(done[0].output) == 3
