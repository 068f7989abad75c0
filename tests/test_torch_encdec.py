"""The port's encoder-decoder family (``models/encdec.py`` and the
cross-attention of ``models/attention.py``: the seamless-m4t-medium
backbone) against the JAX package, on the CPU.

Reduced seamless-m4t-medium with 2 encoder and 4 decoder layers (d_model
64, 4 / 4 heads of 16, a non-gated gelu MLP of 128, f32), the JAX
package's own parameters carried across by `convert.params_from_jax`, the
stub frontend's frame embeddings (2 x 19 frames) drawn from a seed: the
three cross-attention functions; ``encode``, the forward's logits and the
loss; the prefill's last-position logits and every cache leaf (the self KV
caches, the memory's cross k / v, its length, the index) at a 21-token
and a 2-token prompt; four decode steps under blockwise and "sfc"
attention.  Port "sfc_cuda" (the kernels' plain versions) against JAX
"sfc_pallas" (interpret mode), port "torch" against JAX "xla": f32 at
rtol 1e-4, atol 1e-5 (outputs of order 0.01-1; sums of 16-128 products
taken in another order).  Also the tree's conversion both ways, the
registry, and the engine's refusal of the family (the JAX package serves
it through the model's entry points only).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import jax_leaf_path, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.encdec import EncDecLM  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BACKEND_PAIRS = [("sfc_cuda", "sfc_pallas"), ("torch", "xla")]
PAIR_IDS = lambda p: f"{p[0]}-vs-{p[1]}"  # noqa: E731
SRC_LEN, CACHE_LEN = 19, 32


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref):
    assert tuple(np.shape(_np(port))) == tuple(np.shape(ref))
    np.testing.assert_allclose(_np(port), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def seamless():
    """Reduced seamless-m4t-medium: the JAX config, its parameters from its
    own init as numpy, the port's config and model holding them."""
    jcfg = j_get_config("seamless_m4t_medium").reduced()
    jparams = jax.tree_util.tree_map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config("seamless_m4t_medium").reduced()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    return jcfg, jparams, cfg, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _frames(seed, b, d):
    return np.random.default_rng(seed).standard_normal((b, SRC_LEN, d)).astype(np.float32)


def test_registry_builds_the_encdec_with_the_jax_layout(seamless):
    jcfg, jparams, cfg, model = seamless
    assert "seamless_m4t_medium" in ARCH_IDS and get_config("seamless-m4t-medium") == get_config("seamless_m4t_medium")
    assert isinstance(model, EncDecLM) and (len(model.encoder), len(model.decoder)) == (2, 4)
    full = get_config("seamless_m4t_medium")
    assert dataclasses.asdict(full) == dataclasses.asdict(j_get_config("seamless_m4t_medium"))
    fresh = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    converted = params_from_jax(jparams, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in converted.items()} == {k: tuple(v.shape) for k, v in
                                                                fresh.state_dict().items()}
    assert fresh.decoder[0].mlp.w_gate is None  # seamless's MLP is not gated
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(cfg, converted, device="cpu")


def test_encdec_tree_converts_both_ways(seamless):
    """``encoder`` -> ``encoder.{i}.*``, ``decoder`` -> ``decoder.{i}.*``;
    back to the same tree bitwise."""
    _, jparams, cfg, _ = seamless
    params = params_from_jax(jparams, cfg, device="cpu")
    assert "encoder.1.attn.wq" in params and "decoder.3.cross.wk" in params and "decoder.0.norm_x.scale" in params
    np.testing.assert_array_equal(_np(params["decoder.2.cross.wv"]), jparams["decoder"]["cross"]["wv"][2])
    np.testing.assert_array_equal(_np(params["encoder.1.mlp.w_in"]), jparams["encoder"]["mlp"]["w_in"][1])
    back = params_to_jax(params, cfg)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert set(flat_back) == set(flat_want)
    for path, arr in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(arr, np.float32), err_msg=str(path))
    assert jax_leaf_path("decoder.3.cross.wk") == ("decoder/cross/wk", 3)
    assert jax_leaf_path("encoder.0.norm1.scale") == ("encoder/norm1/scale", 0)
    assert jax_leaf_path("enc_norm.scale") == ("enc_norm/scale", None)


@pytest.mark.parametrize("attn_impl", ["blockwise", "sfc"])
@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_cross_attention_functions_match_jax(seamless, backends, attn_impl):
    """The second decoder layer's cross-attention: prefill over a 19-row
    memory (21 decoder rows), the memory's k / v, and one decode row over
    its first 17 rows."""
    _, jparams, cfg, model = seamless
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    memory = rng.standard_normal((2, SRC_LEN, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]), jparams["decoder"]["cross"])
    p = model.decoder[1].cross
    kw = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads)
    chunks = dict(q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
    with j_gemm_backend(backends[1]):
        jo = jattn.cross_attention_forward(jp, jnp.asarray(x), jnp.asarray(memory), attn_impl=attn_impl, **chunks,
                                           **kw)
        jkv = jattn.precompute_cross_kv(jp, jnp.asarray(memory), kv_heads=cfg.kv_heads)
        jo1 = jattn.cross_attention_decode(jp, jnp.asarray(x1), jkv, jnp.asarray(17, jnp.int32), attn_impl=attn_impl,
                                           **kw)
    with gemm_backend(backends[0]), torch.no_grad():
        o = attn.cross_attention_forward(p, torch.from_numpy(x), torch.from_numpy(memory), attn_impl=attn_impl,
                                         **chunks, **kw)
        kv = attn.precompute_cross_kv(p, torch.from_numpy(memory), kv_heads=cfg.kv_heads)
        o1 = attn.cross_attention_decode(p, torch.from_numpy(x1), kv, 17, attn_impl=attn_impl, **kw)
    _close(o, jo)
    _close(kv["k"], jkv["k"])
    _close(kv["v"], jkv["v"])
    _close(o1, jo1)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_encode_forward_logits_and_loss_match_jax(seamless, backends):
    jcfg, jparams, cfg, model = seamless
    tokens = _tokens(3, 2, 21, cfg.vocab)
    labels = _tokens(4, 2, 21, cfg.vocab)
    frames = _frames(5, 2, cfg.d_model)
    jmodel = j_build_model(jcfg)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels), "src_embeds": jnp.asarray(frames)}
    with j_gemm_backend(backends[1]):
        jmemory = jmodel.encode(jparams, jnp.asarray(frames))
        jlogits, _ = jmodel.forward(jparams, jnp.asarray(tokens), jnp.asarray(frames))
        jloss = jmodel.loss(jparams, jbatch)
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
             "src_embeds": torch.from_numpy(frames)}
    with gemm_backend(backends[0]), torch.no_grad():
        memory = model.encode(batch["src_embeds"])
        logits, aux = model(batch["tokens"], batch["src_embeds"])
        loss = model.loss(batch)
    assert aux == {}
    _close(memory, jmemory)
    _close(logits, jlogits)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    # "dots" recomputes each unit in the backward: the loss is bitwise "none"'s
    with gemm_backend(backends[0]):
        assert torch.equal(model.loss(batch, remat="dots").detach(), model.loss(batch, remat="none").detach())


def _cache_leaves(cache):
    """{name: array} of a port or JAX cache, ``mem_len`` and ``index``
    included."""
    out = {"index": np.asarray(int(cache["index"])), "mem_len": np.asarray(int(cache["mem_len"]))}
    for part in ("kv", "mem_kv"):
        out.update({f"{part}.{key}": _np(val) for key, val in cache[part].items()})
    return out


def _check_cache(port, ref):
    got, want = _cache_leaves(port), _cache_leaves(ref)
    assert set(got) == set(want) == {"index", "mem_len", "kv.k", "kv.v", "mem_kv.k", "mem_kv.v"}
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("s", [21, 2])
def test_prefill_logits_and_cache_match_jax(seamless, s, backends):
    jcfg, jparams, cfg, model = seamless
    tokens = _tokens(s, 2, s, cfg.vocab)
    frames = _frames(s + 1, 2, cfg.d_model)
    with j_gemm_backend(backends[1]):
        jlogits, jcache = j_build_model(jcfg).prefill(jparams, jnp.asarray(tokens), jnp.asarray(frames),
                                                      cache_len=CACHE_LEN)
    with gemm_backend(backends[0]):
        logits, cache = model.prefill(torch.from_numpy(tokens).long(), torch.from_numpy(frames), cache_len=CACHE_LEN)
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    assert cache["kv"]["k"].shape == (4, 2, CACHE_LEN, cfg.kv_heads, 16)


@pytest.mark.parametrize("attn_impl", ["blockwise", "sfc"])
@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_decode_steps_match_jax(seamless, backends, attn_impl):
    """Four decode steps after a 21-token prefill, both fed JAX's greedy
    tokens: each step's logits and the whole cache after it; the port
    writes its self k / v into the prefill's caches."""
    jcfg, jparams, cfg, base = seamless
    jcfg, cfg = (dataclasses.replace(c, attn_impl=attn_impl) for c in (jcfg, cfg))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(base.state_dict())
    jmodel = j_build_model(jcfg)
    tokens = _tokens(7, 2, 21, cfg.vocab)
    frames = _frames(8, 2, cfg.d_model)
    with j_gemm_backend(backends[1]):
        jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), jnp.asarray(frames), cache_len=CACHE_LEN)
    with gemm_backend(backends[0]):
        _, cache = model.prefill(torch.from_numpy(tokens).long(), torch.from_numpy(frames), cache_len=CACHE_LEN)
    tensors = [cache["kv"]["k"], cache["kv"]["v"]]
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)
        with j_gemm_backend(backends[1]):
            jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache)
        with gemm_backend(backends[0]):
            logits, cache = model.decode_step(torch.from_numpy(nxt).long(), cache)
        _close(logits, jlogits)
        _check_cache(cache, jcache)
    assert [cache["kv"]["k"], cache["kv"]["v"]] == tensors and cache["index"] == 25
    with pytest.raises(ValueError, match="full"):
        model.decode_step(torch.from_numpy(nxt).long(), dict(cache, index=CACHE_LEN))


def test_projections_and_attentions_a_run_makes(seamless, monkeypatch):
    """The launch counts chip_smoke.py holds on the card, reckoned from the
    structure and counted here at the call sites: an encode 6 GEMM-backend
    projections a layer and one non-causal attention; a prefill the
    encode's, 12 a decoder layer (self q, k, v, o; cross q and o; the
    memory's k and v in the cross-attention and again for the cache; the
    MLP's two), one causal and one non-causal attention; a decode step 8
    a decoder layer and two cached attentions (self, memory)."""
    _, _, cfg, model = seamless
    calls = {"gemm": 0, "causal": 0, "non_causal": 0, "cached": 0}

    def counted(fn, key):
        def run(*args, **kw):
            calls[key if key != "attend" else ("causal" if kw["causal"] else "non_causal")] += 1
            return fn(*args, **kw)
        return run

    from repro_torch.models import layers

    monkeypatch.setattr(attn, "_bmm", counted(attn._bmm, "gemm"))
    monkeypatch.setattr(layers, "_bmm", counted(layers._bmm, "gemm"))
    monkeypatch.setattr(attn, "_attend", counted(attn._attend, "attend"))
    monkeypatch.setattr(attn, "_attend_cached", counted(attn._attend_cached, "cached"))
    enc, dec = cfg.encoder_layers, cfg.n_layers
    frames = torch.from_numpy(_frames(9, 2, cfg.d_model))
    tokens = torch.from_numpy(_tokens(9, 2, 5, cfg.vocab)).long()
    with torch.no_grad():
        model.encode(frames)
    assert calls == {"gemm": 6 * enc, "causal": 0, "non_causal": enc, "cached": 0}
    calls.update(dict.fromkeys(calls, 0))
    logits, cache = model.prefill(tokens, frames, cache_len=8)
    assert calls == {"gemm": 6 * enc + 12 * dec, "causal": dec, "non_causal": enc + dec, "cached": 0}
    calls.update(dict.fromkeys(calls, 0))
    model.decode_step(logits.argmax(-1)[:, None], cache)
    assert calls == {"gemm": 8 * dec, "causal": 0, "non_causal": 0, "cached": 2 * dec}
