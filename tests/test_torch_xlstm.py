"""The port's xLSTM family (``models/xlstm.py``, ``models/xlstm_model.py``:
xlstm-1.3b's mLSTM and sLSTM blocks) against the JAX package, on the CPU.

Reduced xlstm-1.3b with 4 layers (two groups of one mLSTM block and one
sLSTM block; d_model 64, d_inner 128, 4 heads of 32, chunk 8, f32), the
JAX package's own parameters carried across by `convert.params_from_jax`:
``mlstm_chunked`` at a ragged length (padded) and continuing a given
state, ``mlstm_decode_step``, ``slstm_scan`` over a padded segment, both
blocks' forward and decode; the model's forward logits and loss; the
prefill's last-position logits and every cache leaf (mLSTM C, n, m and
conv tails, sLSTM carries) at a 21-token prompt (three chunks, the last
padded) and a 2-token one (shorter than the conv's window); four decode
steps, their logits and caches.  Port "sfc_cuda" (the kernels' plain
versions) against JAX "sfc_pallas" (interpret mode), port "torch" against
JAX "xla": f32 at rtol 1e-4, atol 1e-5 (outputs of order 0.01-1; sums of
8-128 products taken in another order).  Also the xLSTM tree's
conversion both ways, the registry, `ServingEngine` serving reduced
xlstm-1.3b under all four backends with the JAX engine's greedy tokens,
and that importing the port leaves torch's f32 matmul precision alone
(no TF32 in the recurrences' ``torch.einsum``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import jax_leaf_path, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.xlstm_model import XLSTMLM  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BACKEND_PAIRS = [("sfc_cuda", "sfc_pallas"), ("torch", "xla")]
PAIR_IDS = lambda p: f"{p[0]}-vs-{p[1]}"  # noqa: E731
HEADS = 4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(port, ref):
    assert tuple(np.shape(_np(port))) == tuple(np.shape(ref))
    np.testing.assert_allclose(_np(port), _np(ref), rtol=RTOL, atol=ATOL)


def _close_tree(port, ref):
    """Matching nests of tuples of arrays."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(port, (tuple, list)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _close_tree(p, r)
    else:
        _close(port, ref)


@pytest.fixture(scope="module")
def xl():
    """Reduced xlstm-1.3b: the JAX config, its parameters from its own init
    as numpy, the port's config and model holding them."""
    jcfg = j_get_config("xlstm_1_3b").reduced()
    jparams = jax.tree_util.tree_map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config("xlstm_1_3b").reduced()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    return jcfg, jparams, cfg, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_registry_builds_the_xlstm_with_the_jax_layout(xl):
    jcfg, jparams, cfg, model = xl
    assert "xlstm_1_3b" in ARCH_IDS and get_config("xlstm-1.3b") == get_config("xlstm_1_3b")
    assert isinstance(model, XLSTMLM) and (model.n_groups, model.m_per_group) == (2, 1)
    assert dataclasses.asdict(get_config("xlstm_1_3b")) == dataclasses.asdict(j_get_config("xlstm_1_3b"))
    fresh = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    converted = params_from_jax(jparams, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in converted.items()} == {k: tuple(v.shape) for k, v in
                                                                fresh.state_dict().items()}
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(dataclasses.replace(cfg, family="vision"), device="cpu")


def test_xlstm_tree_converts_both_ways(xl):
    """``mlstm`` (G, M) -> ``mlstm.{g}.{m}.*``, ``slstm`` (G) ->
    ``slstm.{g}.*``; back to the same tree bitwise."""
    _, jparams, cfg, _ = xl
    params = params_from_jax(jparams, cfg, device="cpu")
    assert "mlstm.1.0.wq" in params and "slstm.1.r_kernel" in params and "mlstm.0.0.o_norm.scale" in params
    np.testing.assert_array_equal(_np(params["mlstm.1.0.w_up"]), jparams["mlstm"]["w_up"][1, 0])
    np.testing.assert_array_equal(_np(params["slstm.1.b_gates"]), jparams["slstm"]["b_gates"][1])
    back = params_to_jax(params, cfg)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert set(flat_back) == set(flat_want)
    for path, arr in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(arr, np.float32), err_msg=str(path))
    assert jax_leaf_path("mlstm.1.0.wq") == ("mlstm/wq", (1, 0))
    assert jax_leaf_path("slstm.0.norm.scale") == ("slstm/norm/scale", 0)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_jax(backends, with_state):
    """21 steps in chunks of 8 (the last padded), from zeros or from a given
    (C, n, m), the final state returned."""
    rng = np.random.default_rng(11)
    b, s, h, p = 2, 21, 2, 8
    q, k, v = (_normal(rng, b, s, h, p) for _ in range(3))
    i_gate, f_gate = _normal(rng, b, s, h), _normal(rng, b, s, h, scale=2.0) + 2.0
    state = (_normal(rng, b, h, p, p, scale=0.3), _normal(rng, b, h, p, scale=0.3),
             _normal(rng, b, h)) if with_state else None
    with j_gemm_backend(backends[1]):
        jout, jst = jx.mlstm_chunked(*map(jnp.asarray, (q, k, v, i_gate, f_gate)), chunk=8, return_state=True,
                                     initial_state=None if state is None else tuple(map(jnp.asarray, state)))
    with gemm_backend(backends[0]):
        out, st = xlstm.mlstm_chunked(*map(_t, (q, k, v, i_gate, f_gate)), chunk=8, return_state=True,
                                      initial_state=None if state is None else tuple(map(_t, state)))
    assert out.dtype == torch.float32 and all(t.dtype == torch.float32 for t in st)
    _close(out, jout)
    _close_tree(st, jst)


def test_mlstm_decode_step_and_slstm_scan_match_jax():
    """One recurrent mLSTM step from a random state; the sLSTM over 21 steps
    in segments of 8 (the JAX package pads to 24 and its carry runs the
    padded steps: the port's carry too), from a given carry."""
    rng = np.random.default_rng(12)
    b, h, p = 2, 2, 8
    state = (_normal(rng, b, h, p, p, scale=0.3), _normal(rng, b, h, p, scale=0.3), _normal(rng, b, h))
    qkv = [_normal(rng, b, h, p) for _ in range(3)]
    gates = [_normal(rng, b, h), _normal(rng, b, h)]
    jst, jh = jx.mlstm_decode_step(tuple(map(jnp.asarray, state)), *map(jnp.asarray, qkv + gates))
    st, hh = xlstm.mlstm_decode_step(tuple(map(_t, state)), *map(_t, qkv + gates))
    _close(hh, jh)
    _close_tree(st, jst)

    gx = _normal(rng, b, 21, h, 4, p)
    r = _normal(rng, h, p, 4, p, scale=0.2)
    carry = (_normal(rng, b, h, p), np.abs(_normal(rng, b, h, p)) + 1.0, _normal(rng, b, h, p),
             _normal(rng, b, h, p))
    for init in (None, carry):
        jout, jcarry = jx.slstm_scan(jnp.asarray(gx), jnp.asarray(r), return_state=True, segment=8,
                                     initial_state=None if init is None else tuple(map(jnp.asarray, init)))
        out, pcarry = xlstm.slstm_scan(_t(gx), _t(r), return_state=True, segment=8,
                                       initial_state=None if init is None else tuple(map(_t, init)))
        _close(out, jout)
        _close_tree(pcarry, jcarry)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_blocks_forward_and_decode_match_jax(xl, backends):
    """The first group's mLSTM and sLSTM blocks over 21 tokens with their
    returned state, then one decode step of each from that state."""
    _, jparams, cfg, model = xl
    rng = np.random.default_rng(13)
    x = _normal(rng, 2, 21, cfg.d_model)
    x1 = _normal(rng, 2, 1, cfg.d_model)
    jm = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0, 0]), jparams["mlstm"])
    js = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jparams["slstm"])
    mb, sb = model.mlstm[0][0], model.slstm[0]
    with j_gemm_backend(backends[1]):
        jy, jmst = jx.mlstm_block_forward(jm, jnp.asarray(x), n_heads=HEADS, chunk=cfg.ssm_chunk, return_state=True)
        jy1, jmst1 = jx.mlstm_block_decode(jm, jnp.asarray(x1), jmst, n_heads=HEADS)
        jz, jsst = jx.slstm_block_forward(js, jnp.asarray(x), n_heads=HEADS, return_state=True)
        jz1, jsst1 = jx.slstm_block_decode(js, jnp.asarray(x1), jsst, n_heads=HEADS)
    with gemm_backend(backends[0]), torch.no_grad():
        y, mst = xlstm.mlstm_block_forward(mb, _t(x), n_heads=HEADS, chunk=cfg.ssm_chunk, return_state=True)
        y1, mst1 = xlstm.mlstm_block_decode(mb, _t(x1), mst, n_heads=HEADS)
        z, sst = xlstm.slstm_block_forward(sb, _t(x), n_heads=HEADS, return_state=True)
        z1, sst1 = xlstm.slstm_block_decode(sb, _t(x1), sst, n_heads=HEADS)
    for port, ref in ((y, jy), (mst, jmst), (y1, jy1), (mst1, jmst1), (z, jz), (sst, jsst), (z1, jz1),
                      (sst1, jsst1)):
        _close_tree(port, ref)


def test_init_states_are_the_jax_package_s():
    model = build_model(get_config("xlstm_1_3b").reduced(), device="cpu").init(torch.Generator().manual_seed(2))
    jm = jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t)),
                                {"conv_b": model.mlstm[0][0].conv_b})
    _close_tree(xlstm.mlstm_block_init_state(model.mlstm[0][0], 3, HEADS, torch.float32),
                jx.mlstm_block_init_state(jm, 3, HEADS, jnp.float32))
    _close_tree(xlstm.slstm_block_init_state(3, 64, HEADS, device="cpu"), jx.slstm_block_init_state(3, 64, HEADS))


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_forward_logits_and_loss_match_jax(xl, backends):
    jcfg, jparams, cfg, model = xl
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
    # "dots" recomputes each unit in the backward: the loss is bitwise "none"'s
    with gemm_backend(backends[0]):
        assert torch.equal(model.loss(batch, remat="dots").detach(), model.loss(batch, remat="none").detach())


def _cache_leaves(cache):
    """{name: array} of a port or JAX cache, ``index`` included."""
    out = {"index": np.asarray(int(cache["index"])), "mlstm_conv": _np(cache["mlstm_conv"])}
    for part, names in (("mlstm_core", ("c", "n", "m")), ("slstm", ("c", "n", "m", "h"))):
        assert len(cache[part]) == len(names)
        out.update({f"{part}.{name}": _np(val) for name, val in zip(names, cache[part])})
    return out


def _check_cache(port, ref):
    got, want = _cache_leaves(port), _cache_leaves(ref)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("s", [21, 2])
def test_prefill_logits_and_cache_match_jax(xl, s, backends):
    jcfg, jparams, cfg, model = xl
    tokens = _tokens(s, 2, s, cfg.vocab)
    with j_gemm_backend(backends[1]):
        jlogits, jcache = j_build_model(jcfg).prefill(jparams, jnp.asarray(tokens), cache_len=32)
    with gemm_backend(backends[0]):
        logits, cache = model.prefill(torch.from_numpy(tokens).long(), cache_len=32)
    _close(logits, jlogits)
    _check_cache(cache, jcache)
    assert cache["mlstm_core"][0].shape == (2, 1, 2, HEADS, 32, 32) and cache["mlstm_core"][0].dtype == torch.float32


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_decode_steps_match_jax(xl, backends):
    """Four decode steps after a 21-token prefill, both fed JAX's greedy
    tokens: each step's logits and the whole cache after it; the port
    writes the new state into the prefill's tensors."""
    jcfg, jparams, cfg, model = xl
    jmodel = j_build_model(jcfg)
    tokens = _tokens(7, 2, 21, cfg.vocab)
    with j_gemm_backend(backends[1]):
        jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(tokens))
    with gemm_backend(backends[0]):
        _, cache = model.prefill(torch.from_numpy(tokens).long())
    tensors = [*cache["mlstm_core"], cache["mlstm_conv"], *cache["slstm"]]
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)
        with j_gemm_backend(backends[1]):
            jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt), jcache)
        with gemm_backend(backends[0]):
            logits, cache = model.decode_step(torch.from_numpy(nxt).long(), cache)
        _close(logits, jlogits)
        _check_cache(cache, jcache)
    assert [*cache["mlstm_core"], cache["mlstm_conv"], *cache["slstm"]] == tensors and cache["index"] == 25


@pytest.fixture(scope="module")
def jax_served(xl):
    """The JAX engine's greedy outputs under "xla" for 4 requests of two
    prompt lengths (max_batch 2)."""
    jcfg, jparams, cfg, _ = xl
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 9, 9, 4)]
    engine = JServingEngine(jcfg, jparams, max_batch=2, max_seq=20, gemm_backend="xla")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=5))
    return prompts, {tuple(r.prompt.tolist()): r.output for r in done}


@pytest.mark.parametrize("backend", ["torch", "sfc_cuda", "replicated", "sfc_reference"])
def test_engine_serves_reduced_xlstm_with_jax_tokens(xl, jax_served, backend):
    _, jparams, cfg, _ = xl
    prompts, want = jax_served
    engine = ServingEngine(cfg, params_from_jax(jparams, cfg, device="cpu"), max_batch=2, max_seq=20,
                           gemm_backend=backend, device="cpu")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=5))
    assert len(done) == len(prompts)
    for r in done:
        assert r.status == "completed" and r.output == want[tuple(r.prompt.tolist())]


def test_the_port_leaves_f32_matmuls_without_tf32():
    """The recurrences' ``torch.einsum`` products run in f32 on the card as
    JAX's do: importing and running the port sets neither TF32 flag nor
    the f32 matmul precision (torch's defaults: no TF32, "highest")."""
    model = build_model(get_config("xlstm_1_3b").reduced(), device="cpu").init(torch.Generator().manual_seed(3))
    with gemm_backend("sfc_cuda"):
        model.prefill(torch.zeros((1, 3), dtype=torch.long))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_chunk_products_a_prefill_and_a_decode_step_make(xl, monkeypatch):
    """The launch counts chip_smoke.py holds on the card, counted here at
    the call site: a prefill makes two chunk products (the qk scores in
    f32 out, the output product) a mLSTM block and chunk, a decode step
    none."""
    _, _, cfg, model = xl
    calls = []

    def counted(subs, a, b, **kw):
        calls.append((subs, a.dtype, b.dtype, kw.get("preferred_element_type")))
        return chunk_einsum(subs, a, b, **kw)

    from repro_torch.core.gemm_backend import chunk_einsum

    monkeypatch.setattr(xlstm, "chunk_einsum", counted)
    logits, cache = model.prefill(torch.from_numpy(_tokens(5, 2, 21, cfg.vocab)).long())
    blocks = model.n_groups * model.m_per_group
    assert len(calls) == 2 * blocks * 3  # three chunks of 8
    assert set(calls) == {("blhp,bjhp->bljh", torch.float32, torch.float32, torch.float32),
                          ("bljh,bjhp->blhp", torch.float32, torch.float32, None)}
    calls.clear()
    model.decode_step(logits.argmax(-1)[:, None], cache)
    assert calls == []
