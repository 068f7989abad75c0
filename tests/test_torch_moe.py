"""The port's MoE layer and reduced olmoe-1b-7b against the JAX package:
the layer's output and aux losses at f32 rtol 1e-4 (atol 1e-5) with the
routing (experts, capacity keep, dispatch slots) identical, forced router
ties included; its gradients against ``jax.grad`` under "xla"; the reduced
model's logits, greedy served tokens and three train steps (losses at rtol
1e-4, parameters at rtol 5e-4); the parameter conversion of the expert
stacks; and the fused optimizer's refusal of expert stacks."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM, SyntheticLMConfig as JSyntheticLMConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.train.step import BackendConfig as JBackendConfig, make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.train.step import BackendConfig, make_train_step  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BACKENDS = ["sfc_cuda", "torch", "sfc_reference"]


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def olmoe():
    """Reduced olmoe-1b-7b (4 layers, d 64, 8 experts top-2, f32): the JAX
    config, its parameters from its own init as numpy, the port's config."""
    jcfg = j_get_config("olmoe_1b_7b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jax.tree_util.tree_map(np.asarray, jparams), get_config("olmoe_1b_7b").reduced()


def _port_model(cfg, jparams):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    return model


def _jax_routing(p, x, top_k, capacity_factor):
    """The routing inside the JAX package's ``moe_forward`` (its local
    path), spelled out: (flat_e, keep, slot)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    logits = jnp.matmul(x.reshape(b, s, d), p["router"]).astype(jnp.float32)
    _, gate_idx = lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    capacity = max(int(np.ceil(s * top_k * capacity_factor / e)), top_k)
    flat_e = gate_idx.reshape(b, s * top_k).astype(jnp.int32)
    pos = jmoe._positions_in_expert_grouped(flat_e, e)
    keep = pos < capacity
    slot = jnp.where(keep, flat_e * capacity + pos, e * capacity)
    return np.asarray(flat_e), np.asarray(keep), np.asarray(slot)


def _layer0(jparams):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jparams["layers"]["moe"])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_moe_forward_and_routing_match_jax(olmoe, backend, ties):
    """Layer 0 of reduced olmoe through both packages from the same
    parameters: identical routing and the output and aux losses at f32
    rtol 1e-4.  With ``ties`` the router's last four columns repeat its
    first four and every value is a small integer, so every token's two
    picks tie exactly: ``lax.top_k`` puts the lower expert first, and the
    port's order and capacity ranks must follow."""
    jcfg, jparams, cfg = olmoe
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    if ties:
        jparams = jax.tree_util.tree_map(np.copy, jparams)
        half = rng.integers(-1, 2, size=(cfg.n_layers, cfg.d_model, cfg.n_experts // 2)).astype(np.float32)
        jparams["layers"]["moe"]["router"] = np.concatenate([half, half], axis=-1)
        x = rng.integers(-1, 2, size=x.shape).astype(np.float32)
    jp = _layer0(jparams)
    with j_gemm_backend("xla"):
        want, want_aux = jmoe.moe_forward(jp, jnp.asarray(x), top_k=cfg.moe_top_k)
    model = _port_model(cfg, jparams)
    tx = torch.from_numpy(x)
    with gemm_backend(backend), torch.no_grad():
        got, aux = tmoe.moe_forward(model.layers[0].moe, tx, top_k=cfg.moe_top_k)
        r = tmoe.route(model.layers[0].moe.router, tx, top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
    flat_e, keep, slot = _jax_routing(jp, jnp.asarray(x), cfg.moe_top_k, cfg.capacity_factor)
    np.testing.assert_array_equal(r.flat_e.numpy(), flat_e)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    if ties:
        # every token's two picks tie exactly, and the lower expert comes first
        pairs = r.flat_e.reshape(2, 12, cfg.moe_top_k)
        picked = torch.gather(r.probs, -1, pairs)
        assert bool((picked[..., 0] == picked[..., 1]).all()) and bool((pairs[..., 0] < pairs[..., 1]).all())
        assert not bool(keep.all())  # the tied experts overflow their capacity
    _close(got, want)
    for key in ("moe_aux_loss", "moe_z_loss"):
        _close(aux[key], want_aux[key])


@pytest.mark.parametrize("backend", BACKENDS)
def test_moe_grads_match_jax(backend):
    """The JAX package's ``test_moe_grads_match_xla`` case (d 32, d_ff 64,
    4 experts top-2): the gradients of the router and the expert stacks
    under each port backend against ``jax.grad`` under "xla"."""
    jp = jmoe.moe_init(jax.random.PRNGKey(0), d_model=32, d_ff=64, n_experts=4, dtype=jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32)), np.float32)

    def jloss(p):
        with j_gemm_backend("xla"):
            out, aux = jmoe.moe_forward(p, jnp.asarray(x), top_k=2)
            return (out**2).sum() + aux["moe_aux_loss"] + aux["moe_z_loss"]

    want = jax.grad(jloss)(jp)
    layer = tmoe.MoE(32, 64, 4, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    with gemm_backend(backend):
        out, aux = tmoe.moe_forward(layer, torch.from_numpy(x), top_k=2)
        ((out**2).sum() + aux["moe_aux_loss"] + aux["moe_z_loss"]).backward()
    for name, p in layer.named_parameters():
        ref = np.asarray(want[name])
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, ref, atol=max(ATOL, 1e-5 * float(np.abs(ref).max())))


PROMPT, CACHE, DECODE_STEPS = 12, 20, 4


@pytest.fixture(scope="module")
def olmoe_logits(olmoe):
    """The JAX package's prefill + 4 decode-step logits and its training
    forward of reduced olmoe, under "xla"."""
    jcfg, jparams, _ = olmoe
    model = j_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, jcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, size=(DECODE_STEPS, 2, 1)).astype(np.int32)
    with j_gemm_backend("xla"):
        logits, cache = model.prefill(params, jnp.asarray(prompt), cache_len=CACHE, remat="none")
        outs = [np.asarray(logits)]
        for tok in steps:
            logits, cache = model.decode_step(params, jnp.asarray(tok), cache)
            outs.append(np.asarray(logits))
        fwd, aux = model.forward(params, jnp.asarray(prompt), remat="none")
    return prompt, steps, outs, np.asarray(fwd), {k: float(v) for k, v in aux.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduced_olmoe_prefill_decode_and_forward_match_jax(olmoe, olmoe_logits, backend):
    _, jparams, cfg = olmoe
    prompt, steps, want, want_fwd, want_aux = olmoe_logits
    model = _port_model(cfg, jparams)
    with gemm_backend(backend), torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(prompt).long(), cache_len=CACHE)
        got = [logits]
        for tok in steps:
            logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache)
            got.append(logits)
        fwd, aux = model.forward(torch.from_numpy(prompt).long())
    for g, w in zip(got, want):
        _close(g, w)
    _close(fwd, want_fwd)
    for key, val in want_aux.items():
        _close(aux[key], val)
    assert want_aux["moe_aux_loss"] > 0.0


@pytest.mark.parametrize("backend", ["sfc_cuda", "torch"])
def test_olmoe_greedy_serving_tokens_match_jax(olmoe, backend):
    """Five requests, two prompt lengths, max_batch 2: the port's engine
    gives the JAX engine's greedy tokens."""
    jcfg, jparams, cfg = olmoe
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (10, 10, 10, 7, 7)]
    jengine = JServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), max_batch=2, max_seq=24,
                             gemm_backend="xla")
    want = {tuple(r.prompt.tolist()): r.output for r in jengine.run(jengine.submit_many(prompts, max_new_tokens=5))}
    engine = ServingEngine(cfg, params_from_jax(jparams, cfg, device="cpu"), max_batch=2, max_seq=24,
                           gemm_backend=backend, device="cpu")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=5))
    assert len(done) == len(prompts)
    for r in done:
        assert r.status == "completed" and r.output == want[tuple(r.prompt.tolist())]


def test_olmoe_train_steps_match_jax(olmoe):
    """Three unfused AdamW steps of reduced olmoe: the JAX step under
    "xla" and the port's under "sfc_cuda" (the plain versions of K1/K2,
    K3, K7-K10 on the CPU), from the same parameters and state."""
    jcfg, jparams, cfg = olmoe
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(j_make_train_step(j_build_model(jcfg), jadamw.AdamWConfig(**opt), remat="none",
                                      backend=JBackendConfig(gemm_backend="xla")))
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    model = _port_model(cfg, jparams)
    tstep = make_train_step(model, tadamw.AdamWConfig(**opt), backend=BackendConfig(gemm_backend="sfc_cuda"))
    jstate = jadamw.adamw_init(params)
    tstate = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), cfg, device="cpu")
    jdata = JSyntheticLM(JSyntheticLMConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1))
    data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1))
    for i in range(3):
        params, jstate, jm = jstep(params, jstate, {k: jnp.asarray(v) for k, v in jdata.batch(i).items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    got = params_to_jax(dict(model.named_parameters()), cfg)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4, atol=1e-5, err_msg=str(path))


def test_expert_stacks_convert_both_ways(olmoe):
    _, jparams, cfg = olmoe
    params = params_from_jax(jparams, cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert tuple(params["layers.2.moe.w_out"].shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    back = params_to_jax(params, cfg)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg=str(path))
    state = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jadamw.adamw_init(jparams)), cfg, device="cpu")
    assert tuple(state["mu"]["layers.0.moe.w_gate"].shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)


def test_fused_optimizer_refuses_expert_stacks(olmoe):
    """The fused step over 3-D expert stacks needs K10's update mode: it
    raises, and does not quietly update the stacks eagerly."""
    _, _, cfg = olmoe
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="K10"):
        make_train_step(model, tadamw.AdamWConfig(), backend=BackendConfig(fused_optimizer=True))


def test_olmoe_config_matches_jax_and_reduces():
    want = j_get_config("olmoe_1b_7b")
    got = get_config("olmoe-1b-7b")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.reduced().n_experts, got.reduced().moe_top_k) == (8, 2)
