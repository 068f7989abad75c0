"""The port's training path against the JAX package: the NT/TN backward
kernels (K7, K8) and the flash backward (K12, K13) through their plain
versions, gradients through the GEMM ops and the attention backend, AdamW,
the synthetic data, the train step and the train CLI.

Inputs come from numpy with fixed seeds.  The JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU.
Tolerances: f32 kernels and ops at rtol 1e-4 (atol 1e-5: the same
arithmetic summed in another order); gradients at rtol 1e-4 plus 1e-5 of
the largest |value| (a gradient sums terms that cancel, so an element near
zero carries the rounding of its large terms); the train step's losses at rtol
1e-4 and its parameters at rtol 5e-4, atol 1e-5 (the JAX package's own bar
for a train step against another backend, tests/test_grad.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import attention_backend as jab  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM, SyntheticLMConfig as JSyntheticLMConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sfc_attention as jsa  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro.launch.train import build_trainer as j_build_trainer  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.step import BackendConfig as JBackendConfig, make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import attention_backend as tab  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_attention as tsa  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train.step import BackendConfig, make_eval_step, make_train_step  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [None if s is None else (rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x, grad=False):
    return None if x is None else torch.from_numpy(x).requires_grad_(grad)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def _close_grad(port, ref):
    ref = np.asarray(ref)
    _close(port, ref, atol=max(ATOL, 1e-5 * float(np.abs(ref).max())))


# ---------------------------------------------------------------------------
# K7 / K8: the NT and TN kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("kind", ["nt", "tn"])
def test_nt_tn_plain_versions_match_pallas_kernels(kind, dual):
    knobs = dict(bm=16, bn=16, k_layers=2, k_block_factor=2)
    if kind == "nt":  # (M, K) @ (N, K)^T
        a, b, a2, b2 = _arrays(0, (32, 64), (48, 64), (32, 64) if dual else None, (48, 64) if dual else None)
        want = jk.sfc_gemm_nt(*map(_j, (a, b, a2, b2)), interpret=True, **knobs)
        got_plain = tk.sfc_gemm_nt_plain(*map(_t, (a, b, a2, b2)), **knobs)
        got = tk.sfc_gemm_nt(*map(_t, (a, b, a2, b2)), **knobs)
        wants, gots = [want], [got_plain, got]
    else:  # (M, K)^T @ (M, N)
        a, b, b2 = _arrays(1, (64, 32), (64, 48), (64, 48) if dual else None)
        want = jk.sfc_gemm_tn(*map(_j, (a, b, b2)), interpret=True, **knobs)
        got_plain = tk.sfc_gemm_tn_plain(*map(_t, (a, b, b2)), **knobs)
        got = tk.sfc_gemm_tn(*map(_t, (a, b, b2)), **knobs)
        wants = list(want) if dual else [want]
        gots = [got_plain, got]
    for g in gots:
        for gg, ww in zip(g if isinstance(g, tuple) else [g], wants):
            _close(gg, ww)


@pytest.mark.parametrize(
    "a_shape,n",
    [((37, 50), 70), ((2, 9, 24), 33), ((4, 1, 40), 151)],
)
@pytest.mark.parametrize("dual", [False, True])
def test_matmul_nt_tn_match_pallas_ops_on_ragged_shapes(a_shape, n, dual):
    k = a_shape[-1]
    lead = a_shape[:-1]
    dc, w, dc2, w2, x = _arrays(2, (*lead, n), (k, n), (*lead, n), (k, n), a_shape)
    # NT: dA = dC @ W^T (+ dC2 @ W2^T), W (K, N) as stored
    want = jops.sfc_matmul_nt(_j(dc), _j(w), _j(dc2) if dual else None, _j(w2) if dual else None,
                              interpret=True)
    got = tops.sfc_matmul_nt(_t(dc), _t(w), _t(dc2) if dual else None, _t(w2) if dual else None)
    assert tuple(got.shape) == tuple(want.shape) == a_shape
    _close(got, want)
    # TN: dW = X^T @ dC (and X^T @ dC2), leading dims folded into the contraction
    want = jops.sfc_matmul_tn(_j(x), _j(dc), _j(dc2) if dual else None, interpret=True)
    got = tops.sfc_matmul_tn(_t(x), _t(dc), _t(dc2) if dual else None)
    for g, w_ in zip(got if dual else [got], want if dual else [want]):
        assert tuple(g.shape) == (k, n)
        _close(g, w_)


# ---------------------------------------------------------------------------
# gradients through the GEMM ops
# ---------------------------------------------------------------------------

# (bias, activation, out_scale, residual)
MATMUL_EPILOGUES = [
    (False, None, None, False),
    (True, None, None, False),
    (False, "silu", None, False),
    (True, "gelu", 0.5, True),
    (False, "relu", 2.0, False),
    (True, None, 0.25, True),
]


def _grads(jfn, tfn, arrays, cot):
    """(JAX grads, port grads) of sum(f(*arrays) * cot) w.r.t. every array."""
    jgrads = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * jnp.asarray(cot)), argnums=tuple(range(len(arrays))))(
        *map(_j, arrays))
    ts = [_t(x, grad=True) for x in arrays]
    out = tfn(*ts)
    assert type(out.grad_fn).__name__ == "_MatmulCoreBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    return jgrads, [t.grad for t in ts]


@pytest.mark.parametrize("has_bias,act,scale,has_res", MATMUL_EPILOGUES)
@pytest.mark.parametrize("a_shape", [(21, 40), (2, 9, 40)])
def test_sfc_matmul_grads_match_jax(a_shape, has_bias, act, scale, has_res):
    n = 56
    a, b, bias, res, cot = _arrays(3, a_shape, (40, n), (n,), (*a_shape[:-1], n), (*a_shape[:-1], n))
    arrays = [a, b] + ([bias] if has_bias else []) + ([res] if has_res else [])

    def call(mod, conv):
        def f(a_, b_, *rest):
            rest = list(rest)
            kw = dict(activation=act, out_scale=scale)
            kw["bias"] = rest.pop(0) if has_bias else None
            kw["residual"] = rest.pop(0) if has_res else None
            if mod is jops:
                kw["interpret"] = True
            return mod.sfc_matmul(a_, b_, **kw)
        return f

    jgrads, tgrads = _grads(call(jops, _j), call(tops, _t), arrays, cot)
    for g, w in zip(tgrads, jgrads):
        _close_grad(g, w)


@pytest.mark.parametrize("biases", [False, True])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("a_shape", [(21, 40), (2, 9, 40)])
def test_sfc_glu_matmul_grads_match_jax(a_shape, act, biases):
    n = 56
    a, bg, bv, bias, gbias, res, cot = _arrays(4, a_shape, (40, n), (40, n), (n,), (n,), (*a_shape[:-1], n),
                                               (*a_shape[:-1], n))
    arrays = [a, bg, bv] + ([bias, gbias] if biases else [])

    def call(mod):
        def f(a_, bg_, bv_, *vecs):
            kw = dict(activation=act, out_scale=1.5)
            if vecs:
                kw.update(bias=vecs[0], gate_bias=vecs[1])
            if mod is jops:
                kw["interpret"] = True
            return mod.sfc_glu_matmul(a_, bg_, bv_, **kw)
        return f

    jgrads, tgrads = _grads(call(jops), call(tops), arrays, cot)
    for g, w in zip(tgrads, jgrads):
        _close_grad(g, w)


# ---------------------------------------------------------------------------
# K12 / K13: the flash backward
# ---------------------------------------------------------------------------

# (b, s, t, h, hkv, d, causal, q_offset, q_chunk, k_chunk)
FLASH_BWD_CASES = [
    (2, 32, 32, 4, 4, 16, True, 0, 16, 16),  # MHA, chunk-aligned
    (2, 33, 33, 4, 2, 16, True, 0, 16, 16),  # GQA 2:1, ragged
    (1, 20, 44, 8, 2, 8, False, 0, 8, 16),  # GQA 4:1, S != T, non-causal
    (1, 24, 40, 4, 1, 16, True, 16, 16, 8),  # q_offset, S != T
]


# the plain versions also at the CUDA kernels' 64 x 64 tile (GQA 4:1 and
# one group past a q_offset), where the bf16 calls take the wgmma kernels
FLASH_BWD_PLAIN_CASES = FLASH_BWD_CASES + [
    (1, 70, 130, 8, 2, 16, True, 0, 64, 64),
    (1, 40, 100, 4, 4, 16, True, 20, 64, 64),
]


def _pad(x, length):
    return np.pad(x, ((0, 0), (0, length - x.shape[1])) + ((0, 0),) * (x.ndim - 2))


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,q_offset,qc,kc", FLASH_BWD_PLAIN_CASES)
def test_flash_bwd_plain_versions_match_pallas_kernels(b, s, t, h, hkv, d, causal, q_offset, qc, kc):
    q, k, v, do = _arrays(5, (b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d), scale=1.0)
    sp, tp = -(-s // qc) * qc, -(-t // kc) * kc
    # the JAX side as `_flash_core_bwd` runs it: everything padded to chunk
    # multiples, lse from the forward on the padded inputs, delta from o
    qp, kp, vp, dop = _pad(q, sp), _pad(k, tp), _pad(v, tp), _pad(do, sp)
    kw = dict(causal=causal, seq_q=s, seq_k=t, q_chunk=qc, k_chunk=kc, q_offset=q_offset, interpret=True)
    o, lse = jsa.sfc_flash_fwd(*map(jnp.asarray, (qp, kp, vp)), **kw)
    delta = jnp.sum(jnp.asarray(dop) * o, axis=-1, keepdims=True)
    args = (*map(jnp.asarray, (qp, kp, vp, dop)), lse, delta)
    want_dq = jsa.sfc_flash_bwd_dq(*args, **kw)[:, :s]
    want_dk, want_dv = (x[:, :t] for x in jsa.sfc_flash_bwd_dkv(*args, **kw))
    # the port: unpadded, its own forward's lse (B, S, H) and delta
    tq, tk_, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    fkw = dict(causal=causal, seq_q=s, seq_k=t, q_offset=q_offset)
    to, tlse = tsa.sfc_flash_fwd_plain(tq, tk_, tv, q_chunk=qc, k_chunk=kc, **fkw)
    tdelta = (tdo * to).sum(-1)
    targs = (tq, tk_, tv, tdo, tlse, tdelta)
    _close_grad(tsa.sfc_flash_bwd_dq_plain(*targs, q_chunk=qc, k_chunk=kc, **fkw), want_dq)
    for parts in range(1, h // hkv + 1):  # 1: the tile kernel's order; the wgmma kernel's parts of the group
        if (h // hkv) % parts:
            continue
        dk, dv = tsa.sfc_flash_bwd_dkv_plain(*targs, q_chunk=qc, k_chunk=kc, group_parts=parts, **fkw)
        _close_grad(dk, want_dk)
        _close_grad(dv, want_dv)
    # the CPU wrappers take the plain versions
    _close_grad(tsa.sfc_flash_bwd_dq(*targs, q_chunk=qc, k_chunk=kc, **fkw), want_dq)


@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,q_offset,qc,kc", FLASH_BWD_CASES)
def test_flash_attention_grads_match_jax(b, s, t, h, hkv, d, causal, q_offset, qc, kc):
    q, k, v, cot = _arrays(6, (b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d), scale=1.0)
    kw = dict(causal=causal, q_chunk=qc, k_chunk=kc, q_offset=q_offset)

    def jloss(q_, k_, v_):
        return jnp.sum(jab.flash_attention(q_, k_, v_, interpret=True, **kw) * jnp.asarray(cot))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk_, tv = (_t(x, grad=True) for x in (q, k, v))
    out = tab.flash_attention(tq, tk_, tv, **kw)
    assert type(out.grad_fn).__name__ == "_FlashCoreBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    for g, w in zip((tq.grad, tk_.grad, tv.grad), want):
        _close_grad(g, w)


# ---------------------------------------------------------------------------
# AdamW and the data
# ---------------------------------------------------------------------------


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal((7,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_update_matches_jax(schedule):
    """Five steps with clipping active (clip_norm far under the gradient
    norm) and a schedule that warms up and decays within them."""
    cfg = dict(lr=1e-2, clip_norm=0.5, warmup_steps=2, total_steps=5, schedule=schedule)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    params = _tree(7)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = jadamw.adamw_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tadamw.adamw_init(tp)
    for i in range(5):
        grads = _tree(100 + i, scale=3.0)
        jp, js, jm = jadamw.adamw_update(jcfg, {k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        tp, ts, tm = tadamw.adamw_update(tcfg, {k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp)
        assert float(jm["grad_norm"]) > 4 * cfg["clip_norm"]
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"], rtol=1e-6, atol=0)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for k in params:
            _close(tp[k], jp[k])
            for slot in ("mu", "nu", "master"):
                _close(ts[slot][k], js[slot][k])


def test_adamw_nan_gradient_skips_the_update_bitwise():
    cfg = tadamw.AdamWConfig(lr=1e-2)
    tp = {k: torch.from_numpy(v) for k, v in _tree(8).items()}
    ts = tadamw.adamw_init(tp)
    tp, ts, _ = tadamw.adamw_update(cfg, {k: torch.from_numpy(v) for k, v in _tree(9).items()}, ts, tp)
    before = {k: v.clone() for k, v in tp.items()}
    state_before = {slot: {k: v.clone() for k, v in ts[slot].items()} for slot in ("mu", "nu", "master")}
    bad = {k: torch.from_numpy(v) for k, v in _tree(10).items()}
    bad["w"][2, 3] = float("nan")
    tp, ts, m = tadamw.adamw_update(cfg, bad, ts, tp)
    assert not np.isfinite(float(m["grad_norm"]))
    assert float(tadamw.clip_scale(cfg, m["grad_norm"])) == 0.0
    for k in before:
        assert torch.equal(tp[k], before[k])
        for slot in ("mu", "nu", "master"):
            assert torch.equal(ts[slot][k], state_before[slot][k])
    assert int(ts["step"]) == 2  # the step still counts, as in the JAX package


@pytest.mark.parametrize("lo,hi", [(0, None), (1, 3)])
def test_synthetic_batches_match_jax(lo, hi):
    cfg = dict(vocab=97, seq_len=12, global_batch=4, seed=3)
    jdata, tdata = JSyntheticLM(JSyntheticLMConfig(**cfg)), SyntheticLM(SyntheticLMConfig(**cfg))
    for step in (0, 5):
        want, got = jdata.batch(step, lo=lo, hi=hi), tdata.batch(step, lo=lo, hi=hi)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# the train step and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def yi_reduced():
    jcfg = j_get_config("yi_6b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, get_config("yi_6b").reduced()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(yi_reduced, microbatches):
    """Four steps of the JAX unfused step (sfc_pallas GEMMs, attn_impl
    "sfc") and of the port's (sfc_cuda, "sfc"; the plain versions on the
    CPU) from the same parameters and optimizer state."""
    jcfg, jparams, cfg = yi_reduced
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jstep = jax.jit(j_make_train_step(
        j_build_model(jcfg), jadamw.AdamWConfig(**opt), remat="none", microbatches=microbatches,
        backend=JBackendConfig(gemm_backend="sfc_pallas", attn_impl="sfc")))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    tstep = make_train_step(model, tadamw.AdamWConfig(**opt), remat="none", microbatches=microbatches,
                            backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc"))
    jstate = jadamw.adamw_init(jparams)
    tstate = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), cfg, device="cpu")
    data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1))
    for i in range(4):
        batch = data.batch(i)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    got = params_to_jax(dict(model.named_parameters()), cfg)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4, atol=1e-5, err_msg=str(path))
    # the eval step sees the stepped parameters
    evl = make_eval_step(model, backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc"))
    assert np.isfinite(float(evl({k: torch.from_numpy(v) for k, v in data.batch(9).items()})))


def test_train_cli_follows_the_jax_trajectory(yi_reduced, monkeypatch, capsys):
    """`python -m repro_torch.launch.train --arch yi-6b --reduced --steps 8
    --batch 4 --seq 32 --backend sfc_cuda --device cpu`, started from the
    JAX trainer's initial parameters, follows its loss trajectory."""
    jcfg, jparams, cfg = yi_reduced
    params, opt_state, jstep, batch_fn = j_build_trainer(jcfg, batch=4, seq=32, lr=3e-4, total_steps=8,
                                                         gemm_backend="sfc_pallas")
    start = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    want = []
    for step in range(8):
        params, opt_state, m = jstep(params, opt_state, batch_fn(step))
        want.append(float(m["loss"]))
    monkeypatch.setattr(DecoderLM, "init", lambda self, generator: self.load_state_dict(start) and self)
    history = train_cli.main(["--arch", "yi-6b", "--reduced", "--steps", "8", "--batch", "4", "--seq", "32",
                              "--backend", "sfc_cuda", "--device", "cpu"])
    np.testing.assert_allclose([loss for _, loss in history], want, rtol=1e-4)
    assert want[-1] < want[0] - 0.5
    assert f"final loss: {want[-1]:.4f}" in capsys.readouterr().out


def test_unported_training_options_raise(yi_reduced):
    _, _, cfg = yi_reduced
    model = build_model(cfg, device="cpu")
    opt = tadamw.AdamWConfig()
    # the fused optimizer is ported; with microbatches it raises, as in JAX
    with pytest.raises(ValueError, match="microbatches=1"):
        make_train_step(model, opt, microbatches=2, backend=BackendConfig(fused_optimizer=True))
    # the ABFT lane is ported: a step under "detect" runs and counts no
    # detection (tests/test_torch_abft.py holds its losses to "off")
    from repro_torch.robust import abft

    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, yi_reduced[1]), cfg, device="cpu"))
    step = make_train_step(model, opt, backend=BackendConfig(gemm_backend="sfc_cuda", abft="detect"))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(SyntheticLMConfig(cfg.vocab, 8, 2)).batch(0).items()}
    abft.reset_runtime_sdc()
    _, metrics = step(tadamw.adamw_init(dict(model.named_parameters())), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert abft.runtime_sdc_total() == 0 and abft.runtime_check_total() > 0
    with pytest.raises(NotImplementedError, match="item 18"):
        model.loss(batch, remat="dots")
    with pytest.raises(ValueError, match="microbatch"):
        make_train_step(model, opt, microbatches=3)(tadamw.adamw_init(dict(model.named_parameters())), batch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (skipped: a card is present)")
        train_cli.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])


def test_sfc_matmul_grads_with_per_batch_weights_match_jax():
    """Per-batch weights (B, K, N): the backward runs the forward kernel on
    transposed operands, as the JAX package's does."""
    a, b, bias, cot = _arrays(11, (3, 9, 24), (3, 24, 40), (40,), (3, 9, 40))
    arrays = [a, b, bias]

    def call(mod):
        def f(a_, b_, bias_):
            kw = dict(interpret=True) if mod is jops else {}
            return mod.sfc_matmul(a_, b_, bias=bias_, activation="silu", **kw)
        return f

    jgrads, tgrads = _grads(call(jops), call(tops), arrays, cot)
    for g, w in zip(tgrads, jgrads):
        _close_grad(g, w)
