"""The port's fused optimizer against the JAX package: the stochastic-
rounding pieces and the hyper vector, the TN kernel's update and norm modes
(K8) through their plain versions, the routing and its salts, the fused
train step and its CLI.

Inputs come from numpy with fixed seeds; the JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU.
Tolerances: the hash, the tile seeds, the random bits and the stochastic
rounding are byte-identical (a NaN is compared as NaN: its payload is the
cast's); the hyper vector is byte-identical except the cosine schedule's lr
lane, which goes through XLA's and torch's f32 cos (rtol 1e-6, the bar of
test_torch_train.py's AdamW test); the update flush against the
interpreted kernel at rtol 1e-5, atol 1e-6 (f32 sums in another order), a
bf16 W bitwise the rounding of the port's own master with its bits and
within one bf16 ulp of JAX's; train steps: losses and grad_norm at rtol
1e-4, parameters and state at rtol 5e-4, atol 1e-5 (test_torch_train.py's
bar); the fused step under "torch" against the unfused one at rtol 1e-5,
atol 1e-6 (the JAX package's own bar for that comparison).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import gemm_backend as jgb  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro.launch.train import build_trainer as j_build_trainer  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import fused as jfused  # noqa: E402
from repro.train.step import BackendConfig as JBackendConfig, make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import jax_leaf_path, opt_state_from_jax, params_from_jax, params_to_jax  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import fused as tfused  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.step import BackendConfig, make_train_step  # noqa: E402

I32 = (0, 1, 7, 12345, 2**31 - 1, -1, -5, -(2**31))


# ---------------------------------------------------------------------------
# (a) the stochastic-rounding pieces and the hyper vector, byte for byte
# ---------------------------------------------------------------------------


def test_hash_and_tile_bits_are_byte_identical_to_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32),
                        np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    want = np.asarray(jk._hash_u32(jnp.asarray(x)))
    got = tk._hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    for seed in I32:
        want = np.asarray(jk.tile_random_bits((64, 48), jnp.int32(seed), hw_rng=False))
        got = tk.tile_random_bits((64, 48), torch.tensor(seed, dtype=torch.int32)).numpy()
        assert np.array_equal(got, want.astype(np.int64)), seed


def test_stochastic_round_is_byte_identical_to_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 64)) * np.exp(rng.uniform(-20, 20, (64, 64)))).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, np.nan, 0.0]
    bits = np.asarray(jk.tile_random_bits((64, 64), jnp.int32(-9), hw_rng=False))
    want = np.asarray(jk.stochastic_round_to(jnp.asarray(x), jnp.asarray(bits), jnp.bfloat16)).view(np.uint16)
    got = tk.stochastic_round_to(torch.from_numpy(x), torch.from_numpy(bits.astype(np.int64)), torch.bfloat16)
    got = got.view(torch.int16).numpy().view(np.uint16)
    nan = np.isnan(x)
    assert np.array_equal(got[~nan], want[~nan])
    assert np.all((got[nan] & 0x7FFF) > 0x7F80) and np.all((want[nan] & 0x7FFF) > 0x7F80)
    # other targets are a cast, as in JAX
    same = tk.stochastic_round_to(torch.from_numpy(x), torch.zeros(1, dtype=torch.int64), torch.float32)
    assert np.array_equal(same.numpy().view(np.uint32), x.view(np.uint32))


# the last two: the grouped flush's expert lane 2e + set, hashed for
# expert 0's first set too
@pytest.mark.parametrize("coords", [(), (3, 5), (3, 5, 1), (0, 0, 1), (3, 5, 0), (2, 1, 7)])
def test_tile_seed_is_byte_identical_to_jax(coords):
    cfg = jadamw.AdamWConfig()
    for step in I32:
        for salt in (0, 1 << 16, (7 << 16) + 3, -5):
            jh = jadamw.pack_adamw_hyper(cfg, jnp.int32(step), jnp.float32(1.0))
            jh = jh.at[jadamw.HYP_SALT].set(jadamw.seed_to_lane(jnp.int32(salt)))
            th = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(step, dtype=torch.int32),
                                         torch.tensor(1.0))
            want = int(np.uint32(jk._tile_seed(jh, *(jnp.int32(c) for c in coords))))
            assert int(tk._tile_seed(th, salt, *coords)) == want, (step, salt)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_pack_adamw_hyper_is_byte_identical_to_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=300, schedule=schedule, weight_decay=0.05, b2=0.98)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    lanes = [i for i in range(tadamw.HYPER_LEN) if not (schedule == "cosine" and i == tadamw.HYP_LR)]
    for step in list(range(-3, 320, 7)) + list(I32):
        for scale in (1.0, 0.37, 0.0):
            want = np.asarray(jadamw.pack_adamw_hyper(jcfg, jnp.int32(step), jnp.float32(scale)))
            got = tadamw.pack_adamw_hyper(tcfg, torch.tensor(step, dtype=torch.int32), torch.tensor(scale)).numpy()
            assert np.array_equal(got.view(np.uint32)[lanes], want.view(np.uint32)[lanes]), (step, scale)
            np.testing.assert_allclose(got[tadamw.HYP_LR], want[tadamw.HYP_LR], rtol=1e-6)
            assert int(tadamw.seed_from_lane(torch.from_numpy(got)[tadamw.HYP_SEED])) == step


def test_seed_lanes_and_the_gnorm_slot_match_jax():
    for seed in I32:
        want = np.asarray(jadamw.seed_to_lane(jnp.int32(seed))).view(np.uint32)
        lane = tadamw.seed_to_lane(torch.tensor(seed, dtype=torch.int32))
        assert lane.dtype == torch.float32 and int(lane.numpy().view(np.uint32)) == int(want)
        assert int(tadamw.seed_from_lane(lane)) == seed
    cfg = get_config("yi_6b").reduced()
    jparams = j_build_model(j_get_config("yi_6b").reduced()).init(jax.random.PRNGKey(1))
    jstate = jax.tree_util.tree_map(np.asarray, jadamw.adamw_init(jparams, with_gnorm=True))
    state = opt_state_from_jax(jstate, cfg, device="cpu")
    assert state["gnorm"].dtype == torch.float32 and float(state["gnorm"]) == 0.0
    model = build_model(cfg, device="cpu")
    assert set(tadamw.adamw_init(dict(model.named_parameters()), with_gnorm=True)) == {
        "step", "mu", "nu", "master", "gnorm"}


# ---------------------------------------------------------------------------
# (b), (c) K8's update and norm modes against the interpreted Pallas kernel
# ---------------------------------------------------------------------------


def _update_inputs(seed, m, k, n, dual):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    ops = [arr(m, k), arr(m, n)] + ([arr(m, n)] if dual else [])
    sets = [[arr(k, n, scale=0.02), arr(k, n, scale=0.1), arr(k, n, scale=0.3) ** 2] for _ in range(2 if dual else 1)]
    return ops, sets


def _pad(x, rows, cols):
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])))


@pytest.mark.parametrize("scale", [0.7, 0.0])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype,sr", [("float32", False), ("bfloat16", True), ("bfloat16", False)])
def test_tn_update_plain_matches_jax_kernel(dtype, sr, dual, scale):
    """`sfc_gemm_tn_plain` in update mode against JAX ``sfc_gemm_tn(...,
    interpret=True, bm=64, bn=64)`` on ragged K, N (JAX's operands and
    state zero-padded to the blocks, as its ops layer pads them), single
    and dual; scale 0 keeps the state bitwise."""
    m, k, n = 70, 100, 130
    (a, b, *b2), sets = _update_inputs(3, m, k, n, dual)
    salt, step = (3 << 16) + 2, 11
    jh = jadamw.pack_adamw_hyper(jadamw.AdamWConfig(), jnp.int32(step), jnp.float32(scale))
    jh = jh.at[jadamw.HYP_SALT].set(jadamw.seed_to_lane(jnp.int32(salt)))
    th = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(step, dtype=torch.int32), torch.tensor(scale))
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    kp, np_ = 128, 192
    jstate = [jnp.asarray(_pad(x, kp, np_)) for s in sets for x in s] + [None] * (0 if dual else 3)
    out = jk.sfc_gemm_tn(
        jnp.asarray(_pad(a, m, kp)).astype(jdt), jnp.asarray(_pad(b, m, np_)).astype(jdt),
        jnp.asarray(_pad(b2[0], m, np_)).astype(jdt) if dual else None, *jstate, jh,
        bm=64, bn=64, interpret=True, out_dtype=jnp.float32, update_dtype=jdt, stochastic_round=sr,
    )
    tstate = [[torch.from_numpy(x.copy()) for x in s] for s in sets]
    ws = [torch.zeros((k, n), dtype=dt) for _ in sets]
    norms = tk.sfc_gemm_tn_plain(
        torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt), torch.from_numpy(b2[0]).to(dt) if dual else None,
        *[x for s in tstate for x in s], *([None] * (0 if dual else 3)), th,
        w=ws[0], w2=ws[1] if dual else None, salt=salt, stochastic_round=sr, bm=64, bn=64,
    )
    assert norms.shape == (len(sets),)
    for s, (orig, got, w) in enumerate(zip(sets, tstate, ws)):
        jw, jm, ju, jv = (np.asarray(x[:k, :n].astype(jnp.float32)) for x in out[4 * s:4 * s + 4])
        np.testing.assert_allclose(float(norms[s]), float(out[-1][s, 0]), rtol=1e-5)
        for g, want in zip(got, (jm, ju, jv)):
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-6)
        if scale == 0.0:
            for g, o in zip(got, orig):
                assert np.array_equal(g.numpy(), o)
            assert torch.equal(w, got[0].to(dt))
            continue
        if sr:
            bits = tk._tile_bits(k, n, 64, 64, th, salt, *((1,) if s else ()))
            assert torch.equal(w, tk.stochastic_round_to(got[0], bits, dt))
            wf = w.float().numpy()
            assert np.all(np.abs(wf - jw) <= 2.0**-7 * np.maximum(np.abs(wf), np.abs(jw)))
        else:
            np.testing.assert_allclose(w.float().numpy(), jw, rtol=1e-5 if dtype == "float32" else 2.0**-8,
                                       atol=1e-6)


@pytest.mark.parametrize("dual", [False, True])
def test_norm_mode_sum_equals_the_update_norm(dual):
    m, k, n = 33, 70, 90
    (a, b, *b2), sets = _update_inputs(4, m, k, n, dual)
    ops = [torch.from_numpy(x) for x in (a, b, *b2)] + ([] if dual else [None])
    hyper = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(3, dtype=torch.int32), torch.tensor(0.5))
    state = [torch.from_numpy(x.copy()) for s in sets for x in s] + [None] * (0 if dual else 3)
    ws = [torch.zeros((k, n)) for _ in sets]
    upd = tk.sfc_gemm_tn(*ops, *state, hyper, w=ws[0], w2=ws[1] if dual else None, salt=9)
    norm = tk.sfc_gemm_tn(*ops, norm=True)
    assert torch.equal(norm, upd)
    # the ops layer: a scalar, or a pair with the second cotangent
    got = tops.sfc_matmul_tn_norm(ops[0], ops[1], ops[2])
    want = [float((ops[0].T @ d).square().sum()) for d in ops[1:] if d is not None]
    np.testing.assert_allclose([float(x) for x in (got if dual else [got])], want, rtol=1e-5)
    with pytest.raises(ValueError, match="norm mode"):
        tk.sfc_gemm_tn(*ops, *state, hyper, w=ws[0], w2=ws[1] if dual else None, norm=True)


def test_plain_update_matches_jax_oracle():
    """The oracle backends' update (JAX ``_jnp_update``): one hash over the
    whole leaf, ``seed ^ salt * 0x85EB``."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(5)
    dw, mst, mu = (rng.standard_normal((40, 24)).astype(np.float32) * s for s in (1.0, 0.02, 0.1))
    nu = (rng.standard_normal((40, 24)).astype(np.float32) * 0.3) ** 2
    salt = (2 << 16) + 5
    jh = jadamw.pack_adamw_hyper(jadamw.AdamWConfig(), jnp.int32(4), jnp.float32(0.8))
    jh = jh.at[jadamw.HYP_SALT].set(jadamw.seed_to_lane(jnp.int32(salt)))
    jw, jm, ju, jv, jsq = jops._jnp_update(jnp.asarray(dw), jnp.asarray(mst), jnp.asarray(mu), jnp.asarray(nu), jh,
                                           param_dtype=jnp.bfloat16, stochastic_round=True)
    th = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(4, dtype=torch.int32), torch.tensor(0.8))
    state = [torch.from_numpy(x.copy()) for x in (mst, mu, nu)]
    w = torch.zeros((40, 24), dtype=torch.bfloat16)
    sq = tops.plain_update(torch.from_numpy(dw), *state, w, th, salt=salt, stochastic_round=True)
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-6)
    for g, want in zip(state, (jm, ju, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.array_equal(w.float().numpy(), np.asarray(jw.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# (d) routing and salts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3_4b", "yi_6b", "olmoe_1b_7b"])
def test_routing_and_salts_match_jax(arch):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    one = {"tokens": jnp.zeros((1, 4), jnp.int32), "labels": jnp.zeros((1, 4), jnp.int32)}

    def probe_loss(p, batch):
        with jgb.gemm_backend("xla"):
            return jmodel.loss(p, batch, remat="none")

    jrouted = jfused.probe_routed(probe_loss, jparams, one)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    wrapped = jfused.wrap_routed(jparams, zeros, zeros, zeros, jnp.zeros((12,), jnp.float32), jrouted)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            wrapped, is_leaf=lambda x: isinstance(x, jfused.FusedParam)):
        if isinstance(leaf, jfused.FusedParam):
            name = jfused._path_str(path)
            salts = np.asarray(jadamw.seed_from_lane(leaf.hyper[..., jadamw.HYP_SALT])).reshape(-1)
            want[name] = ([int(s) for s in salts], jrouted[name].op)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    routed = tfused.probe_routed(model)
    got = {}
    for name, leaf in routed.items():
        path, layer = jax_leaf_path(name)
        assert (leaf.path, leaf.layer) == (path, layer)
        got.setdefault(path, ({}, leaf.op))[0][layer or 0] = leaf.salt
    assert set(got) == set(want)
    for path, (salts, op) in got.items():
        assert [salts[i] for i in sorted(salts)] == want[path][0], path
        assert op == want[path][1], path
    # every projection weight, and not the embedding or the norms: q, k, v,
    # o and the GLU pair and w_out a layer; or q, k, v, o and the three
    # expert stacks (the GLU pair as grouped_glu, w_out grouped), the
    # router unrouted as in JAX
    assert len(routed) == 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
    if cfg.n_experts:
        assert {leaf.op for n, leaf in routed.items() if ".moe." in n} == {"grouped", "grouped_glu"}
        assert not any(n.endswith(".router") for n in routed)
    tied = tfused.probe_routed(build_model(dataclasses.replace(cfg, tie_embeddings=True), device="cpu"))
    assert "head" not in tied and not any("embed" in n for n in tied)


# ---------------------------------------------------------------------------
# (e) - (h) the fused step and its CLI
# ---------------------------------------------------------------------------

STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
CLIPS = {"clip_off": 1e9, "clip_binds": 0.05}


def _batches(cfg):
    data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1))
    return [data.batch(i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def yi_fused():
    """The jitted JAX fused step (sfc_pallas, attn "sfc", no stochastic
    rounding) over STEPS steps of reduced yi-6b, once per clip setting:
    the start, each step's metrics and the end state."""
    jcfg, cfg = j_get_config("yi_6b").reduced(), get_config("yi_6b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    runs = {}
    for name, clip in CLIPS.items():
        jstep = jax.jit(j_make_train_step(
            j_build_model(jcfg), jadamw.AdamWConfig(clip_norm=clip, **OPT), remat="none",
            backend=JBackendConfig(gemm_backend="sfc_pallas", attn_impl="sfc", fused_optimizer=True,
                                   stochastic_round=False)))
        params, state, metrics = jparams, jadamw.adamw_init(jparams), []
        for batch in _batches(cfg):
            params, state, m = jstep(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = (metrics, jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, state))
    start = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, start, runs


def _port(cfg, start, backend, **step_kw):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(start, cfg, device="cpu"))
    state = tadamw.adamw_init(dict(model.named_parameters()))
    return model, state, make_train_step(model, remat="none", backend=backend, **step_kw)


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_fused_train_step_matches_jax(yi_fused, clip):
    cfg, start, runs = yi_fused
    want, jparams, jstate = runs[clip]
    model, state, step = _port(cfg, start, BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc",
                                                         fused_optimizer=True, stochastic_round=False),
                               opt_cfg=tadamw.AdamWConfig(clip_norm=CLIPS[clip], **OPT))
    for batch, w in zip(_batches(cfg), want):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), w["loss"], rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), w["grad_norm"], rtol=1e-4)
        assert (w["grad_norm"] > CLIPS[clip]) == (clip == "clip_binds")
    assert int(state["step"]) == STEPS
    got = params_to_jax(dict(model.named_parameters()), cfg)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=1e-5, err_msg=str(path))
    for slot in ("mu", "nu", "master"):
        got = params_to_jax(state[slot], cfg)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(jstate[slot])):
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=1e-5, err_msg=f"{slot} {path}")


def test_fused_step_leaves_routed_weights_without_grad_and_adamw_to_the_rest(yi_fused, monkeypatch):
    """No fallback: no routed weight gets a ``.grad``, the elementwise
    AdamW sees only the unrouted leaves, and the TN kernel's norm and
    update modes serve every routed projection (its plain version here)."""
    cfg, start, _ = yi_fused
    model, state, step = _port(cfg, start, BackendConfig(gemm_backend="sfc_cuda", fused_optimizer=True),
                               opt_cfg=tadamw.AdamWConfig(**OPT))
    routed = tfused.probe_routed(model)
    seen = []
    real_apply = tstep.adamw_apply
    monkeypatch.setattr(tstep, "adamw_apply", lambda cfg_, grads, st, params, **kw: (
        seen.append(sorted(params)), real_apply(cfg_, grads, st, params, **kw))[1])
    calls = []
    real_tn = tk.sfc_gemm_tn
    monkeypatch.setattr(tk, "sfc_gemm_tn", lambda *a, **kw: (
        calls.append("norm" if kw.get("norm") else "update" if kw.get("w") is not None else "dw"),
        real_tn(*a, **kw))[1])
    import repro_torch.kernels.ops as ops_mod
    monkeypatch.setattr(ops_mod, "sfc_gemm_tn", tk.sfc_gemm_tn)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in _batches(cfg)[0].items()})
    names = dict(model.named_parameters())
    assert seen == [sorted(set(names) - set(routed))]
    assert all(names[n].grad is None for n in names)
    n_proj = 6 * cfg.n_layers + 1  # q, k, v, o, the GLU pair, w_out; the head
    assert calls.count("norm") == calls.count("update") == n_proj and "dw" not in calls


def test_nonfinite_gradient_skips_the_fused_step_bitwise(yi_fused, monkeypatch):
    """A NaN in every gradient (through a hook on the logits) binds the
    scale to 0: W, master, mu and nu of every leaf stay bitwise (f32, so W
    is the cast of the unchanged master) and the step still counts."""
    cfg, start, _ = yi_fused
    model, state, step = _port(cfg, start, BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc",
                                                         fused_optimizer=True),
                               opt_cfg=tadamw.AdamWConfig(**OPT))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(cfg)]
    state, _ = step(state, batches[0])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    slots = {s: {n: t.clone() for n, t in state[s].items()} for s in ("mu", "nu", "master")}
    real = DecoderLM._logits

    def poisoned(self, x):
        out = real(self, x)
        out.register_hook(lambda g: g * float("nan"))
        return out

    monkeypatch.setattr(DecoderLM, "_logits", poisoned)
    state, m = step(state, batches[1])
    assert not np.isfinite(float(m["grad_norm"])) and np.isfinite(float(m["loss"]))
    assert int(state["step"]) == 2
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
        for s in slots:
            assert torch.equal(state[s][n], slots[s][n]), (s, n)


@pytest.mark.parametrize("mode", ["two_phase", "one_phase"])
def test_fused_step_under_torch_matches_unfused_f32(yi_fused, mode):
    """The oracle (plain autograd dW, the hyper vector's AdamW program)
    against the unfused step, both on the "torch" backend, with a clip
    that binds (two phases) or with no clip and no guard (one phase: the
    update runs at scale 1 and its norms give grad_norm)."""
    cfg, start, _ = yi_fused
    clip, guard = (0.05, True) if mode == "two_phase" else (float("inf"), False)
    opt = tadamw.AdamWConfig(clip_norm=clip, **OPT)
    runs = []
    for fused in (False, True):
        model, state, step = _port(cfg, start, BackendConfig(gemm_backend="torch", fused_optimizer=fused),
                                   opt_cfg=opt, nonfinite_guard=guard)
        metrics = []
        for batch in _batches(cfg):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, dict(model.named_parameters()), state))
    (mu_, pu, su), (mf, pf, sf) = runs
    np.testing.assert_allclose(mf, mu_, rtol=1e-5)
    if mode == "two_phase":
        assert mu_[0][1] > clip
    for n in pu:
        np.testing.assert_allclose(pf[n].detach().numpy(), pu[n].detach().numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
        for s in ("mu", "nu", "master"):
            np.testing.assert_allclose(sf[s][n].numpy(), su[s][n].numpy(), rtol=1e-5, atol=1e-6, err_msg=f"{s} {n}")


def test_fused_step_options_and_misuse_raise(yi_fused):
    cfg, start, _ = yi_fused
    model = build_model(cfg, device="cpu")
    opt = tadamw.AdamWConfig()
    with pytest.raises(ValueError, match="microbatches=1"):
        make_train_step(model, opt, microbatches=2, backend=BackendConfig(fused_optimizer=True))
    # a GLU pair must be routed together
    step = make_train_step(model, opt, backend=BackendConfig(fused_optimizer=True),
                           fused_filter=lambda n, p: p.ndim == 2 and not n.endswith("w_gate") and "embed" not in n)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg)[0].items()}
    with pytest.raises(ValueError, match="routed together"):
        step(tadamw.adamw_init(dict(model.named_parameters())), batch)


def test_fused_train_cli_follows_the_jax_fused_trajectory(yi_fused, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch yi-6b --reduced --steps 8
    --batch 4 --seq 32 --backend sfc_cuda --device cpu --fused-optimizer
    --no-stochastic-round``, started from the JAX fused trainer's initial
    parameters, follows its loss trajectory."""
    jcfg, cfg = j_get_config("yi_6b").reduced(), get_config("yi_6b").reduced()
    params, opt_state, jstep, batch_fn = j_build_trainer(jcfg, batch=4, seq=32, lr=3e-4, total_steps=8,
                                                         gemm_backend="sfc_pallas", fused_optimizer=True,
                                                         stochastic_round=False)
    start = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    want = []
    for step in range(8):
        params, opt_state, m = jstep(params, opt_state, batch_fn(step))
        want.append(float(m["loss"]))
    monkeypatch.setattr(DecoderLM, "init", lambda self, generator: self.load_state_dict(start) and self)
    history = train_cli.main(["--arch", "yi-6b", "--reduced", "--steps", "8", "--batch", "4", "--seq", "32",
                              "--backend", "sfc_cuda", "--device", "cpu", "--fused-optimizer",
                              "--no-stochastic-round"])
    np.testing.assert_allclose([loss for _, loss in history], want, rtol=1e-4)
    assert want[-1] < want[0] - 0.5
    assert f"final loss: {want[-1]:.4f}" in capsys.readouterr().out
