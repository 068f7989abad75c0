"""Remat (`models/remat.py`, the JAX package's ``REMAT_POLICIES`` and
``_maybe_remat``) against the JAX package, on the CPU: the decoder
families here (qwen3-4b, olmoe-1b-7b, qwen2-vl-72b with stub vision rows
and M-RoPE positions), the others in tests/test_torch_remat_families.py.

Reduced configs (4 layers, d_model 64, f32), the JAX package's own
parameters carried across by `convert.params_from_jax`, batches of 2 x 16
tokens from a numpy seed.  Under "full", "dots" and "dots_no_batch" the
port's loss and every gradient are bitwise its "none"'s (the recompute runs
the same kernels on the same inputs) and within rtol 1e-4 (plus 1e-5 of
the largest |value| for gradients) of JAX's ``value_and_grad`` of
``loss(remat=policy)``, port "sfc_cuda" + "sfc" attention (the kernels'
plain versions) against JAX "sfc_pallas" + "sfc" (interpret mode), port
"torch" + blockwise against JAX "xla" + blockwise.  The elements a remat
unit keeps (its input and what the policy saves) against the residuals
JAX's ``print_saved_residuals`` lists for the same loss, per unit.  A
train step whose backward runs on a `threading.Thread` (no inherited
context, as autograd's device thread on the card): the recompute still
runs the kernels, and the fused step under "dots" is bitwise the fused
step under "none" (bf16 weights, stochastic rounding's salts included)
with one tape slot a routed projection.  The trainer's encoder-decoder
batch against JAX's, ``--remat`` through the CLI, and the launch counts
chip_smoke.py holds for the families' training steps, counted here at
the kernel entries.  tests/test_torch_remat_card.py holds remat and the
new training shapes on the card.
"""

import dataclasses
import importlib.util
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402  (print_saved_residuals's list)
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.attention_backend import attention_backend as j_attention_backend  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.launch.train import build_trainer as j_build_trainer  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.attention_backend import attention_backend  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.kernels.entry import recomputing  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import fused as tfused  # noqa: E402
from repro_torch.train.step import BackendConfig, make_train_step  # noqa: E402
from test_torch_remat_card import count_entries  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
POLICIES = ("full", "dots", "dots_no_batch")
# (port gemm, port attention), (JAX gemm, JAX attention)
PAIRS = {"sfc": (("sfc_cuda", "sfc"), ("sfc_pallas", "sfc")),
         "torch": (("torch", "blockwise"), ("xla", "blockwise"))}
B, S = 2, 16
ARCHS = ("qwen3_4b", "olmoe_1b_7b", "qwen2_vl_72b")
KERNEL_ENTRIES = ("sfc_gemm_fused", "sfc_gemm_nt", "sfc_gemm_tn", "sfc_flash_fwd", "sfc_flash_bwd_dq",
                  "sfc_flash_bwd_dkv")

_MODELS = {}
_NONE = {}


def _model(arch):
    """(JAX model, JAX params as numpy, port config, port model holding them)."""
    if arch not in _MODELS:
        jcfg = j_get_config(arch).reduced()
        jm = j_build_model(jcfg)
        jparams = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
        _MODELS[arch] = (jm, jparams, cfg, model)
    return _MODELS[arch]


def _batch(cfg, seed=3):
    """The loss's inputs as numpy: tokens and labels, the encoder-decoder's
    frames, the VLM's stub vision rows and distinct M-RoPE axes."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["src_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal((B, 8, cfg.d_model)) * 0.1).astype(np.float32)
        i = np.arange(S)
        grid = np.stack([i // 8, np.where(i < 8, i // 4, i), np.where(i < 8, i % 4, i)]).astype(np.int32)
        out["mrope_positions"] = np.ascontiguousarray(np.broadcast_to(grid[:, None], (3, B, S)))
    return out


def _port(model, batch, pair, policy):
    """(loss, {name: grad}) of the port under ``pair``'s backends."""
    (gemm, attn), _ = PAIRS[pair]
    model.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with gemm_backend(gemm), attention_backend(attn):
        loss = model.loss(tb, remat=policy)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _port_none(arch, pair):
    if (arch, pair) not in _NONE:
        _, _, cfg, model = _model(arch)
        _NONE[arch, pair] = _port(model, _batch(cfg), pair, "none")
    return _NONE[arch, pair]


def _close_grad(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=max(ATOL, 1e-5 * float(np.abs(ref).max())))


def check_bitwise_none_and_jax(arch, pair, policy):
    jm, jparams, cfg, model = _model(arch)
    batch = _batch(cfg)
    loss, grads = _port(model, batch, pair, policy)
    none_loss, none_grads = _port_none(arch, pair)
    assert torch.equal(loss, none_loss)
    assert grads.keys() == none_grads.keys()
    for n, g in grads.items():
        assert torch.equal(g, none_grads[n]), n
    _, (jgemm, jattn) = PAIRS[pair]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with j_gemm_backend(jgemm), j_attention_backend(jattn):
        jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, jbatch, remat=policy))(jparams)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    got = params_to_jax(grads, cfg)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        _close_grad(flat_got[path], want)


def _port_minus_jax(cfg, pair, policy):
    """The elements the port's remat units keep beyond JAX's residuals, per
    the two programs' structure.  A selective checkpoint keeps every
    product the policy names, JAX only those its backward reads: a unit
    that ends in a plain product feeding only the residual add keeps that
    output more (the MLP's ``w_out`` under "torch"; the sLSTM's output
    projection and a hybrid tail block's ``out_proj``, plain ``@`` on every
    backend).  Under "dots" JAX contracts a three-operand einsum as two
    dots and keeps the intermediate, where torch's einsum multiplies
    elementwise first: the SSD's chunk state (B, S, H, N) a Mamba2 layer,
    the mLSTM's carry update (B, S, H, P) a block."""
    if policy == "full":
        return 0
    tok, d, torch_pair = B * S, cfg.d_model, pair == "torch"
    if cfg.family in ("dense", "vlm"):
        return tok * d * cfg.n_layers if torch_pair else 0
    if cfg.family == "moe":
        return 0  # the experts' output is read by the combine's backward
    if cfg.family == "audio":
        return tok * d * (cfg.encoder_layers + cfg.n_layers) if torch_pair else 0
    pad = -(-S // min(cfg.ssm_chunk, S)) * min(cfg.ssm_chunk, S) * B
    if cfg.family == "hybrid":
        groups, tail = cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every
        heads = cfg.ssm_expand * d // cfg.ssm_head_dim
        inter = pad * heads * cfg.ssm_state * cfg.n_layers if policy == "dots" else 0
        return tok * d * ((groups if torch_pair else 0) + tail) - inter
    groups = cfg.n_layers // cfg.slstm_every
    blocks = groups * (cfg.slstm_every - 1)
    inter = pad * cfg.n_heads * (2 * d // cfg.n_heads) * blocks if policy == "dots" else 0
    return tok * d * groups - inter


def check_saved_elements(arch, pair, policy):
    """The port's elements a unit keeps (`remat.remat_stats`: the unit's
    input and the outputs its policy saved) against the per-unit residuals
    JAX lists for the loss: its scans' stacked outputs (the carries' final
    values, (B, S, d) unstacked, are not a unit's)."""
    jm, jparams, cfg, model = _model(arch)
    batch = _batch(cfg)
    (gemm, attn), (jgemm, jattn) = PAIRS[pair]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with j_gemm_backend(jgemm), j_attention_backend(jattn):
        res = saved_residuals(lambda p: jm.loss(p, jbatch, remat=policy), jparams)
    units = [a for a, src in res if "output of scan" in src and tuple(a.shape) != (B, S, cfg.d_model)]
    want = sum(int(np.prod(a.shape)) for a in units)
    with remat.remat_stats() as st, gemm_backend(gemm), attention_backend(attn):
        model.loss({k: torch.from_numpy(v) for k, v in batch.items()}, remat=policy)
    assert st.units > 0 and st.recomputes == 0  # no backward: nothing recomputed
    assert st.input_elements + st.saved_elements == want + _port_minus_jax(cfg, pair, policy)
    if pair == "sfc" and cfg.family in ("dense", "moe", "vlm", "audio"):
        # every product is a kernel call: a unit keeps its input only, as JAX's does
        assert st.saved_elements == 0 and st.input_elements == want


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_grads_are_bitwise_none_and_match_jax(arch, pair, policy):
    check_bitwise_none_and_jax(arch, pair, policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("arch", ARCHS)
def test_saved_elements_per_unit_match_jax_residuals(arch, pair, policy):
    check_saved_elements(arch, pair, policy)


def test_remat_changes_nothing_without_gradients_and_refuses_unknown_policies():
    _, _, cfg, model = _model("qwen3_4b")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with torch.no_grad(), remat.remat_stats() as st:
        losses = [model.loss(tb, remat=p) for p in ("none", *POLICIES)]
        logits = [model.prefill(tb["tokens"].long(), cache_len=S, remat=p)[0] for p in ("none", *POLICIES)]
    assert st.units == 0
    assert all(torch.equal(x, losses[0]) for x in losses) and all(torch.equal(x, logits[0]) for x in logits)
    with pytest.raises(ValueError, match="unknown remat policy"):
        model.loss(tb, remat="everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_train_step(model, tadamw.AdamWConfig(), remat="dots_and_more")


# ---------------------------------------------------------------------------
# the recompute on a thread of its own, and the fused step's tape
# ---------------------------------------------------------------------------


@pytest.fixture
def threaded_backward(monkeypatch):
    """Every ``Tensor.backward`` runs on a fresh `threading.Thread`, which
    inherits none of the caller's context variables (autograd's device
    thread on the card)."""
    run = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        errors = []

        def target():
            try:
                run(self, *args, **kwargs)
            except BaseException as e:  # noqa: BLE001 (re-raised on the caller's thread)
                errors.append(e)

        t = threading.Thread(target=target)
        t.start()
        t.join()
        if errors:
            raise errors[0]

    monkeypatch.setattr(torch.Tensor, "backward", backward)


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
def test_threaded_backward_recomputes_on_the_kernels(arch, threaded_backward, monkeypatch):
    """The step's backward on a thread of its own: each unit's recompute
    calls the forward's kernel entries (plain versions here) once more, so
    it ran on "sfc_cuda" + "sfc", not on the thread's default backend; and
    the parameters after the step are bitwise remat "none"'s."""
    _, jparams, cfg, _ = _model(arch)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    calls = count_entries(monkeypatch)
    out = {}
    for policy in ("none", "dots"):
        model = build_model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
        step = make_train_step(model, tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2), remat=policy,
                               backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc"))
        calls.clear()
        with remat.remat_stats() as st:
            state, metrics = step(tadamw.adamw_init(dict(model.named_parameters())), tb)
        out[policy] = (st, float(metrics["loss"]), {n: p.detach().clone() for n, p in model.named_parameters()},
                       dict(calls))
    st, c0, c1 = out["dots"][0], out["none"][3], out["dots"][3]
    assert st.units == cfg.n_layers and st.recomputes == cfg.n_layers
    # every call more than "none"'s is the recompute's: the layers'
    # projections and attention once more, the head (outside the units) and
    # the backward's kernels as often
    assert not any(k.endswith(":recompute") for k in c0)
    assert all(c1[k] - c0[k] == c1.get(f"{k}:recompute", 0) for k in c0)
    assert c1["sfc_gemm_fused:recompute"] >= 4 * cfg.n_layers
    assert c1["sfc_flash_fwd:recompute"] == c0["sfc_flash_fwd"] == cfg.n_layers
    assert all(c1[k] == c0[k] > 0 for k in ("sfc_gemm_nt", "sfc_gemm_tn", "sfc_flash_bwd_dq", "sfc_flash_bwd_dkv"))
    assert out["none"][0].units == 0
    assert out["dots"][1] == out["none"][1]
    for n, p in out["dots"][2].items():
        assert torch.equal(p, out["none"][2][n]), n


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
def test_threaded_fused_step_under_dots_is_bitwise_none(arch, threaded_backward, monkeypatch):
    """The fused optimizer (AdamW in the TN kernels' update flush; K10's for
    olmoe's expert stacks) in bf16 with stochastic rounding, the backward on
    a thread of its own: under "dots" each recomputed projection reuses the
    slot its forward took (one slot a routed projection, each handed its
    (a, dh, dg) once), so two steps leave every weight, master, mu and nu
    bitwise those of remat "none", and K8 / K10 run as often."""
    _, jparams, cfg, _ = _model(arch)
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    slot_calls = []
    session_cls = tfused.FusedSession

    def spy(*args, **kwargs):
        session = session_cls(*args, **kwargs)
        take = session.slot

        def slot(*leaves):
            got = take(*leaves)
            slot_calls.append((tuple(leaf.name for leaf in leaves), id(got), recomputing()))
            return got

        session.slot = slot
        return session

    monkeypatch.setattr(tfused, "FusedSession", spy)
    entries = count_entries(monkeypatch)
    out = {}
    for policy in ("none", "dots"):
        model = build_model(cfg16, device="cpu")
        model.load_state_dict(params_from_jax(jparams, cfg16, device="cpu"))
        step = make_train_step(model, tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3, clip_norm=1e-3),
                               remat=policy, backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc",
                                                                   fused_optimizer=True))
        state = tadamw.adamw_init(dict(model.named_parameters()))
        entries.clear()
        for seed in (3, 4):
            del slot_calls[:]
            state, metrics = step(state, {k: torch.from_numpy(v) for k, v in _batch(cfg, seed).items()})
        calls = {k: entries[k] for k in ("sfc_gemm_tn", "sfc_gemm_grouped_tn")}
        out[policy] = (model, state, metrics, calls, list(slot_calls))
    (m0, s0, met0, calls0, slots0), (m1, s1, met1, calls1, slots1) = out["none"], out["dots"]
    # the forward takes one slot a routed projection; each recomputed
    # projection (all but the head, outside the units) gets its forward's
    first = [(names, sid) for names, sid, again in slots1 if not again]
    again = [(names, sid) for names, sid, rec in slots1 if rec]
    assert [names for names, _, _ in slots0] == [names for names, _ in first]
    assert not any(rec for _, _, rec in slots0) and len({sid for _, sid in first}) == len(first)
    assert len(again) == len(first) - 1 and set(again) <= set(first)
    assert calls1 == calls0 and calls0["sfc_gemm_tn"] > 0
    if cfg.n_experts:
        assert calls0["sfc_gemm_grouped_tn"] == 2 * 2 * 2 * cfg.n_layers  # norm and update, 2 stacks, 2 steps
    assert torch.equal(met0["loss"], met1["loss"]) and torch.equal(met0["grad_norm"], met1["grad_norm"])
    p0, p1 = dict(m0.named_parameters()), dict(m1.named_parameters())
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
        for slot in ("master", "mu", "nu"):
            assert torch.equal(s0[slot][n], s1[slot][n]), (slot, n)


def test_a_second_call_of_a_routed_weight_still_raises_outside_a_recompute():
    _, _, cfg, model = _model("qwen3_4b")
    routed = tfused.probe_routed(model)
    params = dict(model.named_parameters())
    session = tfused.FusedSession(routed, params, tadamw.adamw_init(params), two_phase=True)
    leaf = next(iter(routed.values()))
    session.slot(leaf)
    with pytest.raises(RuntimeError, match="twice in one step"):
        session.slot(leaf)


# ---------------------------------------------------------------------------
# the trainer: the encoder-decoder batch, --remat, the families' launches
# ---------------------------------------------------------------------------


def test_trainer_batches_match_jax_for_every_family():
    """`build_trainer`'s batch of a step equals the JAX package's trainer's:
    the encoder-decoder's stub frames (``src_embeds``, the fault this
    repairs: the port's lacked them), the VLM's positions and vision rows."""
    for arch in ("seamless_m4t_medium", "qwen2_vl_72b", "zamba2_1_2b"):
        cfg = get_config(arch).reduced()
        _, _, _, j_batch_fn = j_build_trainer(j_get_config(arch).reduced(), batch=2, seq=16, seed=5)
        batch_fn = train_cli.make_batch_fn(cfg, batch=2, seq=16, seed=5, device="cpu")
        for step in (0, 3):
            got, want = batch_fn(step), j_batch_fn(step)
            assert got.keys() == want.keys(), arch
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_cli_remat_reaches_the_step(monkeypatch, capsys):
    seen = []
    make = train_cli.make_train_step

    def spy(model, opt_cfg, **kw):
        seen.append(kw["remat"])
        return make(model, opt_cfg, **kw)

    monkeypatch.setattr(train_cli, "make_train_step", spy)
    args = ["--arch", "seamless-m4t-medium", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    history = train_cli.main(args)
    assert seen == ["none"] and all(np.isfinite(loss) for _, loss in history)
    train_cli.main(args + ["--remat", "dots", "--backend", "sfc_cuda"])
    assert seen == ["none", "dots"]
    assert "final loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_cli.main(args + ["--remat", "some"])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_wants", Path(__file__).resolve().parents[1]
                                                  / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cs  # dataclasses look their module up here
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("causal", [True, False])
def test_chip_smoke_attention_rows_key_the_flash_counts_by_shape(causal):
    """chip_smoke.py reads a flash row's launches at its shape by the row's
    ``key``: the flash wrappers' `shape_key` of that call."""
    from repro_torch.kernels import sfc_attention as tsa

    cs = _chip_smoke()
    q, k = torch.zeros(2, 128, 16, 64), torch.zeros(2, 256, 4, 64)
    want = tsa.shape_key(q, k, causal)
    assert cs.Attn("r", "sfc_flash_fwd", 2, 128, 256, 16, 4, 64, causal=causal).key == want
    assert cs.AttnBwd("r", 2, 128, 256, 16, 4, 64, "bfloat16", causal=causal).key == want


@pytest.mark.parametrize("remat_policy", ["none", "dots"])
@pytest.mark.parametrize("arch, fused", [("seamless_m4t_medium", False), ("seamless_m4t_medium", True),
                                         ("zamba2_1_2b", False), ("xlstm_1_3b", False), ("qwen2_vl_72b", False),
                                         ("qwen2_vl_72b", True), ("qwen3_4b", False), ("qwen3_4b", True)])
def test_train_step_launches_match_chip_smoke(arch, fused, remat_policy, monkeypatch):
    """chip_smoke.py's `family_train_want` (the launches of each SFC wrapper
    it holds a train step to on the card) against the kernel entries a
    step calls here, on the reduced config (plain versions: one call, one
    launch on the card); the fused step where the probe routes a weight,
    and the probe's verdict (none routed for the hybrid's shared block and
    the xLSTM's plain projections)."""
    cfg = get_config(arch).reduced()
    cs = _chip_smoke()
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    routed = tfused.probe_routed(model)
    assert bool(routed) == (cfg.family not in ("hybrid", "ssm"))  # so no fused step runs for those
    step = make_train_step(model, tadamw.AdamWConfig(), remat=remat_policy,
                           backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc", fused_optimizer=fused))
    batch = train_cli.make_batch_fn(cfg, batch=2, seq=16, seed=0, device="cpu")(0)
    state = tadamw.adamw_init(dict(model.named_parameters()))
    calls = count_entries(monkeypatch)
    step(state, batch)
    got = {k: calls[k] for k in KERNEL_ENTRIES}
    want = cs.family_train_want(cfg, 16, fused=fused, remat=remat_policy)
    assert got == {k: want[k] for k in KERNEL_ENTRIES}
    assert want["sfc_gemm_tn:dw"] + want["sfc_gemm_tn:norm"] + want["sfc_gemm_tn:update"] == want["sfc_gemm_tn"]
    if fused:
        assert want["sfc_gemm_tn:norm"] == want["sfc_gemm_tn:update"] > 0
