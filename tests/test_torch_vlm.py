"""The port's VLM family (the Qwen2-VL backbone of ``models/transformer.py``
with M-RoPE in ``models/layers.py::apply_rope``) against the JAX package,
on the CPU.

Reduced qwen2-vl-72b (4 layers, d_model 64, 4 / 4 heads of 16, M-RoPE
sections (2, 3, 3), qkv bias, a GLU of 128, f32), the JAX package's own
parameters carried across by `convert.params_from_jax`, stub patch
embeddings drawn from a seed over the leading positions and Qwen2-VL's
grid positions: (0, row, column) on a 2 x 4 image, then text positions on
all three axes from the grid's largest index plus one.  `apply_rope` with
three distinct position axes and its fallback; the forward's logits and
the loss; the prefill and four decode steps with and without explicit
decode positions; the microbatched train step's loss and gradient norm.
Port "sfc_cuda" (the kernels' plain versions) against JAX "sfc_pallas"
(interpret mode), port "torch" against JAX "xla": f32 at rtol 1e-4, atol
1e-5 (outputs of order 0.01-1; sums of 16-128 products taken in another
order).  Also the projections and attentions a run makes, which
chip_smoke.py holds on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.step import BackendConfig as JBackendConfig, make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.launch.train import build_trainer  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import VISION_TOKENS, build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train.step import BackendConfig, make_train_step  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BACKEND_PAIRS = [("sfc_cuda", "sfc_pallas"), ("torch", "xla")]
PAIR_IDS = lambda p: f"{p[0]}-vs-{p[1]}"  # noqa: E731
GRID = (2, 4)  # the stub image's rows and columns of patches
PROMPT, CACHE, DECODE_STEPS = 14, 20, 4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref):
    assert tuple(np.shape(_np(port))) == tuple(np.shape(ref))
    np.testing.assert_allclose(_np(port), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def vlm():
    """Reduced qwen2-vl-72b: the JAX config, its parameters from its own
    init as numpy, the port's config and model holding them."""
    jcfg = j_get_config("qwen2_vl_72b").reduced()
    jparams = jax.tree_util.tree_map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config("qwen2_vl_72b").reduced()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    return jcfg, jparams, cfg, model


def grid_positions(b, s, grid=GRID):
    """Qwen2-VL's (3, B, S) positions of an image of ``grid`` patches on
    the leading positions, then text: (0, row, column) for patch i, then
    the text's running index on every axis from the grid's largest index
    plus one."""
    rows, cols = grid
    n_img = rows * cols
    i = np.arange(n_img)
    img = np.stack([np.zeros(n_img), i // cols, i % cols]).astype(np.int32)
    start = max(rows, cols)
    txt = np.broadcast_to(np.arange(start, start + s - n_img, dtype=np.int32), (3, s - n_img))
    return np.ascontiguousarray(np.broadcast_to(np.concatenate([img, txt], axis=1)[:, None], (3, b, s)))


def _inputs(cfg, seed, b, s):
    """(tokens, vision embeddings (B, n_img, d), grid positions (3, B, S))."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    vision = (rng.standard_normal((b, GRID[0] * GRID[1], cfg.d_model)) * 0.1).astype(np.float32)
    return tokens, vision, grid_positions(b, s)


def test_registry_builds_the_vlm_as_a_decoder_lm(vlm):
    jcfg, jparams, cfg, model = vlm
    assert isinstance(model, transformer.DecoderLM) and cfg.family == "vlm" and cfg.mrope_sections == (2, 3, 3)
    assert model.layers[0].attn.bq is not None  # qkv bias
    assert VISION_TOKENS == 1024
    fresh = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in fresh.state_dict().items()}


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_mrope_with_distinct_axes_and_its_fallback_match_jax(rotary_pct):
    """Sections (2, 3, 3) over 8 rotary half-dims (head dim 16; at
    rotary_pct 0.5 the sections run past the 4 half-dims there, as JAX's
    slices do) with three distinct position axes; then the fallback
    (no M-RoPE positions), which is plain RoPE bitwise."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    mpos = rng.integers(0, 4096, size=(3, 2, 7)).astype(np.int32)
    kw = dict(theta=1_000_000.0, rotary_pct=rotary_pct, mrope_sections=(2, 3, 3))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), mrope_positions=torch.from_numpy(mpos), **kw)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), mrope_positions=jnp.asarray(mpos), **kw)
    _close(got, want)
    # distinct axes rotate otherwise than the token positions do
    assert not np.allclose(_np(got), _np(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), **kw)))
    fallback = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), **kw)
    _close(fallback, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), **kw))
    plain = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=kw["theta"], rotary_pct=rotary_pct)
    assert torch.equal(fallback, plain)
    same = torch.from_numpy(pos)[None].expand(3, 2, 7)
    assert torch.equal(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), mrope_positions=same, **kw), plain)


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_forward_logits_and_loss_with_vision_rows_match_jax(vlm, backends):
    jcfg, jparams, cfg, model = vlm
    port_b, jax_b = backends
    tokens, vision, mpos = _inputs(cfg, 5, 2, 16)
    labels = np.roll(tokens, -1, axis=1)
    jm = j_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels), "mrope_positions": jnp.asarray(mpos),
              "vision_embeds": jnp.asarray(vision)}
    with j_gemm_backend(jax_b):
        want, _ = jm.forward(params, jbatch["tokens"], mrope_positions=jbatch["mrope_positions"],
                             vision_embeds=jbatch["vision_embeds"], remat="none")
        want_loss = jm.loss(params, jbatch, remat="none")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    with gemm_backend(port_b), torch.no_grad():
        got, aux = model.forward(batch["tokens"].long(), mrope_positions=batch["mrope_positions"],
                                 vision_embeds=batch["vision_embeds"])
        loss = model.loss(batch)
        text_only = model.forward(batch["tokens"].long())[0]
    _close(got, want)
    _close(loss, want_loss)
    assert float(aux["moe_aux_loss"]) == 0.0
    # the vision rows and the grid positions both reach the logits
    assert not np.allclose(_np(got), _np(text_only), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("explicit", [False, True], ids=["index_positions", "explicit_positions"])
@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_prefill_and_decode_steps_match_jax(vlm, backends, explicit):
    """A 14-token prompt with the 8 vision rows and grid positions, then 4
    decode steps: by default at the cache index on every axis (JAX's
    fallback), or at explicit (3, B, 1) positions continuing the text's."""
    jcfg, jparams, cfg, model = vlm
    port_b, jax_b = backends
    tokens, vision, mpos = _inputs(cfg, 7, 2, PROMPT)
    steps = np.random.default_rng(8).integers(0, cfg.vocab, size=(DECODE_STEPS, 2, 1)).astype(np.int32)
    next_pos = int(mpos[0, 0, -1]) + 1
    step_pos = [np.full((3, 2, 1), next_pos + i, np.int32) if explicit else None for i in range(DECODE_STEPS)]
    jm = j_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    with j_gemm_backend(jax_b):
        logits, cache = jm.prefill(params, jnp.asarray(tokens), cache_len=CACHE, mrope_positions=jnp.asarray(mpos),
                                   vision_embeds=jnp.asarray(vision), remat="none")
        want = [np.asarray(logits)]
        for tok, p in zip(steps, step_pos):
            logits, cache = jm.decode_step(params, jnp.asarray(tok), cache,
                                           mrope_positions=None if p is None else jnp.asarray(p))
            want.append(np.asarray(logits))
    with gemm_backend(port_b):
        logits, cache = model.prefill(torch.from_numpy(tokens).long(), cache_len=CACHE,
                                      mrope_positions=torch.from_numpy(mpos), vision_embeds=torch.from_numpy(vision))
        got = [logits]
        for tok, p in zip(steps, step_pos):
            logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache,
                                              mrope_positions=None if p is None else torch.from_numpy(p))
            got.append(logits)
    assert cache["index"] == PROMPT + DECODE_STEPS
    for g, w in zip(got, want):
        _close(g, w)
    if explicit:  # the text runs from 4 after the 2 x 4 grid, not from the index
        assert next_pos != PROMPT


def _vlm_batch(cfg, seed, b, s):
    tokens, vision, mpos = _inputs(cfg, seed, b, s)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1), "mrope_positions": mpos,
            "vision_embeds": vision}


def _port_step(cfg, jparams, microbatches, backend="sfc_cuda"):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    step = make_train_step(model, tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                           microbatches=microbatches, backend=BackendConfig(gemm_backend=backend))
    return step, tadamw.adamw_init(dict(model.named_parameters()))


def test_microbatched_loss_at_two_matches_jax(vlm):
    """k = 2 at B = 4: the JAX package cuts the (3, B, S) positions on
    their batch axis (3 is no multiple of 2), as the port always does."""
    jcfg, jparams, cfg, _ = vlm
    batch = _vlm_batch(cfg, 11, 4, 12)
    jstep = jax.jit(j_make_train_step(j_build_model(jcfg), jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                                      remat="none", microbatches=2, backend=JBackendConfig(gemm_backend="xla")))
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    _, _, jm = jstep(params, jadamw.adamw_init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    step, _ = _port_step(cfg, jparams, 2)
    state = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jadamw.adamw_init(params)), cfg, device="cpu")
    _, tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)


@pytest.mark.parametrize("b", [3, 6])
def test_microbatched_loss_at_three_matches_the_unsplit_loss(vlm, b):
    """k = 3: each microbatch gets its own rows' positions and vision rows
    (the JAX package would cut the (t, h, w) axis there), so the loss and
    gradient norm are the whole batch's."""
    _, jparams, cfg, _ = vlm
    batch = {k: torch.from_numpy(v) for k, v in _vlm_batch(cfg, 12, b, 12).items()}
    out = {}
    for k in (1, 3):
        step, state = _port_step(cfg, jparams, k)
        out[k] = step(state, batch)[1]
    np.testing.assert_allclose(float(out[3]["loss"]), float(out[1]["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(out[3]["grad_norm"]), float(out[1]["grad_norm"]), rtol=RTOL)


def test_trainer_batches_carry_the_jax_vlm_inputs():
    """`build_trainer`'s batch: text positions on every axis and 8 stub
    patch rows from the step's generator, as the JAX CLI's ``batch_fn``."""
    cfg = get_config("qwen2_vl_72b").reduced()
    _, _, step, batch_fn = build_trainer(cfg, batch=2, seq=16, gemm_backend="torch", device="cpu")
    batch = batch_fn(3)
    assert tuple(batch["mrope_positions"].shape) == (3, 2, 16)
    assert torch.equal(batch["mrope_positions"][2, 1], torch.arange(16, dtype=torch.int32))
    want = np.random.default_rng(3).normal(size=(2, 8, cfg.d_model)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(batch["vision_embeds"].numpy(), want)


def test_projections_and_attentions_a_run_makes(vlm, monkeypatch):
    """The launch counts chip_smoke.py holds on the card, counted at the
    call sites: a prefill 6 GEMM-backend products a layer (q, k, v, o, the
    GLU, w_out) and the head, one causal attention a layer; a decode step
    as many products and one cached attention a layer; the vision rows and
    M-RoPE add none."""
    _, _, cfg, model = vlm
    calls = {"gemm": 0, "attend": 0, "cached": 0}

    def counted(fn, key):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    for mod, name in ((attn, "_bmm"), (tl, "_bmm"), (tl, "_bglu"), (transformer, "_bmm")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), "gemm"))
    monkeypatch.setattr(attn, "_attend", counted(attn._attend, "attend"))
    monkeypatch.setattr(attn, "_attend_cached", counted(attn._attend_cached, "cached"))
    tokens, vision, mpos = _inputs(cfg, 9, 2, 10)
    layers = cfg.n_layers
    logits, cache = model.prefill(torch.from_numpy(tokens).long(), cache_len=12,
                                  mrope_positions=torch.from_numpy(mpos), vision_embeds=torch.from_numpy(vision))
    assert calls == {"gemm": 6 * layers + 1, "attend": layers, "cached": 0}
    calls.update(dict.fromkeys(calls, 0))
    model.decode_step(logits.argmax(-1)[:, None], cache, mrope_positions=torch.full((3, 2, 1), 6))
    assert calls == {"gemm": 6 * layers + 1, "attend": 0, "cached": layers}
