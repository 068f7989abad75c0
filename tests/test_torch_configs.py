"""The port's configs against the JAX package's, and the three configs
whose mechanisms the port already had (qwen2-72b: GQA with qkv bias;
stablelm-1.6b: LayerNorm, 25% rotary, MHA; qwen3-moe-30b-a3b: qk-norm and
128 experts top-8, reduced to 8 top-2) run reduced on the CPU.

Every config field by field and ``ARCH_IDS`` itself; for each of the three
reduced models (d_model 64, 4 heads of 16, f32, the JAX package's own
parameters carried across by `convert.params_from_jax`), the prefill's
last-position logits, four decode steps and the loss of a 2 x 12 batch.
Port "sfc_cuda" (the kernels' plain versions) against JAX "sfc_pallas"
(interpret mode), port "torch" against JAX "xla": f32 at rtol 1e-4, atol
1e-5.  Also the products a qwen3-moe run makes, which chip_smoke.py holds
on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS, get_config as j_get_config  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro_torch.configs import ALIASES, ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BACKEND_PAIRS = [("sfc_cuda", "sfc_pallas"), ("torch", "xla")]
PAIR_IDS = lambda p: f"{p[0]}-vs-{p[1]}"  # noqa: E731
NEW_ARCHS = ["qwen2_72b", "stablelm_1_6b", "qwen3_moe_30b_a3b"]
PROMPT, CACHE, DECODE_STEPS = 12, 18, 4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref):
    assert tuple(np.shape(_np(port))) == tuple(np.shape(ref))
    np.testing.assert_allclose(_np(port), _np(ref), rtol=RTOL, atol=ATOL)


def test_arch_ids_are_the_jax_packages():
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 10
    assert set(ALIASES.values()) == set(ARCH_IDS)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_every_config_equals_jax_field_by_field(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert get_config(arch.replace("_", "-")) == cfg
    model = build_model(cfg.reduced(), device="cpu")
    assert type(model).__name__ == type(j_build_model(jcfg.reduced())).__name__


@pytest.fixture(scope="module", params=NEW_ARCHS)
def reduced(request):
    """(arch, JAX config, its parameters from its own init as numpy, the
    port's config and model holding them)."""
    arch = request.param
    jcfg = j_get_config(arch).reduced()
    jparams = jax.tree_util.tree_map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    return arch, jcfg, jparams, cfg, model


def test_trees_convert_both_ways(reduced):
    """The qkv biases, the LayerNorm biases and the expert stacks carry
    across, and back to the same tree bitwise."""
    arch, _, jparams, cfg, model = reduced
    names = set(model.state_dict())
    if arch == "qwen2_72b":
        assert {"layers.0.attn.bq", "layers.0.attn.bk", "layers.0.attn.bv"} <= names
    if arch == "stablelm_1_6b":
        assert {"layers.0.norm1.bias", "final_norm.bias"} <= names and "layers.0.attn.bq" not in names
    if arch == "qwen3_moe_30b_a3b":
        assert tuple(model.layers[0].moe.w_in.shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
        assert "layers.0.attn.q_norm.scale" in names
    back = params_to_jax(model.state_dict(), cfg)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg=str(path))


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=PAIR_IDS)
def test_prefill_decode_and_loss_match_jax(reduced, backends):
    _, jcfg, jparams, cfg, model = reduced
    port_b, jax_b = backends
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab, size=(2, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, size=(DECODE_STEPS, 2, 1)).astype(np.int32)
    batch = {"tokens": prompt, "labels": np.roll(prompt, -1, axis=1)}
    jm = j_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    with j_gemm_backend(jax_b):
        logits, cache = jm.prefill(params, jnp.asarray(prompt), cache_len=CACHE, remat="none")
        want = [np.asarray(logits)]
        for tok in steps:
            logits, cache = jm.decode_step(params, jnp.asarray(tok), cache)
            want.append(np.asarray(logits))
        want_loss = jm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()}, remat="none")
    with gemm_backend(port_b):
        logits, cache = model.prefill(torch.from_numpy(prompt).long(), cache_len=CACHE)
        got = [logits]
        for tok in steps:
            logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache)
            got.append(logits)
        with torch.no_grad():
            loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert cache["index"] == PROMPT + DECODE_STEPS
    for g, w in zip(got, want):
        _close(g, w)
    _close(loss, want_loss)


def test_moe_products_a_run_makes(monkeypatch):
    """The launch counts chip_smoke.py holds on the card for qwen3-moe,
    counted at the call sites: a prefill and a decode step each make 5
    dense products a layer (q, k, v, o and the router) and the head, and 2
    grouped ones a layer (the experts' GLU and w_out); one attention a
    layer."""
    cfg = get_config("qwen3_moe_30b_a3b").reduced()
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    calls = {"gemm": 0, "grouped": 0, "attend": 0, "cached": 0}

    def counted(fn, key):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    for mod, name in ((attn, "_bmm"), (tl, "_bmm"), (tl, "_bglu"), (tmoe, "_bmm"), (transformer, "_bmm")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name), "gemm"))
    for name in ("grouped_glu_matmul", "grouped_matmul"):
        monkeypatch.setattr(tmoe, name, counted(getattr(tmoe, name), "grouped"))
    monkeypatch.setattr(attn, "_attend", counted(attn._attend, "attend"))
    monkeypatch.setattr(attn, "_attend_cached", counted(attn._attend_cached, "cached"))
    layers = cfg.n_layers
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 10))).long()
    logits, cache = model.prefill(tokens, cache_len=12)
    assert calls == {"gemm": 5 * layers + 1, "grouped": 2 * layers, "attend": layers, "cached": 0}
    calls.update(dict.fromkeys(calls, 0))
    model.decode_step(logits.argmax(-1)[:, None], cache)
    assert calls == {"gemm": 5 * layers + 1, "grouped": 2 * layers, "attend": 0, "cached": layers}


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "qwen2-72b", "stablelm-1.6b", "qwen3-moe-30b-a3b"])
def test_serve_cli_serves_the_new_archs_on_the_cpu(arch, capsys):
    """``--reduced --device cpu`` serves each new arch; ``--layers`` cuts
    the depth (the 72B models on one card)."""
    rep = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--layers", "2", "--requests", "3",
                          "--prompt-len", "6", "--max-new", "3", "--backend", "sfc_cuda"])
    assert rep["n_requests"] == 3 and rep["tokens_per_s"] > 0
    assert "[serve] backend=sfc_cuda device=cpu n=3" in capsys.readouterr().out
