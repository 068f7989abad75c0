"""The port's layers and dense decoder against the JAX package at f32
rtol 1e-4 (atol 1e-5), plus the port's import boundary."""

import ast
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.gemm_backend import gemm_backend as j_gemm_backend  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_rmsnorm_and_layernorm_match_jax():
    x, scale, bias = _rand(0, 3, 5, 64), _rand(1, 64), _rand(2, 64)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    _close(tl.layernorm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias)),
           jl.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x)))


@pytest.mark.parametrize("rotary_pct,theta", [(1.0, 10000.0), (0.25, 1_000_000.0)])
def test_apply_rope_matches_jax(rotary_pct, theta):
    x = _rand(3, 2, 7, 4, 16)
    pos = np.random.default_rng(4).integers(0, 4096, size=(2, 7)).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta, rotary_pct=rotary_pct)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta, rotary_pct=rotary_pct)
    _close(got, want)


@pytest.mark.parametrize(
    "s,t,h,hkv,qc,kc,causal,q_offset",
    [
        (16, 16, 4, 4, 4, 4, True, 0),
        (13, 13, 4, 2, 4, 8, True, 0),  # ragged chunks, GQA
        (8, 24, 4, 1, 4, 8, True, 16),  # chunked prefill against a cache
        (10, 7, 2, 2, 4, 4, False, 0),
    ],
)
def test_blockwise_attention_matches_jax(s, t, h, hkv, qc, kc, causal, q_offset):
    q, k, v = _rand(5, 2, s, h, 16), _rand(6, 2, t, hkv, 16), _rand(7, 2, t, hkv, 16)
    kw = dict(causal=causal, q_chunk=qc, k_chunk=kc, q_offset=q_offset)
    got = tl.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jl.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want)


def test_decode_attention_matches_jax():
    q, k, v = _rand(8, 3, 1, 8, 16), _rand(9, 3, 20, 2, 16), _rand(10, 3, 20, 2, 16)
    valid = np.array([1, 11, 20], np.int32)
    got = tl.decode_attention(*map(torch.from_numpy, (q, k, v, valid)))
    want = jl.decode_attention(*map(jnp.asarray, (q, k, v, valid)))
    _close(got, want)


PROMPT, CACHE, DECODE_STEPS = 12, 20, 4


@pytest.fixture(scope="module", params=["qwen3_4b", "yi_6b"])
def jax_reference(request):
    """Reduced config, JAX params from its own init, and the JAX package's
    prefill + 4 decode-step logits under sfc_pallas (Pallas interpreted)."""
    arch = request.param
    cfg = j_get_config(arch).reduced()
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab, size=(2, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, size=(DECODE_STEPS, 2, 1)).astype(np.int32)
    with j_gemm_backend("sfc_pallas"):
        prefill = jax.jit(lambda p, t: model.prefill(p, t, cache_len=CACHE, remat="none"))
        decode = jax.jit(model.decode_step)
        logits, cache = prefill(params, jnp.asarray(prompt))
        outs = [np.asarray(logits)]
        for tok in steps:
            logits, cache = decode(params, jnp.asarray(tok), cache)
            outs.append(np.asarray(logits))
    return arch, jax.tree_util.tree_map(np.asarray, params), prompt, steps, outs


@pytest.mark.parametrize("backend", ["sfc_cuda", "sfc_reference", "torch"])
def test_reduced_model_prefill_and_decode_match_jax(jax_reference, backend):
    arch, jparams, prompt, steps, want = jax_reference
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    with gemm_backend(backend):
        logits, cache = model.prefill(torch.from_numpy(prompt).long(), cache_len=CACHE)
        got = [logits]
        for tok in steps:
            logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache)
            got.append(logits)
    assert cache["index"] == PROMPT + DECODE_STEPS
    assert tuple(cache["k"].shape) == (cfg.n_layers, 2, CACHE, cfg.kv_heads, cfg.head_dim_)
    for g, w in zip(got, want):
        _close(g, w)


def test_forward_logits_match_jax(jax_reference):
    arch, jparams, prompt, _, _ = jax_reference
    jcfg = j_get_config(arch).reduced()
    want, _ = j_build_model(jcfg).forward(jax.tree_util.tree_map(jnp.asarray, jparams),
                                          jnp.asarray(prompt), remat="none")
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    with gemm_backend("sfc_cuda"), torch.no_grad():
        got, aux = model.forward(torch.from_numpy(prompt).long())
    _close(got, want)
    assert float(aux["moe_aux_loss"]) == 0.0


def test_init_is_seeded_and_shaped_like_jax():
    cfg = get_config("qwen3_4b").reduced()
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert torch.all(a.layers[0].attn.q_norm.scale == 1)
    std = float(a.layers[1].mlp.w_gate.detach().std())
    assert math.isclose(std, 0.02, rel_tol=0.2)
    jparams = j_build_model(j_get_config("qwen3_4b").reduced()).init(jax.random.PRNGKey(0))
    converted = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in converted.items()} == {k: tuple(v.shape) for k, v in a.state_dict().items()}


def test_unported_model_options_raise():
    cfg = get_config("qwen3_4b").reduced()
    # every family is ported: MoE layers (tests/test_torch_moe.py), M-RoPE
    # and the VLM family (tests/test_torch_vlm.py); a family no model has raises
    mrope = build_model(dataclasses.replace(cfg, mrope_sections=(2, 3, 3)), device="cpu")
    assert type(mrope).__name__ == "DecoderLM" and mrope.cfg.mrope_sections == (2, 3, 3)
    moe = build_model(dataclasses.replace(cfg, family="moe", n_experts=4, moe_top_k=2), device="cpu")
    assert tuple(moe.layers[0].moe.w_in.shape) == (4, cfg.d_model, cfg.d_ff)
    # the hybrid, xLSTM ("ssm") and audio families are ported
    # (tests/test_torch_hybrid.py, test_torch_xlstm.py, test_torch_encdec.py),
    # and a dense config is no xLSTM
    hybrid = build_model(get_config("zamba2_1_2b").reduced(), device="cpu")
    assert type(hybrid).__name__ == "HybridLM" and len(hybrid.groups) == 2
    assert type(build_model(get_config("xlstm_1_3b").reduced(), device="cpu")).__name__ == "XLSTMLM"
    assert type(build_model(get_config("seamless_m4t_medium").reduced(), device="cpu")).__name__ == "EncDecLM"
    with pytest.raises(ValueError, match="XLSTMLM needs"):
        build_model(dataclasses.replace(cfg, family="ssm"), device="cpu")
    vlm = build_model(get_config("qwen2_vl_72b").reduced(), device="cpu")
    assert type(vlm).__name__ == "DecoderLM" and vlm.cfg.family == "vlm"
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(dataclasses.replace(cfg, family="vision"), device="cpu")


def test_build_model_without_device_raises_where_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3_4b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").embed.device.type == "cpu"


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """AST check over src/repro_torch, chip_smoke.py and the port's card
    scripts, then a fresh interpreter that imports every port module must
    not load jax or repro."""
    for path in _port_files() + sorted((ROOT / "scripts").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
    modules = [
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in _port_files()[:-1]
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
