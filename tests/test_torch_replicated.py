"""The port's replicated 2.5D form against the JAX package: the partial
products (K4 ``sfc_gemm_pallas``, K5 ``sfc_gemm_batched``) and their layer
sum (K6 ``add_reduce_pallas``), ``sfc_matmul`` / ``sfc_glu_matmul`` with
``fuse=False``, their gradients, and reduced qwen3-4b served on the port's
"replicated" backend against the JAX model on its own replicated rung.

f32 at rtol 1e-4 (atol 1e-5); bf16 at bf16 resolution.  The JAX side runs
as its own tests run it on the CPU (Pallas in interpret mode); the port's
wrappers take their plain versions here because the tensors lie on the
CPU.  The CUDA kernels are held against those plain versions on the card
by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import gemm_backend as jgb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.robust.inject import FaultSpec, fault_injection  # noqa: E402
from repro.robust.ladder import get_registry  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.core import namespaces as tns  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
# bf16: one rounding of the output (2^-8 relative) on either side, plus the
# f32 order of the sums, which can move a value across a rounding boundary
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [None if s is None else (rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _j(x, dtype="float32"):
    return None if x is None else jnp.asarray(x, dtype=JDT[dtype])


def _t(x, dtype="float32"):
    return None if x is None else torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32), np.float32)


def _close(port, ref, dtype="float32"):
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


# ---------------------------------------------------------------------------
# K4 / K5 / K6: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kbf", [1, 2])
@pytest.mark.parametrize("k_layers", [1, 2, 4])
@pytest.mark.parametrize("mode", ["plain", "batched_shared", "batched_per_batch"])
def test_partial_copies_match_pallas(mode, k_layers, kbf, dtype):
    m, k, n = 16, 32, 24
    lead = () if mode == "plain" else (2,)
    a, b = _arrays(0, (*lead, m, k), (2, k, n) if mode == "batched_per_batch" else (k, n))
    kw = dict(bm=8, bn=8, k_layers=k_layers, k_block_factor=kbf)
    jfn = jk.sfc_gemm_pallas if mode == "plain" else jk.sfc_gemm_batched
    want = jfn(_j(a, dtype), _j(b, dtype), interpret=True, **kw)
    got = tk.sfc_gemm_replicated(_t(a, dtype), _t(b, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == tuple(want.shape)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_copies_with_f32_copies_of_bf16_inputs_match_pallas(dtype):
    """The unfused GLU's copies: bf16 inputs, f32 copies (``out_dtype``)."""
    a, b = _arrays(1, (2, 16, 32), (32, 16))
    kw = dict(bm=8, bn=8, k_layers=2, k_block_factor=2, out_dtype=torch.float32)
    want = jk.sfc_gemm_batched(_j(a, dtype), _j(b, dtype), interpret=True, **dict(kw, out_dtype=jnp.float32))
    got = tk.sfc_gemm_replicated(_t(a, dtype), _t(b, dtype), **kw)
    assert got.dtype == torch.float32
    _close(got, want)  # exact products of bf16 inputs, f32 sums: the f32 bar


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_partition_is_the_padded_one(dtype):
    """K = 90, k_layers 2, kbf 4: the JAX package pads K to 96 and splits it
    48 + 42; ceil(90 / 2) would give 45 + 45.  The copies (f32 and bf16,
    rounded per layer) hold the JAX package's split."""
    m, k, n = 16, 90, 16
    a, b = _arrays(2, (m, k), (k, n))
    assert tk.layer_slab(k, 2, 4) == 48
    ap = np.pad(a, ((0, 0), (0, 6)))
    bp = np.pad(b, ((0, 6), (0, 0)))
    want = jk.sfc_gemm_pallas(_j(ap, dtype), _j(bp, dtype), bm=8, bn=8, k_layers=2, k_block_factor=4,
                              interpret=True)
    got = tk.sfc_gemm_replicated(_t(a, dtype), _t(b, dtype), bm=8, bn=8, k_layers=2, k_block_factor=4)
    # one bf16 step of each copy at most: a wrong split moves a copy by
    # whole products
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else dict(rtol=2.0**-8, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got)[0], (a[:, :48] @ b[:48]), rtol=2.0**-7 if dtype != "float32" else RTOL,
                               atol=0.05 if dtype != "float32" else ATOL)


@pytest.mark.parametrize("depth,k_layers,kbf", [(90, 2, 4), (5, 4, 2), (10, 4, 1), (0, 3, 1), (64, 8, 1),
                                                (203, 2, 4), (2560, 8, 1), (9728, 4, 2)])
def test_layer_slabs_are_the_plain_versions_k_chunks(depth, k_layers, kbf):
    """`layer_slab` cuts K where `_k_chunks` (every plain version's sum)
    does, and where the JAX package's padding to k_layers * kbf does."""
    slab = tk.layer_slab(depth, k_layers, kbf)
    chunks = tk._k_chunks(depth, k_layers * kbf)
    kp = math.ceil(depth / (k_layers * kbf)) * k_layers * kbf
    for layer in range(k_layers):
        own = chunks[layer * kbf:(layer + 1) * kbf]
        assert own[0].start == min(layer * slab, depth) and own[-1].stop == min((layer + 1) * slab, depth)
        if kp:
            assert slab == kp // k_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("layers", [1, 2, 3, 4, 9])
def test_add_reduce_matches_pallas(batched, layers, dtype):
    shape = (3, layers, 16, 24) if batched else (layers, 16, 24)
    [c] = _arrays(3, shape)
    want = jk.add_reduce_pallas(_j(c, dtype), bm=8, bn=8, interpret=True)
    got = tk.add_reduce(_t(c, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == tuple(want.shape)
    _close(got, want, dtype)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("layers", [1, 2, 3, 8, 9, 16])
def test_add_reduce_plain_is_the_layer_order_f32_sum(layers, batched):
    """K6's plain version against the sum the kernel computes: an f32 loop
    over the copies in layer order (the kernel is held to that loop
    bitwise on the card)."""
    shape = (2, layers, 5, 40) if batched else (layers, 5, 40)
    [c] = _arrays(layers, shape)
    copies = _t(c)
    acc = torch.zeros(copies.select(-3, 0).shape)
    for layer in range(layers):
        acc = acc + copies.select(-3, layer)
    torch.testing.assert_close(tk.add_reduce_plain(copies), acc, rtol=1e-6, atol=1e-6)


def _k6_slots_covered(cfg, slots):
    """How often each 16-byte slot of one batch element is summed by a
    launch at ``cfg``, by the mapping of `add_reduce_kernel`
    (csrc/sfc_gemm_fused.cu): CTA x's pass p covers the threads x V slots
    from (p x ctas + x) x threads x V, thread t taking base + i x threads
    + t (i < V), while base < slots."""
    per_cta = cfg.threads * cfg.vectors
    passes = math.ceil(slots / (cfg.ctas * per_cta))
    base = (np.arange(passes)[:, None] * cfg.ctas + np.arange(cfg.ctas)[None, :]).ravel() * per_cta
    base = base[base < slots]
    idx = (base[:, None, None] + np.arange(cfg.vectors)[None, :, None] * cfg.threads
           + np.arange(cfg.threads)[None, None, :]).ravel()
    return np.bincount(idx[idx < slots], minlength=slots)


def test_k6_mapping_is_the_kernels():
    """The slot mapping `_k6_slots_covered` simulates is the one written in
    the kernel's source."""
    src = (Path(build.__file__).resolve().parent / "csrc" / "sfc_gemm_fused.cu").read_text()
    assert "for (Idx base = (Idx)blockIdx.x * per_cta; base < slots; base += (Idx)gridDim.x * per_cta)" in src
    assert "per_cta = (Idx)blockDim.x * V" in src
    assert "base + i * (Idx)blockDim.x + t" in src


# qwen3-4b's K6 products (8 copies): decode (4 rows) q, k/v, o / w_out, one
# GLU product (f32 copies), the LM head; prefill (4 x 128 rows) the same
K6_MAIN_PATH = [(0, 4 * 4096, 2), (0, 4 * 1024, 2), (0, 4 * 2560, 2), (0, 4 * 9728, 4), (0, 4 * 151936, 2),
                (4, 128 * 4096, 2), (4, 128 * 1024, 2), (4, 128 * 2560, 2), (4, 128 * 9728, 4)]


@pytest.mark.parametrize("sms", [132, 78])
@pytest.mark.parametrize("elem", [2, 4])
def test_add_reduce_launch_covers_every_vector_once(elem, sms, monkeypatch):
    """`add_reduce_launch` over batches, element counts and copies: its CTAs
    x threads x V cover every 16-byte vector of every batch element
    exactly once (the grid's y is the batch); the CTAs across the batch
    stay under one full wave (2048 threads an SM); 128 threads and V 1, a
    CTA for every 128 vectors up to the cap (so qwen3-4b's decode sums
    spread over 4-76 SMs); and the rule reads nothing but its arguments."""
    # a rule that looked at the card would fail here
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda *a: pytest.fail("the rule read the card"))
    monkeypatch.setattr(tk, "sm_count", lambda *a: pytest.fail("the rule read the card"))
    cases = [(b, mn, elem) for b in (0, 1, 3, 16) for mn in (1, 7, 8, 333, 4096, 38912, 1 << 20)]
    cases += [case for case in K6_MAIN_PATH if case[2] == elem]
    for batch, mn, _ in cases:
        for layers in (1, 2, 3, 4, 8, 9):
            cfg = tk.add_reduce_launch(batch, mn, layers, elem, sms)
            assert cfg == tk.add_reduce_launch(batch, mn, layers, elem, sms)
            b, slots = max(batch, 1), math.ceil(mn * elem / 16)
            assert (cfg.threads, cfg.vectors) == (128, 1)
            cap = max(1, 16 * sms // b)
            assert cfg.ctas == min(math.ceil(slots / 128), cap) and cfg.ctas * b <= max(16 * sms, b)
            assert np.array_equal(_k6_slots_covered(cfg, slots), np.ones(slots, dtype=np.int64)), (batch, mn, layers)
    if elem == 2 and sms == 132:
        # qwen3-4b's decode q, k / v, o at 8 copies: one pass over 16, 4, 10 CTAs
        assert [tk.add_reduce_launch(0, 4 * n, 8, 2, 132).ctas for n in (4096, 1024, 2560)] == [16, 4, 10]


def test_oracles_match_the_jax_oracles():
    a, b, c = _arrays(4, (8, 32), (32, 12), (4, 8, 12))
    _close(tref.partial_k_matmul_ref(_t(a), _t(b), 4), jref.partial_k_matmul_ref(_j(a), _j(b), 4))
    _close(tref.add_reduce_ref(_t(c)), jref.add_reduce_ref(_j(c)))
    # the kernels' plain versions against the oracles
    _close(tk.sfc_gemm_replicated(_t(a), _t(b), bm=8, bn=4, k_layers=4), tref.partial_k_matmul_ref(_t(a), _t(b), 4))
    _close(tk.add_reduce(_t(c)), tref.add_reduce_ref(_t(c)))
    with pytest.raises(ValueError, match="multiple"):
        tref.partial_k_matmul_ref(_t(a), _t(b), 5)


def test_cpu_wrappers_count_nothing_and_check_their_operands():
    a, b, c = _arrays(5, (8, 16), (16, 8), (2, 8, 8))
    counts = (tk.sfc_gemm_replicated.launches, tk.add_reduce.launches)
    tk.sfc_gemm_replicated(_t(a), _t(b), k_layers=2)
    tk.add_reduce(_t(c))
    with tgb.gemm_backend("replicated"):
        tgb.matmul(_t(a), _t(b))
    assert (tk.sfc_gemm_replicated.launches, tk.add_reduce.launches) == counts
    with pytest.raises(ValueError, match="contraction"):
        tk.sfc_gemm_replicated(_t(a), _t(b)[:8])
    with pytest.raises(ValueError, match="knobs"):
        tk.sfc_gemm_replicated(_t(a), _t(b), k_layers=0)
    with pytest.raises(ValueError, match="copies"):
        tk.add_reduce(_t(a))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.sfc_gemm_replicated(_t(a).to("meta"), _t(b).to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.add_reduce(_t(c).to("meta"))


def test_replicated_part_is_a_build_part_of_its_own():
    parts = dict(build._gemm_parts())
    src = (build._CSRC / "sfc_gemm_fused.cu").read_text()
    for dt in ("f32", "bf16"):
        flags = parts[f"sfc_gemm_rep_{dt}"]
        assert "-DSFC_REP=1" in flags
        assert f"-DSFC_REP_ENTRY={build.rep_entry_name('gemm', dt)}" in flags
        assert f"-DSFC_ADD_REDUCE_ENTRY={build.rep_entry_name('add_reduce', dt)}" in flags
    # no other part changes: none of them defines SFC_REP
    assert sum("-DSFC_REP=1" in f for f in parts.values()) == 2
    assert 'extern "C" int SFC_REP_ENTRY(' in src and 'extern "C" int SFC_ADD_REDUCE_ENTRY(' in src
    assert build.rep_entry_name("gemm", "bf16") == "sfc_gemm_replicated_bf16"
    with pytest.raises(ValueError):
        build.rep_entry_name("nt", "f32")


# ---------------------------------------------------------------------------
# the ops layer: sfc_matmul / sfc_glu_matmul with fuse=False
# ---------------------------------------------------------------------------

# (glu, bias, gate_bias, residual, activation, out_scale)
EPILOGUES = [
    (False, False, False, False, None, None),
    (False, True, False, True, "gelu", 0.5),
    (False, True, False, False, "relu", None),
    (True, False, False, False, "silu", None),
    (True, True, True, True, "gelu", 1.5),
]


@pytest.mark.parametrize("glu,has_bias,has_gbias,has_res,act,scale", EPILOGUES)
@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_unfused_matmul_matches_jax(lead, glu, has_bias, has_gbias, has_res, act, scale):
    """Ragged M, N and K (no multiple of the blocks), leading dims, every
    epilogue flag; k_layers 2, kbf 2 (K = 37 pads to 40 in JAX)."""
    m, k, n = 11, 37, 13
    x, w, wg, bias, gbias, res = _arrays(
        6, (*lead, m, k), (k, n), (k, n) if glu else None, (n,) if has_bias else None,
        (n,) if has_gbias else None, (*lead, m, n) if has_res else None)
    kw = dict(out_scale=scale, bm=8, bn=8, k_layers=2, k_block_factor=2, fuse=False)
    if glu:
        want = jops.sfc_glu_matmul(_j(x), _j(wg), _j(w), activation=act, bias=_j(bias), gate_bias=_j(gbias),
                                   residual=_j(res), interpret=True, **kw)
        got = tops.sfc_glu_matmul(_t(x), _t(wg), _t(w), activation=act, bias=_t(bias), gate_bias=_t(gbias),
                                  residual=_t(res), **kw)
    else:
        want = jops.sfc_matmul(_j(x), _j(w), bias=_j(bias), activation=act, residual=_j(res), interpret=True, **kw)
        got = tops.sfc_matmul(_t(x), _t(w), bias=_t(bias), activation=act, residual=_t(res), **kw)
    assert tuple(got.shape) == (*lead, m, n) == tuple(want.shape)
    _close(got, want)


def test_unfused_matmul_per_batch_weights_match_jax():
    x, w, bias = _arrays(7, (3, 16, 24), (3, 24, 20), (20,))
    kw = dict(bias=None, activation="silu", out_scale=0.25, bm=8, bn=8, k_layers=4, k_block_factor=1, fuse=False)
    want = jops.sfc_matmul(_j(x), _j(w), interpret=True, **kw)
    _close(tops.sfc_matmul(_t(x), _t(w), **kw), want)


@pytest.mark.parametrize("glu", [False, True])
def test_unfused_bf16_partition_case_matches_jax(glu):
    """bf16 at K = 90, k_layers 2, kbf 4, where the layer boundary (48, not
    45) changes the per-layer rounding of the copies; bias, gelu, scale and
    residual in the epilogue after the sum (the JAX package's double
    rounding: copies in bf16 (the GLU's in f32), the epilogue in f32, one
    cast)."""
    m, k, n = 12, 90, 20
    x, w, wg, bias, res = _arrays(8, (2, m, k), (k, n), (k, n), (n,), (2, m, n))
    kw = dict(bias=bias, residual=res, out_scale=0.75, bm=8, bn=8, k_layers=2, k_block_factor=4, fuse=False)
    if glu:
        want = jops.sfc_glu_matmul(_j(x, "bfloat16"), _j(wg, "bfloat16"), _j(w, "bfloat16"), interpret=True,
                                   **{key: _j(v, "bfloat16") if isinstance(v, np.ndarray) else v for key, v in kw.items()})
        got = tops.sfc_glu_matmul(_t(x, "bfloat16"), _t(wg, "bfloat16"), _t(w, "bfloat16"),
                                  **{key: _t(v, "bfloat16") if isinstance(v, np.ndarray) else v for key, v in kw.items()})
    else:
        want = jops.sfc_matmul(_j(x, "bfloat16"), _j(w, "bfloat16"), activation="gelu", interpret=True,
                               **{key: _j(v, "bfloat16") if isinstance(v, np.ndarray) else v for key, v in kw.items()})
        got = tops.sfc_matmul(_t(x, "bfloat16"), _t(w, "bfloat16"), activation="gelu",
                              **{key: _t(v, "bfloat16") if isinstance(v, np.ndarray) else v for key, v in kw.items()})
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("vecs", [False, True])
def test_unfused_preact_matches_jax(vecs):
    """The training forward of an unfused GLU: the two biased
    pre-activations from two products with f32 copies, each cast once."""
    x, wv, wg, bias, gbias = _arrays(9, (2, 9, 20), (20, 12), (20, 12), (12,), (12,))
    kw = dict(gate_bias=None, residual=None, activation=None, out_scale=None, bm=8, bn=8, k_layers=2,
              k_block_factor=1, out_dtype=None, preact=True, fuse=False)
    b_, g_ = (bias, gbias) if vecs else (None, None)
    want = jops._matmul_impl(_j(x), _j(wv), _j(wg), interpret=True, **dict(kw, bias=_j(b_), gate_bias=_j(g_)))
    got = tops._matmul_impl(_t(x), _t(wv), _t(wg), **dict(kw, bias=_t(b_), gate_bias=_t(g_)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError, match="preact"):
        tops._matmul_impl(_t(x), _t(wv), None, **dict(kw, bias=None))


@pytest.mark.parametrize("glu", [False, True])
def test_unfused_gradients_match_jax(glu):
    """torch autograd through `_MatmulCore` with ``fuse=False`` (the
    replicated forward, the NT / TN backward) against ``jax.grad`` of the
    JAX package's ``fuse=False`` call."""
    x, w, wg, bias, res, ct = _arrays(10, (2, 10, 24), (24, 16), (24, 16), (16,), (2, 10, 16), (2, 10, 16))
    kw = dict(bm=8, bn=8, k_layers=2, k_block_factor=2, fuse=False)

    def j_loss(x_, w_, wg_, b_, r_):
        if glu:
            y = jops.sfc_glu_matmul(x_, wg_, w_, activation="silu", bias=b_, residual=r_, interpret=True, **kw)
        else:
            y = jops.sfc_matmul(x_, w_, bias=b_, activation="gelu", out_scale=0.5, residual=r_, interpret=True, **kw)
        return jnp.sum(y * jnp.asarray(ct))

    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(*map(_j, (x, w, wg, bias, res)))
    ins = [_t(v).requires_grad_(True) for v in (x, w, wg, bias, res)]
    if glu:
        y = tops.sfc_glu_matmul(ins[0], ins[2], ins[1], activation="silu", bias=ins[3], residual=ins[4], **kw)
    else:
        y = tops.sfc_matmul(ins[0], ins[1], bias=ins[3], activation="gelu", out_scale=0.5, residual=ins[4], **kw)
    assert isinstance(y.grad_fn, tops._MatmulCore._backward_cls)
    (y * _t(ct)).sum().backward()
    for i, (t, jg) in enumerate(zip(ins, want)):
        if i == 2 and not glu:
            assert t.grad is None
            continue
        _close(t.grad, jg)


def test_knob_defaults_fill_unset_knobs_only():
    assert tops.resolve_knobs(16, 16, 16, "cpu")[2:] == (1, 1)
    with tops.knob_defaults(k_layers=8, k_block_factor=2):
        assert tops.resolve_knobs(16, 16, 16, "cpu")[2:] == (8, 2)
        assert tops.resolve_knobs(16, 16, 16, "cpu", k_layers=2)[2:] == (2, 2)
        with tops.knob_defaults(k_layers=4):
            assert tops.resolve_knobs(16, 16, 16, "cpu")[2:] == (4, 1)
    assert tops.resolve_knobs(16, 16, 16, "cpu")[2:] == (1, 1)
    with pytest.raises(ValueError, match="at least 1"):
        with tops.knob_defaults(k_layers=0):
            pass
    # under the defaults the unfused product is still the JAX package's
    x, w = _arrays(11, (12, 40), (40, 8))
    want = jops.sfc_matmul(_j(x), _j(w), bm=4, bn=8, k_layers=8, k_block_factor=1, fuse=False, interpret=True)
    with tops.knob_defaults(k_layers=8):
        _close(tops.sfc_matmul(_t(x), _t(w), bm=4, bn=8, fuse=False), want)


# ---------------------------------------------------------------------------
# the "replicated" backend and the slice as a whole
# ---------------------------------------------------------------------------


def test_replicated_backend_is_the_fourth_backend():
    assert tns.BACKEND_REPLICATED == "replicated" and "replicated" in tns.BACKENDS
    x, w, wg, bias, res = _arrays(12, (2, 5, 24), (24, 16), (24, 16), (16,), (2, 5, 16))
    kw = dict(bias=_j(bias), residual=_j(res))
    want = jops.sfc_matmul(_j(x), _j(w), activation="relu", fuse=False, interpret=True, **kw)
    want_glu = jops.sfc_glu_matmul(_j(x), _j(wg), _j(w), fuse=False, interpret=True, **kw)
    with tgb.gemm_backend("replicated"):
        got = tgb.matmul(_t(x), _t(w), bias=_t(bias), activation="relu", residual=_t(res))
        got_glu = tgb.glu_matmul(_t(x), _t(wg), _t(w), bias=_t(bias), residual=_t(res))
        # decode-shaped (B, 1, K) flattens to (B, K), as under sfc_cuda
        dec = tgb.matmul(_t(x[:, :1]), _t(w))
    _close(got, want)
    _close(got_glu, want_glu)
    _close(dec, x[:, :1] @ w)


PROMPT, CACHE, DECODE_STEPS = 12, 20, 4


@pytest.fixture(scope="module")
def jax_replicated_reference():
    """Reduced qwen3-4b (2 layers), its JAX params, and the JAX model's
    prefill and decode logits on the replicated rung: ``sfc_pallas`` with
    the fused gemm / glu rungs failed at compile time, traced afresh inside
    the injection (it acts at trace time)."""
    cfg = dataclasses.replace(j_get_config("qwen3_4b").reduced(), n_layers=2)
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, cfg.vocab, size=(2, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, size=(DECODE_STEPS, 2, 1)).astype(np.int32)
    faults = (FaultSpec("gemm", kind="compile", rungs=("sfc_pallas",)),
              FaultSpec("glu", kind="compile", rungs=("sfc_pallas",)))
    get_registry().reset()
    try:
        with fault_injection(*faults) as state, jgb.gemm_backend("sfc_pallas"):
            prefill = jax.jit(lambda p, t: model.prefill(p, t, cache_len=CACHE, remat="none"))
            decode = jax.jit(lambda p, t, c: model.decode_step(p, t, c))
            logits, cache = prefill(params, jnp.asarray(prompt))
            outs = [np.asarray(logits)]
            for tok in steps:
                logits, cache = decode(params, jnp.asarray(tok), cache)
                outs.append(np.asarray(logits))
        quarantined = set(get_registry().quarantined_namespaces())
        fired = {namespace for namespace, *_ in state.fired}
    finally:
        get_registry().reset()
    return cfg.n_layers, jax.tree_util.tree_map(np.asarray, params), prompt, steps, outs, quarantined, fired


def test_reduced_model_on_the_replicated_backend_matches_jax_replicated_rung(jax_replicated_reference):
    n_layers, jparams, prompt, steps, want, quarantined, fired = jax_replicated_reference
    assert n_layers == 2
    # the JAX model really left its fused rungs for the replicated one
    assert {"gemm", "glu"} <= fired and {"gemm", "glu"} <= quarantined
    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), n_layers=n_layers)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, device="cpu"))
    with tgb.gemm_backend("replicated"), torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(prompt).long(), cache_len=CACHE)
        got = [logits]
        for tok in steps:
            logits, cache = model.decode_step(torch.from_numpy(tok).long(), cache)
            got.append(logits)
    assert cache["index"] == PROMPT + DECODE_STEPS
    for g, w in zip(got, want):
        _close(g, w)


def test_serving_engine_on_the_replicated_backend_matches_jax_tokens():
    """A short serve of reduced qwen3-4b on the CPU: ServingEngine with
    gemm_backend="replicated" (and the serve CLI's choice) completes every
    request with the JAX engine's greedy tokens."""
    jcfg = j_get_config("qwen3_4b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("qwen3_4b").reduced()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab, size=8).astype(np.int32) for _ in range(3)]
    jengine = JServingEngine(jcfg, jparams, max_batch=2, max_seq=16, gemm_backend="xla")
    want = {tuple(r.prompt.tolist()): r.output for r in jengine.run(jengine.submit_many(prompts, max_new_tokens=4))}
    engine = ServingEngine(cfg, params, max_batch=2, max_seq=16, gemm_backend="replicated", device="cpu")
    done = engine.run(engine.submit_many(prompts, max_new_tokens=4))
    assert len(done) == 3
    for r in done:
        assert r.status == "completed" and r.output == want[tuple(r.prompt.tolist())]
    with pytest.raises(ValueError, match="unknown gemm backend"):
        ServingEngine(cfg, params, gemm_backend="sfc_pallas", device="cpu")


@pytest.mark.parametrize("k_layers", [None, 4])
def test_replicated_serve_calls_only_the_replicated_kernels(monkeypatch, k_layers):
    """Every projection of a serve on "replicated" is one K4 / K5 call (the
    GLU two), followed by one K6 call only when its product is split, and
    nothing reaches the fused kernel: the counts chip_smoke.py holds the
    card's serve to (252 K5 and 3,796 K4 at full width), here per layer
    and step of reduced qwen3-4b on the CPU."""
    calls = {"K4": 0, "K5": 0, "K6": 0, "K1/K2": 0}
    rep, red = tops.sfc_gemm_replicated, tops.add_reduce

    def counting_rep(a, b, **kw):
        calls["K5" if a.ndim == 3 else "K4"] += 1
        return rep(a, b, **kw)

    def counting_red(c):
        calls["K6"] += 1
        return red(c)

    def no_fused(*args, **kw):
        calls["K1/K2"] += 1
        raise AssertionError("the replicated backend reached the fused kernel")

    monkeypatch.setattr(tops, "sfc_gemm_replicated", counting_rep)
    monkeypatch.setattr(tops, "add_reduce", counting_red)
    monkeypatch.setattr(tops, "sfc_gemm_fused", no_fused)
    cfg = get_config("qwen3_4b").reduced()
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    engine = ServingEngine(cfg, model.state_dict(), max_batch=4, max_seq=24, gemm_backend="replicated", device="cpu")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, size=10).astype(np.int32) for _ in range(4)]
    new = 4
    with tops.knob_defaults(k_layers=k_layers):
        done = engine.run(engine.submit_many(prompts, max_new_tokens=new))
    assert all(r.status == "completed" and len(r.output) == new for r in done)
    per_layer = 7  # q, k, v, o, the GLU's two products, w_out
    want = {"K5": cfg.n_layers * per_layer, "K4": cfg.n_layers * per_layer * (new - 1) + new, "K1/K2": 0}
    want["K6"] = 0 if k_layers is None else want["K5"] + want["K4"]
    assert calls == want
