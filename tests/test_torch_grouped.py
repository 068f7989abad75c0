"""The port's grouped (MoE expert) GEMMs against the JAX package: the task
tables byte-identical; the plain versions of K3 (`sfc_gemm_grouped`), K9
(`sfc_gemm_grouped_nt`) and K10 (`sfc_gemm_grouped_tn`) against the Pallas
kernels in interpret mode, on ragged expert sizes with an empty expert;
the ops layer and the GEMM backend's grouped entry points against the JAX
ops and backends; and the grouped gradients against ``jax.grad``.

Tolerances: f32 rtol 1e-4 (atol 1e-5); bf16 inputs within one output
rounding, ``2^-7 |ref| + 1e-3 max|ref|`` (both sides accumulate in f32 and
round once, in different orders).  The JAX kernels take each expert's rows
padded to whole row blocks; the port's take them packed, so the tests pad
for the JAX side only and compare the real rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import gemm_backend as jgb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5

# (group_sizes, k, n, dtype): tests/test_kernels.py's GROUPED_CASES
GROUPED_CASES = [
    ((5, 0, 19, 32), 24, 18, "float32"),  # ragged incl. empty expert
    ((5, 0, 19, 32), 24, 18, "bfloat16"),
    ((16, 16), 32, 32, "float32"),  # uniform, divisible
    ((1, 2, 3), 7, 9, "float32"),  # tiny odd dims
]
BM = BN = 16


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [None if s is None else (rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _pair(x, dtype):
    """(torch tensor, jax array) holding the same values in ``dtype``."""
    if x is None:
        return None, None
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


def _close(got, want, dtype):
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    else:
        bound = 2.0**-7 * np.abs(w) + 1e-3 * np.abs(w).max()
        assert np.all(np.abs(g - w) <= bound), float(np.max(np.abs(g - w) - bound))


def _round_up(x, m):
    return -(-x // m) * m


def _pad_rows(x, gs, unit, cols):
    """The JAX kernels' packing: each expert's rows padded to a ``unit``
    multiple (empty experts take no rows), the columns padded to ``cols``."""
    slabs, off = [], 0
    for g in gs:
        if g:
            slab = jnp.zeros((_round_up(g, unit), cols), x.dtype).at[:g, : x.shape[1]].set(x[off:off + g])
            slabs.append(slab)
        off += g
    return jnp.concatenate(slabs), tuple(_round_up(g, unit) // unit for g in gs)


def _unpad_rows(out, gs, unit, n):
    parts, off = [], 0
    for g in gs:
        parts.append(np.asarray(out[off:off + g, :n], np.float32))
        off += _round_up(g, unit)
    return np.concatenate(parts)


def _pad3(w, k, n):
    return jnp.pad(w, ((0, 0), (0, k - w.shape[1]), (0, n - w.shape[2])))


@pytest.mark.parametrize("row_blocks,nb", [((2, 0, 3), 4), ((1,), 1), ((0, 0), 3), ((3, 1, 0, 2), 5)])
def test_grouped_task_tables_are_byte_identical_to_jax(row_blocks, nb):
    got = tk.build_grouped_task_table(row_blocks, nb)
    want = jk.build_grouped_task_table(row_blocks, nb)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    got_tn = tk.build_grouped_tn_task_table(row_blocks, 3, nb)
    want_tn = jk.build_grouped_tn_task_table(row_blocks, 3, nb)
    assert got_tn.dtype == want_tn.dtype and got_tn.tobytes() == want_tn.tobytes()


@pytest.mark.parametrize("form", ["linear", "glu_silu", "glu_preact", "bias_relu_scaled"])
@pytest.mark.parametrize("group_sizes,k,n,dtype", GROUPED_CASES)
def test_grouped_plain_version_matches_pallas_kernel(group_sizes, k, n, dtype, form):
    """K3's plain version against ``repro.kernels.sfc_gemm.sfc_gemm_grouped``
    in interpret mode: every epilogue form the MoE path and the VJP use."""
    e = len(group_sizes)
    glu = form.startswith("glu")
    a, b, bg, bias, gbias = _arrays(sum(group_sizes) + k + n, (sum(group_sizes), k), (e, k, n),
                                    (e, k, n) if glu else None, (e, n) if form != "linear" else None,
                                    (e, n) if form == "glu_preact" else None)
    (ta, ja), (tb, jb), (tbg, jbg), (tbias, jbias), (tgb_, jgbias) = (_pair(x, dtype) for x in (a, b, bg, bias, gbias))
    kw = {"linear": {}, "glu_silu": dict(activation="silu"), "glu_preact": dict(preact=True),
          "bias_relu_scaled": dict(activation="relu", out_scale=0.5)}[form]
    kp, np_ = _round_up(k, 8), _round_up(n, BN)
    a_p, row_blocks = _pad_rows(ja, group_sizes, BM, kp)
    pad_vec = (lambda v: None if v is None else jnp.pad(v, ((0, 0), (0, np_ - n))).reshape(e, 1, np_))
    want = jk.sfc_gemm_grouped(a_p, _pad3(jb, kp, np_), None if jbg is None else _pad3(jbg, kp, np_),
                               pad_vec(jbias), pad_vec(jgbias), row_blocks=row_blocks, bm=BM, bn=BN,
                               k_block_factor=kp // 8, interpret=True, preact_out=kw.get("preact", False),
                               activation=kw.get("activation"), out_scale=kw.get("out_scale"))
    got = tk.sfc_gemm_grouped_plain(ta, tb, tbg, tbias, tgb_, group_sizes=group_sizes, bm=BM, bn=BN,
                                    k_block_factor=kp // 8, **kw)
    if form == "glu_preact":
        for g, w in zip(got, want):
            _close(g, _unpad_rows(w, group_sizes, BM, n), dtype)
    else:
        assert got.dtype == getattr(torch, dtype)
        _close(got, _unpad_rows(want, group_sizes, BM, n), dtype)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("group_sizes,k,n,dtype", GROUPED_CASES)
def test_grouped_nt_plain_version_matches_pallas_kernel(group_sizes, k, n, dtype, dual):
    """K9's plain version against ``sfc_gemm_grouped_nt``: dA[rows of e] =
    dC_e @ W[e]ᵀ (+ the dual GLU pair), W read as stored (E, N, K)."""
    e = len(group_sizes)
    t = sum(group_sizes)
    a, b, a2, b2 = _arrays(t + 2 * k, (t, k), (e, n, k), (t, k) if dual else None, (e, n, k) if dual else None)
    (ta, ja), (tb, jb), (ta2, ja2), (tb2, jb2) = (_pair(x, dtype) for x in (a, b, a2, b2))
    kp, np_ = _round_up(k, 8), _round_up(n, BN)
    a_p, row_blocks = _pad_rows(ja, group_sizes, BM, kp)
    a2_p = _pad_rows(ja2, group_sizes, BM, kp)[0] if dual else None
    pad_w = (lambda w: None if w is None else jnp.pad(w, ((0, 0), (0, np_ - n), (0, kp - k))))
    want = jk.sfc_gemm_grouped_nt(a_p, pad_w(jb), a2_p, pad_w(jb2), row_blocks=row_blocks, bm=BM, bn=BN,
                                  k_block_factor=kp // 8, interpret=True)
    got = tk.sfc_gemm_grouped_nt_plain(ta, tb, ta2, tb2, group_sizes=group_sizes, bm=BM, bn=BN,
                                       k_block_factor=kp // 8)
    assert got.shape == (t, n) and got.dtype == getattr(torch, dtype)
    _close(got, _unpad_rows(want, group_sizes, BM, n), dtype)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("group_sizes,k,n,dtype", GROUPED_CASES)
def test_grouped_tn_plain_version_matches_pallas_kernel(group_sizes, k, n, dtype, dual):
    """K10's plain version (dW mode) against ``sfc_gemm_grouped_tn``: dW[e]
    = A_eᵀ @ dC_e per expert, the ragged contraction bounded by each
    expert's rows, an empty expert's stack exactly zero."""
    t = sum(group_sizes)
    a, b, b2 = _arrays(t + k + n, (t, k), (t, n), (t, n) if dual else None)
    (ta, ja), (tb, jb), (tb2, jb2) = (_pair(x, dtype) for x in (a, b, b2))
    row_block = tk.grouped_tn_row_block(group_sizes)
    kp, np_ = _round_up(k, BM), _round_up(n, BN)
    a_p, row_blocks = _pad_rows(ja, group_sizes, row_block, kp)
    b_p = _pad_rows(jb, group_sizes, row_block, np_)[0]
    b2_p = _pad_rows(jb2, group_sizes, row_block, np_)[0] if dual else None
    want = jk.sfc_gemm_grouped_tn(a_p, b_p, b2_p, row_blocks=row_blocks, row_block=row_block, bm=BM, bn=BN,
                                  interpret=True)
    got = tk.sfc_gemm_grouped_tn_plain(ta, tb, tb2, group_sizes=group_sizes, bm=BM, bn=BN, row_block=row_block)
    for g, w in zip(got if dual else [got], want if dual else [want]):
        assert g.shape == (len(group_sizes), k, n) and g.dtype == getattr(torch, dtype)
        _close(g, np.asarray(w, np.float32)[:, :k, :n], dtype)
    for e, size in enumerate(group_sizes):
        if size == 0:
            assert not bool((got[0] if dual else got)[e].any())


@pytest.mark.parametrize("group_sizes,k,n,dtype", GROUPED_CASES)
def test_grouped_ops_match_jax_ops(group_sizes, k, n, dtype):
    """`ops.sfc_grouped_matmul` / `_glu_matmul` / `_nt` / `_tn` against the
    JAX ops at the same blocks (the JAX side pads, the port masks)."""
    e, t = len(group_sizes), sum(group_sizes)
    a, w, wg, bias, dc, dc2 = _arrays(7 + t, (t, k), (e, k, n), (e, k, n), (e, n), (t, n), (t, n))
    (ta, ja), (tw, jw), (twg, jwg), (tbias, jbias), (tdc, jdc), (tdc2, jdc2) = (
        _pair(x, dtype) for x in (a, w, wg, bias, dc, dc2))
    blocks = dict(bm=BM, bn=BN)
    _close(tops.sfc_grouped_matmul(ta, tw, group_sizes, bias=tbias, activation="gelu", **blocks),
           jops.sfc_grouped_matmul(ja, jw, group_sizes, bias=jbias, activation="gelu", interpret=True,
                                   **blocks), dtype)
    _close(tops.sfc_grouped_glu_matmul(ta, twg, tw, group_sizes, **blocks),
           jops.sfc_grouped_glu_matmul(ja, jwg, jw, group_sizes, interpret=True, **blocks), dtype)
    # dA = dC @ W[e]ᵀ: the (E, K, N) weights as stored are the NT operand
    _close(tops.sfc_grouped_matmul_nt(tdc, tw, group_sizes, tdc2, twg),
           jops.sfc_grouped_matmul_nt(jdc, jw, group_sizes, jdc2, jwg, interpret=True), dtype)
    got = tops.sfc_grouped_matmul_tn(ta, tdc, group_sizes, tdc2)
    want = jops.sfc_grouped_matmul_tn(ja, jdc, group_sizes, jdc2, interpret=True)
    for g, w_ in zip(got, want):
        _close(g, w_, dtype)


def _buffer(seed, g, e, c, k):
    return _arrays(seed, (g, e, c, k))[0]


@pytest.mark.parametrize("backend", ["torch", "sfc_cuda", "sfc_reference"])
def test_backend_grouped_entry_points_match_jax(backend):
    """`gemm_backend.grouped_matmul` / `grouped_glu_matmul` under every
    port backend against the JAX package's "xla" and "sfc_pallas"
    backends, on a (G, E, C, K) dispatch buffer."""
    g, e, c, k, n = 2, 4, 5, 24, 40
    x, w, wg, wo, bias = _arrays(3, (g, e, c, k), (e, k, n), (e, k, n), (e, n, k), (e, n), scale=0.5)
    jx, jw, jwg, jwo, jbias = map(jnp.asarray, (x, w, wg, wo, bias))
    tx, tw, twg, two, tbias = map(torch.from_numpy, (x, w, wg, wo, bias))
    with tgb.gemm_backend(backend):
        got_glu = tgb.grouped_glu_matmul(tx, twg, tw)
        got = tgb.grouped_matmul(got_glu, two)
        got_epi = tgb.grouped_matmul(tx, tw, bias=tbias, activation="silu", out_scale=0.5)
    for jname in ("xla", "sfc_pallas"):
        with jgb.gemm_backend(jname):
            want_glu = jgb.grouped_glu_matmul(jx, jwg, jw)
            want = jgb.grouped_matmul(want_glu, jwo)
            want_epi = jgb.grouped_matmul(jx, jw, bias=jbias, activation="silu", out_scale=0.5)
        assert tuple(got.shape) == (g, e, c, k)
        _close(got_glu, want_glu, "float32")
        _close(got, want, "float32")
        _close(got_epi, want_epi, "float32")


@pytest.mark.parametrize("glu", [False, True])
def test_grouped_gradients_match_jax(glu):
    """`_GroupedCore` (K3 forward, K9 / K10 backward, per-expert bias sums)
    against ``jax.grad`` of the JAX ops under interpret, on ragged sizes
    with an empty expert."""
    gs, k, n = (5, 0, 19, 32), 24, 18
    e, t = len(gs), sum(gs)
    a, w, wg, bias, gbias, cot = _arrays(11, (t, k), (e, k, n), (e, k, n), (e, n), (e, n), (t, n), scale=0.5)

    def jloss(a_, w_, wg_, bias_, gbias_):
        if glu:
            y = jops.sfc_grouped_glu_matmul(a_, wg_, w_, gs, bias=bias_, gate_bias=gbias_, bm=BM, bn=BN,
                                            interpret=True)
        else:
            y = jops.sfc_grouped_matmul(a_, w_, gs, bias=bias_, activation="gelu", bm=BM, bn=BN, interpret=True)
        return jnp.sum(y * jnp.asarray(cot))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (a, w, wg, bias, gbias)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, w, wg, bias, gbias)]
    if glu:
        y = tops.sfc_grouped_glu_matmul(ts[0], ts[2], ts[1], gs, bias=ts[3], gate_bias=ts[4], bm=BM, bn=BN)
    else:
        y = tops.sfc_grouped_matmul(ts[0], ts[1], gs, bias=ts[3], activation="gelu", bm=BM, bn=BN)
    (y * torch.from_numpy(cot)).sum().backward()
    names = ("a", "w", "w_gate", "bias", "gate_bias")
    for name, tx, w_ in zip(names, ts, want):
        if not glu and name in ("w_gate", "gate_bias"):
            assert tx.grad is None
            continue
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(w_), rtol=RTOL, atol=ATOL, err_msg=name)
    assert not bool(ts[1].grad[1].any())  # the empty expert's weights get a zero gradient


def test_grouped_wrappers_count_nothing_on_cpu_and_refuse_the_update_mode():
    a, w = torch.ones(6, 8), torch.ones(2, 8, 4)
    before = (tk.sfc_gemm_grouped.launches, tk.sfc_gemm_grouped_nt.launches, tk.sfc_gemm_grouped_tn.launches)
    out = tk.sfc_gemm_grouped(a, w, group_sizes=(2, 4), activation="relu")
    assert torch.equal(out, torch.full((6, 4), 8.0))
    tk.sfc_gemm_grouped_nt(out, w, group_sizes=(2, 4))
    dw = tk.sfc_gemm_grouped_tn(a, out, group_sizes=(0, 6))
    assert not bool(dw[0].any()) and torch.equal(dw[1], torch.full((8, 4), 48.0))
    assert (tk.sfc_gemm_grouped.launches, tk.sfc_gemm_grouped_nt.launches,
            tk.sfc_gemm_grouped_tn.launches) == before
    with pytest.raises(ValueError, match="sum to"):
        tk.sfc_gemm_grouped(a, w, group_sizes=(2, 3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.sfc_gemm_grouped(a.to("meta"), w.to("meta"), group_sizes=(2, 4))
    with pytest.raises(NotImplementedError, match="update mode"):
        tk.sfc_gemm_grouped_tn(a, out, master=torch.zeros(2, 8, 4), group_sizes=(2, 4))
