"""The port's grouped (MoE expert) GEMMs against the JAX package: the task
tables byte-identical; the plain versions of K3 (`sfc_gemm_grouped`), K9
(`sfc_gemm_grouped_nt`) and K10 (`sfc_gemm_grouped_tn`, its dW, update and
norm modes) against the Pallas kernels in interpret mode, on ragged expert
sizes with an empty expert; the ops layer and the GEMM backend's grouped
entry points against the JAX ops and backends; and the grouped gradients
against ``jax.grad``.

Tolerances: f32 rtol 1e-4 (atol 1e-5); bf16 inputs within one output
rounding, ``2^-7 |ref| + 1e-3 max|ref|`` (both sides accumulate in f32 and
round once, in different orders).  K10's update mode at the bar of K8's
(test_torch_fused_optimizer.py): tile seeds and stochastic-rounding bits
byte-identical; master, mu, nu
and the norm at rtol 1e-5, atol 1e-6 (dW summed in another order); a bf16
W bitwise the rounding of the port's own master with its bits, and within
one bf16 ulp of JAX's.  Only at bm = bn = 64 are the JAX tile coordinates
the card's, so the update tests run there.  The JAX kernels take each
expert's rows padded to whole row blocks; the port's take them packed, so
the tests pad for the JAX side only and compare the real rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import gemm_backend as jgb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

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
    """The wrappers count nothing on the CPU, and the update and norm
    modes refuse what they do not take: state of the wrong shape or type,
    a missing second set or hyper vector, state in the norm mode."""
    a, w = torch.ones(6, 8), torch.ones(2, 8, 4)
    before = (tk.sfc_gemm_grouped.launches, tk.sfc_gemm_grouped_nt.launches, tk.sfc_gemm_grouped_tn.launches)
    out = tk.sfc_gemm_grouped(a, w, group_sizes=(2, 4), activation="relu")
    assert torch.equal(out, torch.full((6, 4), 8.0))
    tk.sfc_gemm_grouped_nt(out, w, group_sizes=(2, 4))
    dw = tk.sfc_gemm_grouped_tn(a, out, group_sizes=(0, 6))
    assert not bool(dw[0].any()) and torch.equal(dw[1], torch.full((8, 4), 48.0))
    hyper = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(1, dtype=torch.int32), torch.tensor(1.0))
    st = [torch.zeros(2, 8, 4) for _ in range(3)]
    tk.sfc_gemm_grouped_tn(a, out, None, *st, hyper=hyper, w=torch.zeros(2, 8, 4), group_sizes=(2, 4))
    tk.sfc_gemm_grouped_tn(a, out, group_sizes=(2, 4), norm=True)
    assert (tk.sfc_gemm_grouped.launches, tk.sfc_gemm_grouped_nt.launches,
            tk.sfc_gemm_grouped_tn.launches) == before
    with pytest.raises(ValueError, match="sum to"):
        tk.sfc_gemm_grouped(a, w, group_sizes=(2, 3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.sfc_gemm_grouped(a.to("meta"), w.to("meta"), group_sizes=(2, 4))
    with pytest.raises(ValueError, match=r"\(2, 8, 4\)"):  # a 2-D weight's state for an expert stack
        tk.sfc_gemm_grouped_tn(a, out, None, *[x[0] for x in st], hyper=hyper, w=torch.zeros(8, 4),
                               group_sizes=(2, 4))
    with pytest.raises(ValueError, match="w must be"):  # W in another type than the activations
        tk.sfc_gemm_grouped_tn(a, out, None, *st, hyper=hyper, w=torch.zeros(2, 8, 4, dtype=torch.bfloat16),
                               group_sizes=(2, 4))
    with pytest.raises(ValueError, match="missing"):  # the GLU pair's second set
        tk.sfc_gemm_grouped_tn(a, out, out, *st, hyper=hyper, w=torch.zeros(2, 8, 4), group_sizes=(2, 4))
    with pytest.raises(ValueError, match="norm mode"):
        tk.sfc_gemm_grouped_tn(a, out, None, *st, hyper=hyper, w=torch.zeros(2, 8, 4), group_sizes=(2, 4),
                               norm=True)


# ---------------------------------------------------------------------------
# K10's update and norm modes against the interpreted Pallas kernel
# ---------------------------------------------------------------------------

UPD_GROUPS, UPD_K, UPD_N = (5, 0, 19, 32), 100, 130  # ragged experts, one empty; ragged K, N at 64 x 64
SALT, STEP = (3 << 16) + 2, 11


def _hypers(scale, step=STEP, salt=SALT):
    """The same (12,) hyper vector for both packages; JAX's carries the
    salt in its lane, the port's takes it as an argument."""
    jh = jadamw.pack_adamw_hyper(jadamw.AdamWConfig(), jnp.int32(step), jnp.float32(scale))
    jh = jh.at[jadamw.HYP_SALT].set(jadamw.seed_to_lane(jnp.int32(salt)))
    th = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(step, dtype=torch.int32), torch.tensor(scale))
    return jh, th


def _update_case(seed, gs, k, n, dual, dtype):
    """(port operands, JAX operands, f32 state sets as numpy) of a grouped
    update: the activations and cotangents hold the same values in
    ``dtype`` on both sides; master, mu and nu a later step's."""
    e, t = len(gs), sum(gs)
    a, b, b2 = _arrays(seed, (t, k), (t, n), (t, n))
    rng = np.random.default_rng(seed + 1)
    sets = [[(rng.standard_normal((e, k, n)) * c).astype(np.float32) for c in (0.02, 0.1, 0.3)]
            for _ in range(2 if dual else 1)]
    for st in sets:
        st[2] = st[2] ** 2
    pairs = [_pair(x, dtype) for x in (a, b, b2 if dual else None)]
    return [p[0] for p in pairs], [p[1] for p in pairs], sets


def _port_update(fn, ops, sets, th, dtype, sr, gs, **kw):
    """Run the port's grouped update ``fn`` on copies of ``sets``; returns
    (norms, [(master, mu, nu) per set], [W per set])."""
    state = [[torch.from_numpy(x.copy()) for x in st] for st in sets]
    ws = [torch.zeros(st[0].shape, dtype=getattr(torch, dtype)) for st in sets]
    dual = len(sets) == 2
    norms = fn(*ops, *state[0], *(state[1] if dual else [None] * 3), th, group_sizes=gs, w=ws[0],
               w2=ws[1] if dual else None, salt=SALT, stochastic_round=sr, **kw)
    return norms, state, ws


def _jax_update(jops_, sets, jh, dtype, sr, gs):
    """JAX ``sfc_grouped_matmul_tn_update`` under interpret at the card's
    tile, one (W, master, mu, nu, norm) per set."""
    ja, jb, jb2 = jops_
    dual = len(sets) == 2
    out = jops.sfc_grouped_matmul_tn_update(
        ja, jb, gs, *map(jnp.asarray, sets[0]), jh, jb2, *(map(jnp.asarray, sets[1]) if dual else [None] * 3),
        param_dtype=getattr(jnp, dtype), stochastic_round=sr, row_block=8, bm=64, bn=64, interpret=True)
    return out if dual else (out,)


@pytest.mark.parametrize("scale", [1.0, 0.37, 0.0])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype,sr", [("float32", False), ("bfloat16", True), ("bfloat16", False)])
def test_grouped_tn_update_plain_matches_jax_kernel(dtype, sr, dual, scale):
    """`sfc_gemm_grouped_tn_plain` in update mode against JAX
    ``sfc_grouped_matmul_tn_update(..., bm=64, bn=64, row_block=8,
    interpret=True)`` on the same dW inputs: ragged experts with an empty
    one (its g = 0 update), ragged K and N, single and dual; scale 0 keeps
    the state bitwise."""
    jh, th = _hypers(scale)
    ops, jops_, sets = _update_case(3, UPD_GROUPS, UPD_K, UPD_N, dual, dtype)
    want = _jax_update(jops_, sets, jh, dtype, sr, UPD_GROUPS)
    norms, got, ws = _port_update(tk.sfc_gemm_grouped_tn_plain, ops, sets, th, dtype, sr, UPD_GROUPS,
                                  bm=64, bn=64, row_block=8)
    assert norms.shape == (len(sets),)
    dt = getattr(torch, dtype)
    for s, (orig, st, w, (jw, jm, ju, jv, jn)) in enumerate(zip(sets, got, ws, want)):
        np.testing.assert_allclose(float(norms[s]), float(jn), rtol=1e-5)
        for g, w_ in zip(st, (jm, ju, jv)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-6)
        if scale == 0.0:
            for g, o in zip(st, orig):
                assert np.array_equal(g.numpy(), o)
            assert torch.equal(w, st[0].to(dt))
            continue
        # the empty expert took the g = 0 update: its moments decayed
        assert not np.array_equal(st[1][1].numpy(), orig[1][1])
        jwf = np.asarray(jw.astype(jnp.float32))
        if sr:
            bits = tk._grouped_tile_bits(len(UPD_GROUPS), UPD_K, UPD_N, 64, 64, th, SALT, s)
            assert torch.equal(w, tk.stochastic_round_to(st[0], bits, dt))
            wf = w.float().numpy()
            assert np.all(np.abs(wf - jwf) <= 2.0**-7 * np.maximum(np.abs(wf), np.abs(jwf)))
        else:
            np.testing.assert_allclose(w.float().numpy(), jwf, rtol=1e-5 if dtype == "float32" else 2.0**-8,
                                       atol=1e-6)


def test_grouped_tile_seeds_and_bits_are_byte_identical_to_jax():
    """The grouped flush's per-tile seed (`_tile_seed` with the expert lane
    2e + set, hashed for expert 0 and set 0 too) and each element's bits
    against JAX's ``_tile_seed(hyp, im, in, 2e + set)`` and
    ``tile_random_bits`` over each 64 x 64 tile, byte for byte."""
    e, k, n = 3, 100, 130
    for step, salt in ((11, SALT), (-5, 0), (2**31 - 1, -7)):
        jh, th = _hypers(1.0, step, salt)
        for s in (0, 1):
            got = tk._grouped_tile_bits(e, k, n, 64, 64, th, salt, s).numpy()
            for ex in range(e):
                for im in range(2):
                    for in_ in range(3):
                        seed = jk._tile_seed(jh, jnp.int32(im), jnp.int32(in_), jnp.int32(2 * ex + s))
                        want_seed = int(np.uint32(seed))
                        assert int(tk._tile_seed(th, salt, im, in_, 2 * ex + s)) == want_seed
                        bits = np.asarray(jk.tile_random_bits((64, 64), seed, hw_rng=False)).astype(np.int64)
                        tile = got[ex, im * 64:(im + 1) * 64, in_ * 64:(in_ + 1) * 64]
                        assert np.array_equal(tile, bits[:tile.shape[0], :tile.shape[1]]), (step, s, ex, im, in_)


@pytest.mark.parametrize("dual", [False, True])
def test_grouped_norm_mode_sum_equals_the_update_norm(dual):
    """K10's norm mode returns the update mode's norms bitwise (the same
    tiles, summed in the same table order), and the ops layer's grouped
    norm is the sum of each expert's ``|A_eᵀ dC_e|²``."""
    gs, k, n = (7, 0, 12), 40, 24
    ops, _, sets = _update_case(4, gs, k, n, dual, "float32")
    _, th = _hypers(0.5)
    upd, _, _ = _port_update(tk.sfc_gemm_grouped_tn, ops, sets, th, "float32", False, gs)
    norm = tk.sfc_gemm_grouped_tn(*ops, group_sizes=gs, norm=True)
    assert torch.equal(norm, upd)
    got = tops.sfc_grouped_matmul_tn_norm(ops[0], ops[1], gs, ops[2])
    parts = [torch.split(x, list(gs)) for x in ops if x is not None]
    want = [sum(float((a_.T @ d).square().sum()) for a_, d in zip(parts[0], p)) for p in parts[1:]]
    np.testing.assert_allclose([float(x) for x in (got if dual else [got])], want, rtol=1e-5)
    # the ops layer's update: the same norms, the state written in place
    state = [torch.from_numpy(x.copy()) for x in sets[0]]
    w = torch.zeros(sets[0][0].shape)
    sq = tops.sfc_grouped_matmul_tn_update(ops[0], ops[1], gs, *state, th, w=w, salt=SALT)
    np.testing.assert_allclose(float(sq), want[0], rtol=1e-5)
    assert torch.equal(w, state[0]) and not np.array_equal(state[0].numpy(), sets[0][0])


@pytest.mark.parametrize("dtype,sr", [("float32", False), ("bfloat16", True)])
def test_empty_dispatch_matches_jax_g0_update(dtype, sr):
    """A dispatch with no rows at all: the port runs every expert's g = 0
    update (moment decay and weight decay) through the kernel's path, the
    JAX ops through their elementwise fallback; the state agrees at rtol
    1e-5, an f32 W is the new master, a bf16 W the port's own rounding of
    it and within one ulp of JAX's (whose fallback hashes the whole leaf)."""
    gs, k, n = (0, 0, 0), 72, 40
    jh, th = _hypers(0.8)
    ops, jops_, sets = _update_case(5, gs, k, n, False, dtype)
    ((jw, jm, ju, jv, jn),) = _jax_update(jops_, sets, jh, dtype, sr, gs)
    norms, (st,), (w,) = _port_update(tk.sfc_gemm_grouped_tn, ops[:2] + [None], sets, th, dtype, sr, gs)
    assert float(norms[0]) == float(jn) == 0.0
    for g, w_ in zip(st, (jm, ju, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-6)
    assert not np.array_equal(st[1].numpy(), sets[0][1])
    dt = getattr(torch, dtype)
    if sr:
        bits = tk._grouped_tile_bits(len(gs), k, n, 64, 64, th, SALT, 0)
        assert torch.equal(w, tk.stochastic_round_to(st[0], bits, dt))
        wf, jwf = w.float().numpy(), np.asarray(jw.astype(jnp.float32))
        assert np.all(np.abs(wf - jwf) <= 2.0**-7 * np.maximum(np.abs(wf), np.abs(jwf)))
    else:
        assert torch.equal(w, st[0].to(dt))


def test_plain_update_of_an_expert_stack_matches_jax_oracle():
    """The oracle backends' grouped update (`ops.plain_update` on an (E, K,
    N) stack; JAX ``_jnp_update``): one hash over the stack's (E·K, N) rows."""
    rng = np.random.default_rng(6)
    dw, mst, mu = (rng.standard_normal((3, 20, 24)).astype(np.float32) * c for c in (1.0, 0.02, 0.1))
    nu = (rng.standard_normal((3, 20, 24)).astype(np.float32) * 0.3) ** 2
    jh, th = _hypers(0.8, step=4)
    jw, jm, ju, jv, jsq = jops._jnp_update(*map(jnp.asarray, (dw, mst, mu, nu)), jh, param_dtype=jnp.bfloat16,
                                           stochastic_round=True)
    state = [torch.from_numpy(x.copy()) for x in (mst, mu, nu)]
    w = torch.zeros((3, 20, 24), dtype=torch.bfloat16)
    sq = tops.plain_update(torch.from_numpy(dw), *state, w, th, salt=SALT, stochastic_round=True)
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-6)
    for g, want in zip(state, (jm, ju, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.array_equal(w.float().numpy(), np.asarray(jw.astype(jnp.float32)))


@pytest.mark.parametrize("glu", [False, True])
def test_grouped_update_core_hands_the_tape_its_operands(glu):
    """`_GroupedUpdateCore` (the fused branch): the forward and dA of
    `_GroupedCore`, the per-expert bias gradient, no gradient for the
    stacks, and ``(a, dh, dg, group_sizes)`` to the sink, whose K10 dW is
    `_GroupedCore`'s; the oracle (``fused=False``) hands each stack's
    plain autograd dW to its sink."""
    gs, k, n = (5, 0, 19, 32), 24, 18
    e, t = len(gs), sum(gs)
    a, w, wg, bias, cot = _arrays(12, (t, k), (e, k, n), (e, k, n), (e, n), (t, n), scale=0.5)
    ref = [torch.from_numpy(x).requires_grad_(True) for x in (a, w, wg, bias)]
    if glu:
        y = tops.sfc_grouped_glu_matmul(ref[0], ref[2], ref[1], gs, bm=BM, bn=BN)
    else:
        y = tops.sfc_grouped_matmul(ref[0], ref[1], gs, bias=ref[3], activation="gelu", bm=BM, bn=BN)
    (y * torch.from_numpy(cot)).sum().backward()
    seen = []
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, w, wg, bias)]
    if glu:
        out = tops.fused_update_grouped_glu_matmul(ts[0], ts[2], ts[1], gs, lambda *args: seen.append(args))
    else:
        out = tops.fused_update_grouped_matmul(ts[0], ts[1], gs, lambda *args: seen.append(args), bias=ts[3],
                                               activation="gelu")
    np.testing.assert_allclose(out.detach().numpy(), y.detach().numpy(), rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ts[0].grad.numpy(), ref[0].grad.numpy(), rtol=RTOL, atol=ATOL)
    assert ts[1].grad is None and ts[2].grad is None
    if not glu:
        np.testing.assert_allclose(ts[3].grad.numpy(), ref[3].grad.numpy(), rtol=RTOL, atol=ATOL)
    ((a_, dh, dg, got_gs),) = seen
    assert got_gs == gs and (dg is not None) == glu
    with torch.no_grad():
        dws = tops.sfc_grouped_matmul_tn(a_, dh, gs, dg)
    for dw, want in zip(dws if glu else [dws], (ref[1].grad, ref[2].grad)):
        np.testing.assert_allclose(dw.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    # the oracle: plain autograd dW into each stack's sink
    got = {}
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (a, w, wg, bias)]
    if glu:
        out = tops.fused_update_grouped_glu_matmul(ts[0], ts[2], ts[1], gs, (
            lambda d: got.__setitem__("w", d), lambda d: got.__setitem__("wg", d)), fused=False)
    else:
        out = tops.fused_update_grouped_matmul(ts[0], ts[1], gs, lambda d: got.__setitem__("w", d), bias=ts[3],
                                               activation="gelu", fused=False)
    (out * torch.from_numpy(cot)).sum().backward()
    assert ts[1].grad is None and ts[2].grad is None
    for name, want in (("w", ref[1].grad), ("wg", ref[2].grad))[:2 if glu else 1]:
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
