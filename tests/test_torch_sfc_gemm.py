"""The port's fused SFC GEMM, its ops layer, the Listing-1 reference and the
GEMM backend switch against the JAX package, at f32 rtol 1e-4 (atol 1e-5).

The JAX side runs as its own tests run it on the CPU: Pallas in interpret
mode.  The port's wrapper takes its plain version here because the tensors
lie on the CPU; the CUDA kernel itself is held against that plain version on
the card by ``tests/test_torch_kernels.py`` (and by ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import gemm_backend as jgb  # noqa: E402
from repro.core.sfc_gemm import sfc_ca_gemm_reference as j_reference  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.core.sfc_gemm import sfc_ca_gemm_reference as t_reference  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.kernels.ref import matmul_ref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [None if s is None else (rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL, atol=ATOL)


# (glu, bias, gate_bias, residual, activation, out_scale)
EPILOGUES = [
    (False, False, False, False, None, None),
    (False, True, False, False, "relu", None),
    (False, True, False, True, "gelu", 0.5),
    (True, False, False, False, "silu", None),
    (True, True, True, True, "gelu", 1.5),
    (True, True, False, False, None, None),
]


@pytest.mark.parametrize("glu,has_bias,has_gbias,has_res,act,scale", EPILOGUES)
@pytest.mark.parametrize("mode", ["plain", "batched"])
def test_fused_wrapper_matches_pallas(mode, glu, has_bias, has_gbias, has_res, act, scale):
    bsz, m, k, n = 2, 32, 64, 48
    lead = (bsz,) if mode == "batched" else ()
    a, b, bg, bias, gbias, res = _arrays(
        0, (*lead, m, k), (k, n), (k, n) if glu else None,
        (1, n) if has_bias else None, (1, n) if has_gbias else None,
        (*lead, m, n) if has_res else None,
    )
    kw = dict(activation=act, out_scale=scale, bm=16, bn=16, k_layers=2, k_block_factor=2)
    jfn = jk.sfc_gemm_batched_fused if mode == "batched" else jk.sfc_gemm_fused
    want = jfn(*map(_j, (a, b, bg, bias, gbias, res)), interpret=True, **kw)
    got = tk.sfc_gemm_fused(*map(_t, (a, b, bg, bias, gbias, res)), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_fused_wrapper_per_batch_weights_match_pallas():
    a, b, bias, res = _arrays(1, (3, 16, 32), (3, 32, 24), (24,), (3, 16, 24))
    kw = dict(activation="silu", out_scale=0.25, bm=8, bn=8, k_layers=1, k_block_factor=4)
    want = jk.sfc_gemm_batched_fused(_j(a), _j(b), None, _j(bias).reshape(1, 24), None, _j(res),
                                     interpret=True, **kw)
    _close(tk.sfc_gemm_fused(_t(a), _t(b), None, _t(bias), None, _t(res), **kw), want)


def test_plain_version_clips_ragged_edges():
    # ragged M/N/K: the kernel masks its edge tiles, the plain version clips them
    a, b, bg, bias, res = _arrays(2, (2, 37, 50), (50, 70), (50, 70), (70,), (2, 37, 70))
    got = tk.sfc_gemm_fused_plain(_t(a), _t(b), _t(bg), _t(bias), None, _t(res), activation="gelu",
                                  out_scale=0.5, bm=16, bn=32, k_layers=2, k_block_factor=3)
    want = jops._epilogue_jnp(
        jnp.einsum("bmk,kn->bmn", a, b), gate=jnp.einsum("bmk,kn->bmn", a, bg), bias=bias,
        activation="gelu", out_scale=0.5, residual=res,
    )
    _close(got, want)


@pytest.mark.parametrize(
    "a_shape,b_shape",
    [
        ((37, 50), (50, 70)),  # ragged M/N/K, 2-D
        ((2, 3, 19, 24), (24, 40)),  # leading dims folded into one batch axis
        ((3, 16, 24), (3, 24, 40)),  # per-batch weights
        ((4, 33), (33, 151)),  # decode-shaped, ragged N
    ],
)
@pytest.mark.parametrize("epilogue", ["none", "bias_silu_residual", "relu_scale"])
def test_sfc_matmul_matches_pallas_ops(a_shape, b_shape, epilogue):
    n = b_shape[-1]
    a, b, bias, res = _arrays(3, a_shape, b_shape, (n,), (*a_shape[:-1], n))
    kw = {}
    if epilogue == "bias_silu_residual":
        kw = dict(activation="silu")
    elif epilogue == "relu_scale":
        kw = dict(activation="relu", out_scale=0.75)
        bias = res = None
    else:
        bias = res = None
    want = jops.sfc_matmul(_j(a), _j(b), bias=_j(bias), residual=_j(res), interpret=True, **kw)
    got = tops.sfc_matmul(_t(a), _t(b), bias=_t(bias), residual=_t(res), **kw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("a_shape", [(21, 40), (2, 9, 40), (4, 1, 40)])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_sfc_glu_matmul_matches_pallas_ops(a_shape, act):
    a, bg, bv, bias, gbias, res = _arrays(4, a_shape, (40, 56), (40, 56), (56,), (56,), (*a_shape[:-1], 56))
    kw = dict(activation=act, out_scale=2.0)
    want = jops.sfc_glu_matmul(_j(a), _j(bg), _j(bv), bias=_j(bias), gate_bias=_j(gbias),
                               residual=_j(res), interpret=True, **kw)
    got = tops.sfc_glu_matmul(_t(a), _t(bg), _t(bv), bias=_t(bias), gate_bias=_t(gbias),
                              residual=_t(res), **kw)
    _close(got, want)


@pytest.mark.parametrize(
    "m,n,k,knobs",
    [
        (32, 32, 32, dict(bm=8, bn=8, bk=8)),
        (64, 48, 64, dict(bm=16, bn=16, bk=8, k_layers=2, k_block_factor=2)),
        (16, 64, 96, dict(bm=16, bn=32, bk=16, k_layers=3, k_block_factor=2)),
    ],
)
def test_listing1_reference_matches_jax(m, n, k, knobs):
    a, b = _arrays(5, (m, k), (k, n))
    _close(t_reference(_t(a), _t(b), **knobs), j_reference(_j(a), _j(b), **knobs))
    _close(matmul_ref(_t(a), _t(b)), j_reference(_j(a), _j(b), **knobs))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", None])
def test_activation_matches_jax(name):
    (x,) = _arrays(6, (257,), scale=4.0)
    _close(tk.activation_fn(name)(_t(x)), jk.activation_fn(name)(_j(x)))


@pytest.mark.parametrize("backend", ["torch", "sfc_cuda", "sfc_reference"])
@pytest.mark.parametrize("x_shape", [(24,), (6, 24), (3, 1, 24), (2, 5, 24)])
def test_gemm_backend_matches_jax(backend, x_shape):
    x, w, wg, bias, res = _arrays(7, x_shape, (24, 40), (24, 40), (40,), (*x_shape[:-1], 40))
    with jgb.gemm_backend("xla"):
        want = jgb.matmul(_j(x), _j(w), bias=_j(bias), activation="gelu", out_scale=0.5, residual=_j(res))
        want_glu = jgb.glu_matmul(_j(x), _j(wg), _j(w), bias=_j(bias), residual=_j(res))
    with tgb.gemm_backend(backend):
        assert tgb.current_backend() == backend
        got = tgb.matmul(_t(x), _t(w), bias=_t(bias), activation="gelu", out_scale=0.5, residual=_t(res))
        got_glu = tgb.glu_matmul(_t(x), _t(wg), _t(w), bias=_t(bias), residual=_t(res))
    assert tgb.current_backend() == "torch"
    _close(got, want)
    _close(got_glu, want_glu)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    a, b = _arrays(8, (4, 16), (16, 16))
    before = tk.sfc_gemm_fused.launches
    tk.sfc_gemm_fused(_t(a), _t(b))
    with tgb.gemm_backend("sfc_cuda"):
        tgb.matmul(_t(a), _t(b))
    assert tk.sfc_gemm_fused.launches == before


def test_unported_options_and_bad_operands_raise():
    a, b, bg = (_t(x) for x in _arrays(9, (8, 16), (16, 8), (16, 8)))
    # the replicated form (fuse=False) is ported: the JAX package's unfused
    # result (tests/test_torch_replicated.py holds it against JAX in full)
    _close(tops.sfc_matmul(a, b, fuse=False, k_layers=2), a @ b)
    # the ABFT check is ported (tests/test_torch_abft.py holds it in full):
    # on a clean product "detect" returns what "off" does, fused or not
    for fuse in (False, None):
        assert torch.equal(tops.sfc_matmul(a, b, fuse=fuse, abft="detect"), tops.sfc_matmul(a, b, fuse=fuse))
    # preact (the training forward of a GLU) is ported: the (h_pre, g_pre)
    # pair of the JAX package's _matmul_impl(..., preact=True)
    x, wv, wg, bias, gbias = _arrays(9, (2, 8, 16), (16, 24), (16, 24), (24,), (24,))
    kw = dict(bias=None, gate_bias=None, residual=None, activation=None, out_scale=None, bm=None, bn=None,
              k_layers=None, k_block_factor=None, out_dtype=None, preact=True)
    for vecs in ((None, None), (bias, gbias)):
        kw.update(bias=vecs[0], gate_bias=vecs[1])
        want = jops._matmul_impl(_j(x), _j(wv), _j(wg), interpret=True, fuse=None,
                                 **{k: _j(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
        got = tops._matmul_impl(_t(x), _t(wv), _t(wg), **{k: _t(v) if isinstance(v, np.ndarray) else v
                                                          for k, v in kw.items()})
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _close(g, w)
    with pytest.raises(ValueError, match="preact"):
        tops._matmul_impl(a, b, bg, **dict(kw, bias=None, gate_bias=None, activation="silu"))
    # the TN kernel's update mode (the fused AdamW flush) is ported: it
    # needs W beside master, mu, nu and the (12,) hyper vector
    with pytest.raises(ValueError, match="update mode"):
        tk.sfc_gemm_tn(a, a, master=b, mu=b, nu=b, hyper=torch.zeros(12))
    # the TN kernel's checksum lane is ported: (dW, its (1, 1) raw sum)
    dw, chk = tk.sfc_gemm_tn(a, a, abft=True)
    assert torch.equal(dw, tk.sfc_gemm_tn(a, a)) and tuple(chk.shape) == (1, 1)
    np.testing.assert_allclose(float(chk[0, 0]), float(dw.sum()), rtol=RTOL, atol=ATOL * float((a.T.abs() @ a.abs()).sum()))
    with pytest.raises(ValueError):
        tops.sfc_matmul(a, b[:8])
    with pytest.raises(ValueError):
        tops.sfc_matmul(a, b, bias=torch.zeros(3))
    with pytest.raises(ValueError):
        tops.sfc_glu_matmul(a[None], bg, b[None].expand(1, 16, 8))
    with pytest.raises(ValueError):
        tk.sfc_gemm_fused(a, b, activation="tanh")
    with pytest.raises(ValueError):
        tk.sfc_gemm_fused(a, b, None, None, torch.zeros(8))  # gate_bias without GLU
    with pytest.raises(ValueError):
        with tgb.gemm_backend("xla"):
            pass


def test_matmuls_that_need_a_gradient_run_through_the_autograd_function():
    """With an input that needs a gradient, sfc_matmul and sfc_glu_matmul
    return the output of the port's autograd Function (whose backward runs
    the NT/TN kernels, their plain versions here); under no_grad they keep
    the single fused call and carry no graph."""
    a, w, wg = _arrays(10, (3, 5, 16), (16, 24), (16, 24))
    x = _t(a).requires_grad_(True)
    out = tops.sfc_matmul(x, _t(w), activation="gelu")
    glu = tops.sfc_glu_matmul(_t(a), _t(wg), _t(w).requires_grad_(True))
    for y in (out, glu):
        assert isinstance(y.grad_fn, tops._MatmulCore._backward_cls)
    with torch.no_grad():
        assert tops.sfc_matmul(x, _t(w)).grad_fn is None
    assert tops.sfc_matmul(_t(a), _t(w)).grad_fn is None
    out.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


# ---------------------------------------------------------------------------
# K1 at M <= 16 on the card: split-K across a cluster (its choices and sum)
# ---------------------------------------------------------------------------

H100_SMS = 132  # the card the cluster kernel is sized for


def test_cluster_layers_are_a_function_of_the_shape_and_the_card():
    """L at qwen3-4b's and olmoe-1b-7b's decode products: every slab of the
    K partition non-empty and at least 256 rows deep (L > 1), L at most
    the cluster limit."""
    from repro_torch.kernels import build

    table = {  # (K, N): L
        (2560, 4096): 4, (2560, 1024): 8, (4096, 2560): 8, (2560, 9728): 2, (9728, 2560): 8,  # q, k/v, o, GLU, w_out
        (2560, 151936): 1,  # the LM head
        (2048, 2048): 8, (2048, 64): 8, (2048, 50304): 1,  # olmoe's q/k/v/o, router, LM head
        (203, 133): 1, (1000, 133): 2,  # ragged
    }
    for (k, n), want in table.items():
        layers = tk.cluster_layers(k, n, H100_SMS)
        slab = tk.layer_slab(k, layers)
        assert layers == want, (k, n, layers)
        assert 1 <= layers <= build.MAX_CLUSTER_LAYERS
        assert (layers - 1) * slab < k <= layers * slab  # no empty slab
        assert layers == 1 or slab >= 256


@pytest.mark.parametrize("k", [203, 1000, 2056, 2560, 9728])
def test_cluster_slabs_are_the_plain_versions_layer_chunks(k):
    """CTA l of a cluster runs K rows [l * slab, (l + 1) * slab) clipped to K
    (slab = layer_slab(K, L)): the chunks over which sfc_gemm_fused_plain
    with k_layers=L sums, in the same order."""
    for layers in (1, 2, 4, 8):
        slab = tk.layer_slab(k, layers)
        kernel = [slice(min(l * slab, k), min((l + 1) * slab, k)) for l in range(layers)]
        assert kernel == tk._k_chunks(k, layers)


# (glu, bias, gate_bias, residual, activation, out_scale, preact)
_CLUSTER_EPILOGUES = [e + (False,) for e in EPILOGUES] + [(True, True, True, False, None, None, True)]


@pytest.mark.parametrize("glu,has_bias,has_gbias,has_res,act,scale,preact", _CLUSTER_EPILOGUES)
@pytest.mark.parametrize("m", [1, 4, 16])
def test_plain_summed_by_cluster_layers_matches_pallas(m, glu, has_bias, has_gbias, has_res, act, scale, preact):
    """The cluster kernel's arithmetic: each K slab's product in f32, the
    slabs added in layer order, then the epilogue once; against the JAX
    package's fused kernel over the same K layers (interpret mode)."""
    k, n = 1024, 48
    layers = tk.cluster_layers(k, n, H100_SMS)
    assert layers == 4
    a, b, bg, bias, gbias, res = _arrays(
        11, (m, k), (k, n), (k, n) if glu else None,
        (1, n) if has_bias else None, (1, n) if has_gbias else None, (m, n) if has_res else None, scale=0.1,
    )
    kw = dict(activation=act, out_scale=scale, k_layers=layers)
    want = jk.sfc_gemm_fused(*map(_j, (a, b, bg, bias, gbias, res)), bm=m, bn=16, interpret=True,
                             preact_out=preact, **kw)
    got = tk.sfc_gemm_fused_plain(*map(_t, (a, b, bg, bias, gbias, res)), bm=64, bn=64, preact=preact, **kw)
    for g, w in zip(got if preact else (got,), want if preact else (want,)):
        assert tuple(g.shape) == (m, n)
        _close(g, w)
