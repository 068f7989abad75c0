"""The port's chunked-recurrence routing and Mamba2 block against the JAX
package, on the CPU (the kernels' plain versions; JAX's Pallas calls in
interpret mode under "sfc_pallas"):

- `chunk_einsum`, all four signatures, port "sfc_cuda" against JAX
  "sfc_pallas" and port "torch" against JAX "xla": f32 inputs at rtol
  1e-4 (atol 1e-5: sums of 16-24 products of unit normals that cancel);
  bf16 inputs to bf16 resolution (|d| <= 2^-7 |ref| + 2^-7, one output
  rounding apart: the two sum in other orders), the f32-output signatures
  (the SSD scores, the mLSTM qk block) at f32 output, where the only
  difference left is the order of the f32 sums (rtol 1e-5, atol 1e-5);
  the unknown-signature error with JAX's message;
- `chunk_gemm_plan`'s namespace and knobs, byte-identical to JAX's;
- K2's plain version on bf16 inputs with f32 output (per-batch B, with and
  without its checksum lane) against JAX's ``sfc_gemm_batched_fused(...,
  out_dtype=jnp.float32, interpret=True)``, and the card's refusal of an
  epilogue with it (host-side check);
- ``ssd_chunked`` (ragged lengths, several chunks, with and without an
  initial state and the returned state), ``ssd_decode_step``, the causal
  conv, ``softplus``, ``mamba2_forward`` (with and without a state, one
  that continues another included) and ``mamba2_decode``: f32 at rtol
  1e-4, atol 1e-5 (outputs of order 0.1-10; sums of 8-16 products in
  another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import gemm_backend as jgb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.core import gemm_backend as gb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 2.0**-7

# operand shapes of each signature: several chunks / heads, extents that
# are no multiple of the kernels' tiles
SIGNATURES = {
    "blhp,bjhp->bljh": ((2, 24, 3, 16), (2, 24, 3, 16)),
    "bljh,bjhp->blhp": ((2, 24, 24, 3), (2, 24, 3, 16)),
    "bcin,bcjn->bcij": ((2, 4, 24, 16), (2, 4, 24, 16)),
    "bcijh,bcjhp->bcihp": ((1, 2, 24, 24, 3), (1, 2, 24, 3, 16)),
}
# the signatures whose callers ask for f32 output (ssm.py:97-99, xlstm.py:85-87)
F32_OUT = ("bcin,bcjn->bcij", "blhp,bjhp->bljh")
BACKEND_PAIRS = [("sfc_cuda", "sfc_pallas"), ("torch", "xla")]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair(arr, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``
    ("float32" or "bfloat16"); f32 -> bf16 rounds to nearest even in both."""
    t = torch.from_numpy(np.asarray(arr, np.float32))
    return t.to(getattr(torch, dtype)), jnp.asarray(arr, getattr(jnp, dtype))


def _operands(subs, dtype, seed=0):
    rng = np.random.default_rng(seed)
    sa, sb = SIGNATURES[subs]
    return _pair(rng.standard_normal(sa), dtype), _pair(rng.standard_normal(sb), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("subs", sorted(SIGNATURES))
def test_chunk_einsum_matches_jax(subs, backends, dtype):
    (ta, ja), (tb, jb) = _operands(subs, dtype)
    f32 = dtype == "bfloat16" and subs in F32_OUT
    with gb.gemm_backend(backends[0]):
        got = gb.chunk_einsum(subs, ta, tb, preferred_element_type=torch.float32 if f32 else None)
    with jgb.gemm_backend(backends[1]):
        want = jgb.chunk_einsum(subs, ja, jb, preferred_element_type=jnp.float32 if f32 else None)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    if dtype == "bfloat16" and not f32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_TOL, atol=BF16_TOL)
    elif f32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_chunk_einsum_sfc_cuda_launches_one_batched_product_a_call(monkeypatch):
    """Under "sfc_cuda" a call is one `sfc_matmul` with per-batch B in the
    (..., M, K) @ (..., K, N) framing, fuse=True, the asked output type and
    `chunk_gemm_plan`'s knobs; under "torch" none."""
    calls = []
    real = tops.sfc_matmul

    def spy(a, b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), kw))
        return real(a, b, **kw)

    monkeypatch.setattr(tops, "sfc_matmul", spy)
    (ta, _), (tb, _) = _operands("bcijh,bcjhp->bcihp", "float32")
    with gb.gemm_backend("sfc_cuda"):
        gb.chunk_einsum("bcijh,bcjhp->bcihp", ta, tb)
    (ca, _), (cb, _) = _operands("bcin,bcjn->bcij", "bfloat16")
    with gb.gemm_backend("sfc_cuda"):
        gb.chunk_einsum("bcin,bcjn->bcij", ca, cb, preferred_element_type=torch.float32)
    with gb.gemm_backend("torch"):
        gb.chunk_einsum("bcin,bcjn->bcij", ca, cb, preferred_element_type=torch.float32)
    _, knobs = tops.chunk_gemm_plan(24, 16, 24, torch.float32)
    assert calls == [
        ((1, 2, 3, 24, 24), (1, 2, 3, 24, 16), dict(out_dtype=torch.float32, fuse=True, **knobs)),
        ((2, 4, 24, 16), (2, 4, 16, 24), dict(out_dtype=torch.float32, fuse=True,
                                               **tops.chunk_gemm_plan(24, 24, 16, torch.bfloat16)[1])),
    ]


@pytest.mark.parametrize("subs", sorted(SIGNATURES))
def test_chunk_einsum_gradients_under_sfc_cuda_match_torch(subs):
    """The kernel path is differentiable (`sfc_matmul`'s autograd Function
    over per-batch B): its operand gradients match those of the "torch"
    backend's einsum at f32 rtol 1e-4."""
    (ta, _), (tb, _) = _operands(subs, "float32", seed=5)
    grads = {}
    for backend in ("sfc_cuda", "torch"):
        a, b = ta.clone().requires_grad_(), tb.clone().requires_grad_()
        with gb.gemm_backend(backend):
            out = gb.chunk_einsum(subs, a, b)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads[backend] = (a.grad, b.grad)
    for got, want in zip(grads["sfc_cuda"], grads["torch"]):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_chunk_einsum_unknown_signature_raises_as_jax_does():
    a = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError) as got:
        gb.chunk_einsum("bij,bjk->bik", a, a)
    with pytest.raises(ValueError) as want:
        jgb.chunk_einsum("bij,bjk->bik", jnp.zeros((2, 3, 4)), jnp.zeros((2, 3, 4)))
    assert str(got.value) == str(want.value)
    assert sorted(gb._CHUNK_EINSUMS) == sorted(jgb._CHUNK_EINSUMS)
    assert gb._CHUNK_EINSUMS == jgb._CHUNK_EINSUMS


@pytest.mark.parametrize("shape", [(24, 24, 16), (24, 16, 24), (8, 8, 16), (128, 128, 64), (256, 256, 64),
                                   (128, 64, 128), (256, 64, 256), (128, 128, 1024), (50, 70, 50)])
def test_chunk_gemm_plan_matches_jax(shape):
    m, n, k = shape
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert tops.chunk_gemm_plan(m, n, k, tdt) == jops.chunk_gemm_plan(m, n, k, jdt)
    ns, _ = tops.chunk_gemm_plan(m, n, k, torch.bfloat16)
    assert ns.startswith("gemm@") and ns == tops.chunk_gemm_plan(m, n, k, torch.bfloat16, device="meta")[0]


@pytest.mark.parametrize("abft", [False, True])
@pytest.mark.parametrize("shared_b", [False, True])
def test_k2_plain_bf16_in_f32_out_matches_jax(shared_b, abft):
    """K2's f32-output mode: bf16 operands, the f32 accumulator out with no
    bf16 rounding (the SSD scores' framing: batch 3, M 32, K 16, N 32)."""
    rng = np.random.default_rng(3)
    (ta, ja) = _pair(rng.standard_normal((3, 32, 16)), "bfloat16")
    (tb, jb) = _pair(rng.standard_normal((16, 32) if shared_b else (3, 16, 32)), "bfloat16")
    got = tk.sfc_gemm_fused(ta, tb, bm=16, bn=16, out_dtype=torch.float32, abft=abft)
    want = jk.sfc_gemm_batched_fused(ja, jb, bm=16, bn=16, out_dtype=jnp.float32, interpret=True, abft=abft)
    if abft:
        (got, chk), (want, jchk) = got, want
        np.testing.assert_allclose(float(chk), float(np.asarray(jchk).sum()), rtol=1e-5, atol=1e-4)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # no bf16 rounding: the f32 product of the bf16 values, not its bf16 cast
    exact = ta.float() @ tb.float()
    np.testing.assert_allclose(_np(got), _np(exact), rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, exact.bfloat16().float())


def test_f32_output_mode_refuses_an_epilogue_naming_it():
    """On the card the f32-output mode is the plain product's: the GLU form,
    preact and each epilogue flag raise, the message naming what was asked
    (the host-side check the CUDA launch runs first)."""
    w = torch.zeros(4, 4)
    tk._check_f32_out(None, None, None, None, None, False)
    for kw, name in ((dict(b_gate=w), "GLU"), (dict(preact=True), "preact"), (dict(bias=w[0]), "bias"),
                     (dict(activation="silu"), "activation"), (dict(out_scale=0.5), "out_scale"),
                     (dict(residual=w), "residual")):
        args = dict(dict(b_gate=None, bias=None, residual=None, activation=None, out_scale=None, preact=False), **kw)
        with pytest.raises(TypeError, match=name):
            tk._check_f32_out(**args)
    a = torch.zeros(2, 8, 8, dtype=torch.bfloat16)
    assert tk._f32_out(a, torch.float32) and not tk._f32_out(a.float(), torch.float32)
    assert not tk._f32_out(a, torch.bfloat16)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    bm = rng.standard_normal((b, s, n)) * 0.5
    cm = rng.standard_normal((b, s, n)) * 0.5
    log_a = -rng.uniform(0.01, 0.5, (b, s, h))
    return [_pair(v, "float32") for v in (x, bm, cm, log_a)]


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("s,chunk,state", [(21, 8, False), (21, 8, True), (16, 8, True), (5, 8, False),
                                           (13, 4, True)])
def test_ssd_chunked_matches_jax(s, chunk, state, backends):
    """Ragged lengths (a padded last chunk), one chunk and several, with and
    without an initial state; the final state too."""
    ins = _ssd_inputs(s * 7 + chunk, 2, s, 3, 4, 8)
    t_in, j_in = [t for t, _ in ins], [j for _, j in ins]
    kw = dict(chunk=chunk, return_state=True)
    t_init = j_init = None
    if state:
        t_init, j_init = _pair(np.random.default_rng(s).standard_normal((2, 3, 8, 4)), "float32")
    with gb.gemm_backend(backends[0]):
        y, s_fin = ssm.ssd_chunked(*t_in, initial_state=t_init, **kw)
        y_only = ssm.ssd_chunked(*t_in, initial_state=t_init, chunk=chunk)
    with jgb.gemm_backend(backends[1]):
        jy, js_fin = jssm.ssd_chunked(*j_in, initial_state=j_init, **kw)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, s, 3, 4)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(s_fin), _np(js_fin), rtol=RTOL, atol=ATOL)
    assert torch.equal(y_only, y)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(11)
    vals = [rng.standard_normal(sh) for sh in ((2, 3, 8, 4), (2, 3, 4), (2, 8), (2, 8))] + [
        -rng.uniform(0.01, 0.5, (2, 3))]
    pairs = [_pair(v, "float32") for v in vals]
    s_new, y = ssm.ssd_decode_step(*[t for t, _ in pairs])
    js_new, jy = jssm.ssd_decode_step(*[j for _, j in pairs])
    np.testing.assert_allclose(_np(s_new), _np(js_new), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=RTOL, atol=ATOL)


def test_decode_steps_continue_the_chunked_scan():
    """The recurrence one step at a time gives what the chunked scan gives
    (the port against itself: the two forms of one recurrence)."""
    (x, _), (bm, _), (cm, _), (la, _) = _ssd_inputs(5, 1, 11, 2, 4, 8)
    y, s_fin = ssm.ssd_chunked(x, bm, cm, la, chunk=4, return_state=True)
    st = torch.zeros(1, 2, 8, 4)
    for t in range(11):
        st, yt = ssm.ssd_decode_step(st, x[:, t], bm[:, t], cm[:, t], la[:, t])
        np.testing.assert_allclose(_np(yt), _np(y[:, t]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(st), _np(s_fin), rtol=RTOL, atol=ATOL)


def test_softplus_and_causal_conv_match_jax():
    x = np.array([-80.0, -20.5, -1.0, 0.0, 1e-3, 3.0, 19.9, 20.0, 20.1, 35.0, 88.0], np.float32)
    np.testing.assert_allclose(_np(ssm.softplus(torch.from_numpy(x))), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(2)
    (tx, jx), (tw, jw), (tb, jb) = (_pair(v, "float32") for v in (rng.standard_normal((2, 9, 6)),
                                                                  rng.standard_normal((4, 6)),
                                                                  rng.standard_normal(6)))
    np.testing.assert_allclose(_np(ssm._causal_conv(tx, tw, tb)), _np(jssm._causal_conv(jx, jw, jb)),
                               rtol=1e-6, atol=1e-6)


D_MODEL, D_STATE, HEAD_DIM, CHUNK = 32, 8, 16, 8


@pytest.fixture(scope="module")
def mixer():
    """A Mamba2 mixer (d_model 32, expand 2: 4 heads of 16, state 8) from
    JAX's own init, and the port's module holding the same values."""
    jp = jssm.mamba2_init(jax.random.PRNGKey(4), d_model=D_MODEL, d_state=D_STATE, head_dim=HEAD_DIM)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    mod = ssm.Mamba2(d_model=D_MODEL, d_state=D_STATE, head_dim=HEAD_DIM, dtype=torch.float32, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, mod


def test_mamba2_init_is_shaped_and_typed_as_jax(mixer):
    jp, _ = mixer
    mod = ssm.Mamba2(d_model=D_MODEL, d_state=D_STATE, head_dim=HEAD_DIM, dtype=torch.bfloat16, device="cpu")
    mod.init(torch.Generator().manual_seed(0))
    sd = mod.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in jp.items()}
    assert {k for k, v in sd.items() if v.dtype == torch.float32} == set(ssm.F32_PARAMS)
    np.testing.assert_allclose(_np(sd["A_log"]), jp["A_log"], rtol=1e-6)
    dt = np.asarray(jax.nn.softplus(_np(sd["dt_bias"])))
    assert (dt >= 0.001 * 0.999).all() and (dt <= 0.1 * 1.001).all()


def _mixer_inputs(seed, b, s):
    return _pair(np.random.default_rng(seed).standard_normal((b, s, D_MODEL)), "float32")


@pytest.mark.parametrize("backends", BACKEND_PAIRS, ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("s", [21, 2])
def test_mamba2_forward_matches_jax(mixer, s, backends):
    """A 21-step prompt (three chunks of 8) and a 2-step one (shorter than
    the conv's window): the output and the state a decode continues from;
    then a second segment continued from that state."""
    jp, mod = mixer
    tx, jx = _mixer_inputs(s, 2, s)
    tx2, jx2 = _mixer_inputs(s + 1, 2, 5)
    kw = dict(d_state=D_STATE, head_dim=HEAD_DIM, chunk=CHUNK)
    with gb.gemm_backend(backends[0]), torch.no_grad():
        out, st = ssm.mamba2_forward(mod, tx, return_state=True, **kw)
        out2 = ssm.mamba2_forward(mod, tx2, initial_state=st, **kw)
        plain = ssm.mamba2_forward(mod, tx, **kw)
    with jgb.gemm_backend(backends[1]):
        jout, jst = jssm.mamba2_forward(jp, jx, return_state=True, **kw)
        jout2 = jssm.mamba2_forward(jp, jx2, initial_state=jst, **kw)
    for got, want in ((out, jout), (st["ssm"], jst["ssm"]), (st["conv"], jst["conv"]), (out2, jout2)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(plain, out)


def test_mamba2_decode_matches_jax(mixer):
    """Three decode steps from a 5-step prefill's state."""
    jp, mod = mixer
    tx, jx = _mixer_inputs(9, 2, 5)
    kw = dict(d_state=D_STATE, head_dim=HEAD_DIM)
    with torch.no_grad():
        _, st = ssm.mamba2_forward(mod, tx, return_state=True, chunk=CHUNK, **kw)
    _, jst = jssm.mamba2_forward(jp, jx, return_state=True, chunk=CHUNK, **kw)
    for step in range(3):
        tt, jt = _mixer_inputs(20 + step, 2, 1)
        with torch.no_grad():
            out, st = ssm.mamba2_decode(mod, tt, st, **kw)
        jout, jst = jssm.mamba2_decode(jp, jt, jst, **kw)
        for got, want in ((out, jout), (st["ssm"], jst["ssm"]), (st["conv"], jst["conv"])):
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
