"""The port's ABFT layer (`repro_torch.robust.abft`) and the kernels'
checksum lanes against the JAX package's ``repro.robust.abft`` and Pallas
kernels (interpret mode), on the CPU, where every lane is its kernel's
plain version.

Tolerances: the operand-side references in f32 at rtol 1e-6 (the same sums
in other orders); `tolerance` bit-identical; a plain lane against the JAX
kernel's checksum output at f32 rtol 1e-4 plus 1e-6 of the magnitude
checksum ``sum(|A| @ |B|)`` (both sum the same f32 tiles in other orders,
and a checksum of terms of both signs can cancel far below its terms);
results under "detect" bitwise equal to "off" (the check reads the output
and leaves it alone).
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.robust import abft as jabft  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import gemm_backend as tgb  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.robust import abft  # noqa: E402
from repro_torch.robust.ladder import get_registry  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.train.step import BackendConfig, make_train_step  # noqa: E402

LANE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_counters():
    abft.reset_runtime_sdc()
    get_registry().reset()
    yield
    abft.reset_runtime_sdc()
    get_registry().reset()  # a quarantine left here would reroute later tests


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [None if s is None else (rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _lane_close(got, want, mag):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=LANE_RTOL,
                               atol=1e-6 * float(mag))


# ---------------------------------------------------------------------------
# checksum math and the tolerance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "a_shape,b_shape,gate",
    [
        ((37, 50), (50, 70), False),  # plain
        ((3, 19, 24), (24, 40), False),  # batched A, shared B: the batch folds into the column sums
        ((2, 3, 9, 24), (24, 40), True),  # two leading dims, GLU
        ((3, 16, 24), (3, 24, 40), False),  # per-batch B
    ],
)
def test_gemm_checksum_ref_matches_jax(a_shape, b_shape, gate):
    a, b, bg = _arrays(1, a_shape, b_shape, b_shape if gate else None)
    want = jabft.gemm_checksum_ref(_j(a), _j(b), _j(bg))
    got = abft.gemm_checksum_ref(_t(a), _t(b), _t(bg))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.ndim == 0
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


@pytest.mark.parametrize("kind", ["nt", "tn"])
def test_nt_tn_checksum_refs_match_jax(kind):
    a, b = _arrays(2, (64, 96), (48, 96)) if kind == "nt" else _arrays(2, (96, 64), (96, 48))
    jfn, tfn = (jabft.nt_checksum_ref, abft.nt_checksum_ref) if kind == "nt" else (jabft.tn_checksum_ref,
                                                                                     abft.tn_checksum_ref)
    for g, w in zip(tfn(_t(a), _t(b)), jfn(_j(a), _j(b))):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    # the identity the lanes rest on, within the tolerance
    c = a @ b.T if kind == "nt" else a.T @ b
    ref, mag = tfn(_t(a), _t(b))
    assert abs(float(c.sum(dtype=np.float64)) - float(ref)) <= float(abft.tolerance(mag, 96))


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("group_sizes", [(6, 6, 6), (5, 0, 19, 32), (0, 0, 7), (0, 0)])
def test_grouped_checksum_ref_matches_jax_per_expert_sum(group_sizes, gate):
    """The grouped reference (one segment sum over the rows' experts)
    against the JAX package's loop of per-expert `gemm_checksum_ref`s, at
    f32 rtol 1e-6 (+1e-6 of the magnitude, for a sum that cancels)."""
    e, k, n = len(group_sizes), 24, 40
    a, b, bg = _arrays(4, (sum(group_sizes), k), (e, k, n), (e, k, n) if gate else None)
    want = [np.float32(0.0), np.float32(0.0)]
    off = 0
    for ei, g in enumerate(group_sizes):
        if g:
            r, mg = jabft.gemm_checksum_ref(_j(a[off:off + g]), _j(b[ei]), None if bg is None else _j(bg[ei]))
            want = [want[0] + float(r), want[1] + float(mg)]
            off += g
    got = abft.grouped_checksum_ref(_t(a), _t(b), _t(bg), group_sizes)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.ndim == 0
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6 * float(want[1]))


@pytest.mark.parametrize("cast", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 96, 2560, 9728])
def test_tolerance_is_bit_identical_to_jax(k, cast):
    (mag,) = _arrays(3, (5,), scale=1e4)
    mag = np.abs(mag)
    jcast, tcast = (None, None) if cast is None else (getattr(jnp, cast), getattr(torch, cast))
    for m in mag:
        want = np.asarray(jabft.tolerance(jnp.float32(m), k, jcast))
        got = abft.tolerance(torch.tensor(m, dtype=torch.float32), k, tcast)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


# ---------------------------------------------------------------------------
# mode resolution and the two reporting channels
# ---------------------------------------------------------------------------


def test_mode_resolution_env_and_overrides(monkeypatch):
    monkeypatch.delenv("REPRO_ABFT", raising=False)
    assert abft.current_mode("gemm") == "off"
    monkeypatch.setenv("REPRO_ABFT", "detect")
    assert abft.current_mode("gemm") == "detect"
    with abft.abft_mode("off"):
        assert abft.current_mode("gemm") == "off"
        with abft.abft_mode("strict", namespace="glu"):
            assert abft.current_mode("glu") == "strict"
            assert abft.current_mode("gemm") == "off"
    monkeypatch.setenv("REPRO_ABFT", "paranoid")
    assert abft.current_mode("gemm") == "off"
    with pytest.raises(ValueError):
        abft.abft_mode("paranoid").__enter__()
    with tgb.gemm_backend("sfc_cuda", abft="strict"):
        assert abft.current_mode("tn") == "strict"
    assert abft.current_mode("tn") == "off"


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


def test_verify_eager_raises_sdc_detected():
    out = torch.ones((4, 4))
    with pytest.raises(abft.SdcDetected, match="gemm"):
        abft.verify("gemm", out, _f(100.0), _f(0.0), _f(1.0), contract_dim=64, mode="detect")
    assert abft.runtime_sdc_total() == 0  # the eager channel raises, it does not count
    res = abft.verify("gemm", out, _f(1.0), _f(1.0), _f(1.0), contract_dim=64, mode="detect")
    assert res is out
    assert abft.runtime_check_total() == 2
    # "off" checks nothing
    assert abft.verify("gemm", out, _f(100.0), _f(0.0), _f(1.0), contract_dim=64, mode="off") is out


def test_verify_in_step_scope_counts_on_the_device():
    out = torch.ones((4, 4))
    with abft.step_scope() as scope:
        res = abft.verify("gemm", out, _f(100.0), _f(0.0), _f(1.0), contract_dim=64, mode="detect")
        assert abft.runtime_sdc_total() == 0  # read at the scope's exit
    assert res is out  # detect does not perturb the output
    assert abft.runtime_sdc_total() == 1 and abft.runtime_sdc_counts() == {"gemm": 1}
    assert scope.detections == {"gemm": 1} and scope.max_ratio > 1
    with abft.step_scope() as scope:
        abft.verify("gemm", out, _f(1.00001), _f(1.0), _f(1.0), contract_dim=64, mode="detect")
        # a NaN residual compares false: no detection, as in JAX, and no margin
        abft.verify("tn", out, _f(float("nan")), _f(1.0), _f(1.0), contract_dim=64, mode="detect")
    assert scope.detections == {} and abft.runtime_sdc_total() == 1
    assert 0 < scope.max_ratio < 1


def test_verify_strict_nan_poisons_in_step_scope():
    with abft.step_scope():
        bad = abft.verify("gemm", (torch.ones((4, 4)), torch.ones(3)), _f(100.0), _f(0.0), _f(1.0),
                          contract_dim=64, mode="strict")
        clean = abft.verify("gemm", torch.ones((4, 4)), _f(1.0), _f(1.0), _f(1.0), contract_dim=64, mode="strict")
    assert all(torch.isnan(x).all() for x in bad)
    assert torch.equal(clean, torch.ones((4, 4)))
    assert abft.runtime_sdc_total() == 1


# ---------------------------------------------------------------------------
# the plain versions' lanes against the Pallas kernels' checksum outputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "form", ["plain", "plain_glu", "batched", "batched_glu", "batched_preact", "per_batch", "epilogue"]
)
def test_fused_plain_lane_matches_pallas(form):
    bsz, m, k, n = 2, 32, 64, 48
    batched = form.startswith("batched") or form == "per_batch"
    lead = (bsz,) if batched else ()
    glu = "glu" in form or form == "batched_preact"
    a, b, bg, bias, gbias, res = _arrays(4, (*lead, m, k), (bsz, k, n) if form == "per_batch" else (k, n),
                                         (k, n) if glu else None, (1, n), (1, n) if glu else None,
                                         (*lead, m, n) if form == "epilogue" else None)
    kw = dict(bm=16, bn=16, k_layers=2, k_block_factor=2)
    if form == "epilogue":
        kw.update(activation="gelu", out_scale=0.5)
    elif glu and form != "batched_preact":
        kw.update(activation="silu")
    preact = form == "batched_preact"
    jfn = jk.sfc_gemm_batched_fused if batched else jk.sfc_gemm_fused
    want = jfn(*map(_j, (a, b, bg, bias, gbias, res)), interpret=True, abft=True, preact_out=preact, **kw)
    got = tk.sfc_gemm_fused(*map(_t, (a, b, bg, bias, gbias, res)), abft=True, preact=preact, **kw)
    plain = tk.sfc_gemm_fused(*map(_t, (a, b, bg, bias, gbias, res)), preact=preact, **kw)
    assert len(got) == len(want) == (3 if preact else 2)
    assert got[-1].dtype == torch.float32 and got[-1].ndim == 0
    _lane_close(got[-1], want[-1], abft.gemm_checksum_ref(_t(a), _t(b), _t(bg))[1])
    for g, p in zip(got[:-1], plain if preact else (plain,)):
        assert torch.equal(g, p)  # the lane leaves the outputs alone


@pytest.mark.parametrize("form", ["linear", "glu_silu", "glu_preact"])
@pytest.mark.parametrize("group_sizes", [(5, 0, 19, 32), (16, 16)])
def test_grouped_plain_lane_matches_pallas(group_sizes, form):
    """K3's lane on ragged experts, one of them empty: the JAX kernel runs
    on each expert's rows padded to whole blocks (zeros that add nothing),
    the port's plain version on the packed rows."""
    e, k, n, bm, bn = len(group_sizes), 24, 32, 16, 16
    glu = form.startswith("glu")
    t = sum(group_sizes)
    a, b, bg = _arrays(5, (t, k), (e, k, n), (e, k, n) if glu else None)
    kw = {"linear": {}, "glu_silu": dict(activation="silu"), "glu_preact": dict(preact=True)}[form]
    slabs, off, row_blocks = [], 0, []
    for g in group_sizes:
        rb = -(-g // bm)
        row_blocks.append(rb)
        if g:
            slabs.append(np.pad(a[off:off + g], ((0, rb * bm - g), (0, 0))))
        off += g
    want = jk.sfc_gemm_grouped(_j(np.concatenate(slabs)), _j(b), _j(bg), row_blocks=tuple(row_blocks), bm=bm,
                               bn=bn, k_block_factor=1, interpret=True, abft=True,
                               preact_out=kw.get("preact", False), activation=kw.get("activation"))
    got = tk.sfc_gemm_grouped(_t(a), _t(b), _t(bg), group_sizes=group_sizes, bm=bm, bn=bn, abft=True, **kw)
    rows = np.split(a, np.cumsum(group_sizes)[:-1])
    mag = sum(float(abft.gemm_checksum_ref(_t(r), _t(b[i]), None if bg is None else _t(bg[i]))[1])
              for i, r in enumerate(rows))
    _lane_close(got[-1], want[-1], mag)
    # the ops layer under "detect": no false positive, results as under "off"
    fn = tops.sfc_grouped_glu_matmul if glu and form == "glu_silu" else None
    if fn is not None:
        with abft.abft_mode("detect"):
            checked = fn(_t(a), _t(bg), _t(b), group_sizes)
        assert torch.equal(checked, fn(_t(a), _t(bg), _t(b), group_sizes))
    elif form == "linear":
        with abft.abft_mode("detect"):
            checked = tops.sfc_grouped_matmul(_t(a), _t(b), group_sizes)
        assert torch.equal(checked, tops.sfc_grouped_matmul(_t(a), _t(b), group_sizes))
    assert abft.runtime_check_total() == (1 if form != "glu_preact" else 0)


@pytest.mark.parametrize("dual", [False, True])
def test_tn_plain_lane_matches_pallas(dual):
    m, k, n = 48, 32, 64
    a, b, b2 = _arrays(6, (m, k), (m, n), (m, n) if dual else None)
    kw = dict(bm=16, bn=32, k_layers=2, k_block_factor=2)
    want = jk.sfc_gemm_tn(*map(_j, (a, b, b2)), interpret=True, abft=True, **kw)
    got = tk.sfc_gemm_tn(*map(_t, (a, b, b2)), abft=True, **kw)
    plain = tk.sfc_gemm_tn(*map(_t, (a, b, b2)), **kw)
    assert tuple(got[-1].shape) == tuple(want[-1].shape) == ((2, 1) if dual else (1, 1))
    for s, bs in enumerate((b, b2) if dual else (b,)):
        _lane_close(got[-1][s], want[-1][s], abft.tn_checksum_ref(_t(a), _t(bs))[1])
    for g, p in zip(got[:-1], plain if dual else (plain,)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("dual", [False, True])
def test_tn_update_plain_lane_matches_pallas(dual):
    """K8's update mode: the lane sums the raw dW before the scale and
    AdamW, so a scale of 0.5 leaves it as it is."""
    m, k, n = 40, 64, 64
    a, b, b2 = _arrays(7, (m, k), (m, n), (m, n) if dual else None)
    sets = [[np.zeros((k, n), np.float32), np.zeros((k, n), np.float32), np.full((k, n), 0.01, np.float32)]
            for _ in range(2 if dual else 1)]
    jh = jadamw.pack_adamw_hyper(jadamw.AdamWConfig(), jnp.int32(3), jnp.float32(0.5))
    th = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(3, dtype=torch.int32), torch.tensor(0.5))
    jstate = [jnp.asarray(x) for s in sets for x in s] + [None] * (0 if dual else 3)
    want = jk.sfc_gemm_tn(*map(_j, (a, b, b2)), *jstate, jh, bm=64, bn=64, interpret=True, out_dtype=jnp.float32,
                          update_dtype=jnp.float32, abft=True)
    tstate = [torch.from_numpy(x.copy()) for s in sets for x in s] + [None] * (0 if dual else 3)
    ws = [torch.zeros((k, n)) for _ in sets]
    norms, chk = tk.sfc_gemm_tn(*map(_t, (a, b, b2)), *tstate, th, w=ws[0], w2=ws[1] if dual else None, bm=64,
                                bn=64, abft=True)
    for s, bs in enumerate((b, b2) if dual else (b,)):
        _lane_close(chk[s], want[-1][s], abft.tn_checksum_ref(_t(a), _t(bs))[1])
    np.testing.assert_allclose(norms.numpy(), np.asarray(want[-2][:, 0]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the ops layer under "detect": no false positive, results as under "off"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "call",
    ["matmul_2d", "matmul_batched_epilogue", "glu", "fuse_false", "fuse_false_glu", "preact", "nt", "nt_dual",
     "tn", "tn_dual", "tn_update", "tn_norm"],
)
def test_ops_detect_clean_equals_off(call):
    a, b, bg, bias, res, dy, dy2 = (_t(x) for x in _arrays(
        8, (2, 21, 40), (40, 56), (40, 56), (56,), (2, 21, 56), (42, 56), (42, 56)))
    a2d = a.reshape(-1, 40)
    master, mu, nu = (torch.full((40, 56), v) for v in (0.1, 0.0, 0.01))
    hyper = tadamw.pack_adamw_hyper(tadamw.AdamWConfig(), torch.tensor(1, dtype=torch.int32), torch.tensor(1.0))

    def run():
        if call == "matmul_2d":
            return tops.sfc_matmul(a2d, b)
        if call == "matmul_batched_epilogue":
            return tops.sfc_matmul(a, b, bias=bias, activation="silu", out_scale=0.5, residual=res)
        if call == "glu":
            return tops.sfc_glu_matmul(a, bg, b, bias=bias)
        if call == "fuse_false":
            return tops.sfc_matmul(a, b, bias=bias, fuse=False, k_layers=2)
        if call == "fuse_false_glu":
            return tops.sfc_glu_matmul(a, bg, b, fuse=False, k_layers=2)
        if call == "preact":
            return tops._matmul_impl(a, b, bg, bias=bias, gate_bias=None, residual=None, activation=None,
                                     out_scale=None, bm=None, bn=None, k_layers=None, k_block_factor=None,
                                     out_dtype=None, preact=True)
        if call == "nt":
            return tops.sfc_matmul_nt(dy, b)
        if call == "nt_dual":
            return tops.sfc_matmul_nt(dy, b, dy2, bg)
        if call == "tn":
            return tops.sfc_matmul_tn(a2d, dy)
        if call == "tn_dual":
            return tops.sfc_matmul_tn(a2d, dy, dy2)
        if call == "tn_norm":
            return tops.sfc_matmul_tn_norm(a2d, dy)
        state = [x.clone() for x in (master, mu, nu)]
        w = torch.zeros((40, 56))
        return (tops.sfc_matmul_tn_update(a2d, dy, *state, hyper, w=w), *state, w)

    off = run()
    with abft.abft_mode("detect"):
        on = run()
    assert abft.runtime_check_total() == (2 if call in ("tn_dual", "fuse_false_glu") else 1)
    assert 0 <= abft.runtime_max_ratio() < 1
    for x, y in zip(on if isinstance(on, tuple) else (on,), off if isinstance(off, tuple) else (off,)):
        assert torch.equal(x, y)


def test_backward_on_another_thread_checks_under_the_forwards_state():
    """On the card autograd runs a backward on a device thread of its own,
    where the step's context variables are unset: the NT and TN launches
    of a backward run on another thread still check, under the forward's
    mode and in its step scope."""
    a, w = (_t(x).requires_grad_() for x in _arrays(10, (12, 16), (16, 8)))
    with abft.abft_mode("detect"), abft.step_scope():
        loss = tops.sfc_matmul(a, w).square().sum()
        worker = threading.Thread(target=loss.backward)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert abft.runtime_check_total() == 0  # read at the scope's exit
    assert a.grad is not None and w.grad is not None
    assert abft.runtime_check_total() == 3  # the forward, NT (dA) and TN (dW)
    assert abft.runtime_sdc_total() == 0


def test_a_backward_after_its_scope_exits_checks_eagerly(monkeypatch):
    """A forward inside a step scope and its backward run after the scope
    has exited: the scope is closed, so the backward's checks take the
    eager channel, and a corrupted TN lane raises `SdcDetected` instead of
    counting into a scope that has already been read.  The TN ladder
    classifies it "sdc": it retries the kernel once, detects again,
    quarantines it and serves dW on the torch rung, as the JAX package's
    ladder does."""
    a, w = (_t(x).requires_grad_() for x in _arrays(10, (12, 16), (16, 8)))
    with abft.abft_mode("detect"), abft.step_scope() as scope:
        loss = tops.sfc_matmul(a, w).square().sum()
    assert scope.closed and scope.checks == 1
    real = tk.sfc_gemm_tn

    def corrupted(*args, **kw):
        *outs, chk = real(*args, **kw)
        return (*outs, chk + 1e3)

    monkeypatch.setattr(tops, "sfc_gemm_tn", corrupted)
    loss.backward()
    reg = get_registry()
    assert reg.sdc_counts() == {"tn": {"detected": 2, "healed": 0}}
    assert [(r["namespace"], r["rung"], r["reason"]) for r in reg.degradation_report()["quarantined"]] == [
        ("tn", "sfc_cuda", "sdc")]
    assert abft.runtime_check_total() == 4  # the forward at the exit, then NT and TN (twice) eagerly
    assert scope.checks == 1 and not scope.detections
    torch.testing.assert_close(w.grad, 2 * a.detach().T @ (a.detach() @ w.detach()), rtol=1e-4, atol=1e-5)


def test_a_corrupted_lane_raises_eagerly_and_poisons_under_strict(monkeypatch):
    """The negative control of the CPU: the kernel's checksum off by 1% of
    the magnitude raises `SdcDetected` outside a step scope and, under
    "strict" in a scope, NaN-poisons the output and counts once."""
    a, b = (_t(x) for x in _arrays(9, (16, 32), (32, 24)))
    real = tk.sfc_gemm_fused

    def corrupted(*args, **kw):
        *outs, chk = real(*args, **kw)
        return (*outs, chk + 0.01 * float(abft.gemm_checksum_ref(a, b)[1]))

    monkeypatch.setattr(tops, "sfc_gemm_fused", corrupted)
    with pytest.raises(abft.SdcDetected, match="gemm"):
        tops.sfc_matmul(a, b, abft="detect")
    with abft.abft_mode("strict"), abft.step_scope() as scope:
        out = tops.sfc_matmul(a, b)
    assert torch.isnan(out).all() and scope.detections == {"gemm": 1}
    assert abft.runtime_sdc_total() == 1


# ---------------------------------------------------------------------------
# a train step and a serve under "detect"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_under_detect_matches_off(fused):
    """Two steps of a 2-layer reduced yi-6b on the sfc_cuda backend (the
    plain versions here), with ``abft="detect"`` and with ``"off"`` from one
    init: no detection, the losses equal, checks run in the forward, the
    backward and (fused) the update flush."""
    jcfg = dataclasses.replace(j_get_config("yi_6b").reduced(), n_layers=2)
    cfg = dataclasses.replace(get_config("yi_6b").reduced(), n_layers=2)
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0))), cfg,
                           device="cpu")
    data = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3))
    losses = {}
    for mode in ("off", "detect"):
        model = build_model(cfg, device="cpu")
        model.load_state_dict(init)
        step = make_train_step(model, tadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                               backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc", fused_optimizer=fused,
                                                     abft=mode))
        state = tadamw.adamw_init(dict(model.named_parameters()))
        losses[mode] = []
        for i in range(2):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
            losses[mode].append(float(m["loss"]))
        if mode == "off":
            assert abft.runtime_check_total() == 0
    assert losses["detect"] == losses["off"]
    assert abft.runtime_sdc_total() == 0
    assert abft.runtime_check_total() > 0 and 0 < abft.runtime_max_ratio() < 1


@pytest.fixture(scope="module")
def small_model():
    jcfg = j_get_config("qwen3_4b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config("qwen3_4b").reduced()
    return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")


def test_sampled_abft_verification_counts_and_matches(small_model):
    """``verify_every=N`` runs every Nth decode step under "detect" (the JAX
    engine's tests/test_serving.py case): a clean run verifies without
    changing the tokens or counting a detection."""
    cfg, params = small_model
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, size=8).astype(np.int32)
    base = ServingEngine(cfg, params, max_batch=1, max_seq=32, gemm_backend="sfc_cuda", device="cpu")
    [d1] = base.run(base.submit_many([prompt], max_new_tokens=6))
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=32, gemm_backend="sfc_cuda", device="cpu", verify_every=2)
    [d2] = eng.run(eng.submit_many([prompt], max_new_tokens=6))
    assert d2.output == d1.output
    assert eng.degradation_report()["verify"] == {
        "verify_every": 2,
        "decode_steps": 5,  # max_new_tokens - 1 loop iterations
        "verified_steps": 2,  # steps 2 and 4
        "sdc_detections": 0,
    }
    assert abft.runtime_check_total() > 0 and abft.runtime_sdc_total() == 0


def test_a_detection_in_a_verified_step_raises(small_model, monkeypatch):
    """A detection in a verified decode step (one corrupted lane) no longer
    raises: the engine quarantines the kernel rungs of its namespaces and
    redoes the step on the healed rungs, as the JAX engine does, so the
    tokens are the clean serve's and the ledger counts the one detection."""
    cfg, params = small_model
    prompt = np.arange(8, dtype=np.int32)
    clean = ServingEngine(cfg, params, max_batch=1, max_seq=32, gemm_backend="sfc_cuda", device="cpu")
    [want] = clean.run(clean.submit_many([prompt], max_new_tokens=3))
    real = tk.sfc_gemm_fused
    flips = []

    def corrupted(*args, **kw):
        out = real(*args, **kw)
        if kw.get("abft") and not flips:
            flips.append(1)
            return (*out[:-1], out[-1] + 1e3)
        return out

    monkeypatch.setattr(tops, "sfc_gemm_fused", corrupted)
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=32, gemm_backend="sfc_cuda", device="cpu", verify_every=1)
    [got] = eng.run(eng.submit_many([prompt], max_new_tokens=3))
    assert got.output == want.output
    rep = eng.degradation_report()
    assert rep["verify"]["verified_steps"] == 2 and rep["verify"]["sdc_detections"] == 1
    assert {(r["namespace"], r["rung"], r["reason"]) for r in rep["quarantined"]} >= {
        ("gemm", "sfc_cuda", "sdc"), ("gemm", "replicated", "sdc")}
    assert rep["sdc"]["gemm"]["detected"] == 1
