"""The port's attention kernels (K11 band flash forward, K14 decode, K15
dense flash forward), its attention backend, and the reduced models under
``attn_impl="sfc"`` / ``"flash_pallas"``, against the JAX package.

The JAX Pallas kernels run in interpret mode and are called directly (not
through ``repro.core.attention_backend``, whose fallback ladder would hand
back its jnp reference if a kernel failed).  Inputs come from numpy with a
fixed seed.  Tolerances: f32 at rtol 1e-4, atol 1e-5 (the same arithmetic
summed in another order); bf16 within one output rounding,
``|p - j| <= 2^-7 |j| + 1e-3 max|j|``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import attention_backend as jab  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash_attention  # noqa: E402
from repro.kernels.ref import flash_attention_ref as j_flash_attention_ref  # noqa: E402
from repro.kernels.sfc_attention import sfc_decode_attention_pallas, sfc_flash_fwd  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import attention_backend as tab  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sfc_attention as tsa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5

SHAPES = [
    (2, 32, 32, 4, 4, 16),  # MHA, chunk-aligned
    (2, 33, 33, 4, 2, 16),  # GQA 2:1, ragged seq
    (1, 16, 48, 8, 2, 8),  # GQA 4:1, Sq != Sk
    (1, 40, 24, 6, 6, 32),  # q longer than k, non-pow2 heads
]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(b, s, t, h, hkv, d, seed=0):
    return _rand(seed, b, s, h, d), _rand(seed + 1, b, t, hkv, d), _rand(seed + 2, b, t, hkv, d)


def _pad(x, length):
    return np.pad(x, ((0, 0), (0, length - x.shape[1]), (0, 0), (0, 0)))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _within_bf16(port, ref):
    p = np.asarray(torch.as_tensor(port).float())
    j = np.asarray(jnp.asarray(ref, jnp.float32))
    bound = 2.0**-7 * np.abs(j) + 1e-3 * np.abs(j).max()
    assert np.all(np.abs(p - j) <= bound), float(np.abs(p - j).max())


def _jax_fwd(q, k, v, *, causal, q_offset, q_chunk, k_chunk, dtype=jnp.float32):
    """The JAX kernel on inputs padded to chunk multiples, as its wrapper
    pads them, cut back to the first S rows: (o, lse (B, S, H))."""
    s, t = q.shape[1], k.shape[1]
    sq_p, sk_p = -(-s // q_chunk) * q_chunk, -(-t // k_chunk) * k_chunk
    o, lse = sfc_flash_fwd(
        jnp.asarray(_pad(q, sq_p), dtype), jnp.asarray(_pad(k, sk_p), dtype), jnp.asarray(_pad(v, sk_p), dtype),
        causal=causal, seq_q=s, seq_k=t, q_chunk=q_chunk, k_chunk=k_chunk, q_offset=q_offset, interpret=True,
    )
    return o[:, :s], lse[:, :s, :, 0]


# ---------------------------------------------------------------------------
# K11: band flash forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_offset", [0, 5, 16, 40])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,t,h,hkv,d", SHAPES)
def test_flash_fwd_matches_jax_kernel(b, s, t, h, hkv, d, causal, q_offset):
    q, k, v = _qkv(b, s, t, h, hkv, d)
    qc, kc = tab.resolve_attn_knobs(s, t, d, torch.float32, op="attn_fwd", q_chunk=16, k_chunk=16)
    want_o, want_lse = _jax_fwd(q, k, v, causal=causal, q_offset=q_offset, q_chunk=qc, k_chunk=kc)
    o, lse = tsa.sfc_flash_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal, q_offset=q_offset,
                               q_chunk=qc, k_chunk=kc)
    assert o.shape == (b, s, h, d) and lse.shape == (b, s, h) and lse.dtype == torch.float32
    _close(o, want_o)
    _close(lse, want_lse)


def test_flash_fwd_bf16_within_one_rounding():
    q, k, v = _qkv(2, 33, 33, 4, 2, 16, seed=3)
    want_o, want_lse = _jax_fwd(q, k, v, causal=True, q_offset=0, q_chunk=16, k_chunk=16, dtype=jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    o, lse = tsa.sfc_flash_fwd(tq, tk, tv, causal=True, q_chunk=16, k_chunk=16)
    assert o.dtype == torch.bfloat16
    _within_bf16(o, want_o)
    _close(lse, want_lse)


def test_flash_fwd_plain_rounds_p_only_for_p_v():
    """``p_dtype=torch.bfloat16`` models the CUDA kernels' bf16 forward: in
    one k tile, o is P rounded to bf16 times v over the f32 row sum; over
    several tiles the lse is the f32-P run's, bitwise."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 16, 16, 4, 2, 16, seed=6))
    o, lse = tsa.sfc_flash_fwd_plain(q, k, v, causal=True, q_chunk=16, k_chunk=16, p_dtype=torch.bfloat16)
    sc = torch.einsum("bshd,bthd->bhst", q.float() / 4.0, k.float().repeat_interleave(2, dim=2))
    sc = sc.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(), tsa.NEG)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    want = (p.bfloat16().float() @ v.float().repeat_interleave(2, dim=2).transpose(1, 2)) / p.sum(-1, keepdim=True)
    _close(o.float(), want.transpose(1, 2).bfloat16().float())
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(2, 33, 40, 4, 2, 16, seed=7))
    kw = dict(causal=True, q_chunk=16, k_chunk=16, q_offset=7)
    assert torch.equal(tsa.sfc_flash_fwd_plain(q, k, v, p_dtype=torch.bfloat16, **kw)[1],
                       tsa.sfc_flash_fwd_plain(q, k, v, **kw)[1])


def test_flash_fwd_masks_rows_past_seq_like_jax():
    """seq_q / seq_k shorter than the tensors: the masks, not the shapes,
    bound the attention, and masked rows carry the JAX kernel's sentinel."""
    q, k, v = _qkv(1, 20, 20, 2, 1, 8, seed=4)
    o, lse = tsa.sfc_flash_fwd(*map(torch.from_numpy, (q, k, v)), causal=True, seq_q=13, seq_k=11,
                               q_chunk=8, k_chunk=8)
    jo, jlse = sfc_flash_fwd(*(jnp.asarray(_pad(x, 24)) for x in (q, k, v)), causal=True, seq_q=13, seq_k=11,
                             q_chunk=8, k_chunk=8, interpret=True)
    _close(o, jo[:, :20])
    _close(lse, jlse[:, :20, :, 0])


def test_flash_attention_ref_matches_jax():
    q, k, v = _qkv(2, 12, 12, 4, 2, 8, seed=5)
    for causal in (True, False):
        _close(tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal),
               j_flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal))


def test_task_table_matches_jax():
    from repro.kernels.sfc_attention import build_attention_task_table as j_table

    for kw in (dict(causal=True, q_offset=0), dict(causal=True, q_offset=20), dict(causal=False),
               dict(causal=True, transpose=True)):
        got = tsa.build_attention_task_table(5, 7, q_chunk=16, k_chunk=8, **kw)
        assert np.array_equal(got, j_table(5, 7, q_chunk=16, k_chunk=8, **kw))


# ---------------------------------------------------------------------------
# K14: single-launch decode
# ---------------------------------------------------------------------------


def _jax_decode(q, k, v, valids, k_chunk):
    """The JAX kernel on its wrapper's padded inputs: the cache padded to a
    chunk multiple, the GQA group padded to 8 rows."""
    b, _, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    gp = max(8, 1 << (groups - 1).bit_length())
    t_p = -(-t // k_chunk) * k_chunk
    qg = np.pad(q.reshape(b, hkv, groups, d), ((0, 0), (0, 0), (0, gp - groups), (0, 0)))
    o = sfc_decode_attention_pallas(jnp.asarray(qg), jnp.asarray(_pad(k, t_p)), jnp.asarray(_pad(v, t_p)),
                                    jnp.asarray(valids, jnp.int32), k_chunk=k_chunk, interpret=True)
    return np.asarray(o)[:, :, :groups].reshape(b, 1, h, d)


@pytest.mark.parametrize(
    "b,t,h,hkv,d,valids",
    [
        (3, 40, 8, 2, 16, (1, 17, 40)),  # ragged live lengths
        (2, 32, 4, 4, 8, (32, 5)),  # MHA
        (1, 64, 16, 2, 32, (33,)),  # deep GQA 8:1
        (2, 16, 4, 2, 8, (0, 16)),  # an empty cache gives zeros
    ],
)
def test_decode_matches_jax_kernel_and_layers(b, t, h, hkv, d, valids):
    q, k, v = _rand(0, b, 1, h, d), _rand(1, b, t, hkv, d), _rand(2, b, t, hkv, d)
    _, kc = tab.resolve_attn_knobs(h, t, d, torch.float32, op="attn_decode")
    assert kc == jab.resolve_attn_knobs(h, t, d, jnp.float32, op="attn_decode")[1]
    valid = torch.tensor(valids, dtype=torch.int32)
    got = tab.decode_attention(*map(torch.from_numpy, (q, k, v)), valid)
    assert got.shape == (b, 1, h, d)
    _close(got, _jax_decode(q, k, v, valids, kc))
    if 0 in valids:
        assert torch.all(got[list(valids).index(0)] == 0)
    else:
        _close(got, tl.decode_attention(*map(torch.from_numpy, (q, k, v)), valid))
        _close(got, jl.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(valids, jnp.int32)))


def test_decode_plain_chunking_does_not_change_the_result():
    q, k, v = _rand(6, 3, 1, 8, 16), _rand(7, 3, 50, 2, 16), _rand(8, 3, 50, 2, 16)
    args = (*map(torch.from_numpy, (q, k, v)), torch.tensor([50, 1, 23], dtype=torch.int32))
    _close(tsa.sfc_decode_attention_plain(*args, k_chunk=8), tsa.sfc_decode_attention_plain(*args, k_chunk=64))


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])  # GQA group 1 and 4
def test_decode_plain_split_over_the_cache_matches_jax_kernel(splits, h, hkv):
    """The segments reduced apart and merged in segment order, against the
    TPU kernel's one walk: live lengths 0, 1, T, one past T, and one that
    ends exactly on a segment edge."""
    b, t, d, kc = 5, 40, 16, 8
    seg = tsa.decode_segment_rows(t, splits, kc)
    valids = (0, 1, t, t + 7, min(seg, t - 1))
    q, k, v = _rand(30, b, 1, h, d), _rand(31, b, t, hkv, d), _rand(32, b, t, hkv, d)
    got = tsa.sfc_decode_attention_plain(*map(torch.from_numpy, (q, k, v)), torch.tensor(valids, dtype=torch.int32),
                                         k_chunk=kc, splits=splits)
    _close(got, _jax_decode(q, k, v, tuple(min(x, t) for x in valids), kc))
    assert torch.all(got[0] == 0)  # an empty cache merges to zeros, not NaN


def test_decode_splits_are_a_function_of_the_shapes_and_the_card():
    """S at qwen3-4b's (32 / 8 heads) and olmoe-1b-7b's (16 / 16) decode
    shapes: 3 at the server's 145-row cache, 8 at 4096 rows; never over
    the cluster limit or one a chunk, no segment empty of capacity, and no
    live length among its arguments."""
    import inspect

    assert list(inspect.signature(tsa.decode_splits).parameters) == ["batch", "kv_heads", "t", "sm_count"]
    table = {(4, 8, 145): 3, (4, 8, 4096): 8, (4, 16, 145): 3, (4, 16, 4096): 5, (1, 1, 64): 1, (4, 8, 1): 1}
    for (b, hkv, t), want in table.items():
        s = tsa.decode_splits(b, hkv, t, tsa.H100_SMS)
        seg = tsa.decode_segment_rows(t, s)
        assert s == want, (b, hkv, t, s)
        assert 1 <= s <= build.MAX_DECODE_SPLITS and s <= -(-t // build.DECODE_CHUNK)
        assert seg % build.DECODE_CHUNK == 0 and (s - 1) * seg < t <= s * seg


def test_cpu_decode_wrapper_takes_the_cards_segments(monkeypatch):
    seen = []
    real = tsa.sfc_decode_attention_plain

    def plain(*args, **kw):
        seen.append(kw["splits"])
        return real(*args, **kw)

    monkeypatch.setattr(tsa, "sfc_decode_attention_plain", plain)
    q, k, v = _rand(33, 4, 1, 32, 8), _rand(34, 4, 145, 8, 8), _rand(35, 4, 145, 8, 8)
    for valids in ((129, 134, 139, 144), (0, 0, 0, 1)):
        tsa.sfc_decode_attention(*map(torch.from_numpy, (q, k, v)), torch.tensor(valids, dtype=torch.int32))
    assert seen == [3, 3]


# ---------------------------------------------------------------------------
# K15: dense-grid flash forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,t,h,hkv,d", [(2, 33, 33, 4, 2, 16), (1, 16, 48, 8, 2, 8), (1, 40, 24, 6, 6, 32)])
def test_dense_flash_attention_matches_jax_kernel(b, s, t, h, hkv, d, causal):
    q, k, v = _qkv(b, s, t, h, hkv, d, seed=9)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, q_chunk=16, k_chunk=16)
    want = j_flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, q_chunk=16, k_chunk=16, interpret=True)
    assert got.shape == (b, s, h, d)
    _close(got, want)


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------


def test_resolve_attn_knobs_matches_jax_hint_path():
    for sq in (1, 7, 16, 33, 128, 500):
        for sk in (1, 9, 64, 145, 2000):
            for hint in (None, 8, 16, 24, 128, 512, 1024):
                for op in ("attn_fwd", "attn_decode"):
                    want = jab.resolve_attn_knobs(sq, sk, 16, jnp.float32, op=op, q_chunk=hint, k_chunk=hint)
                    got = tab.resolve_attn_knobs(sq, sk, 16, torch.float32, op=op, q_chunk=hint, k_chunk=hint)
                    assert got == want, (sq, sk, hint, op)


def test_resolve_attn_knobs_on_the_card_is_the_kernel_tile():
    assert tab.resolve_attn_knobs(128, 128, 128, torch.bfloat16, op="attn_fwd", q_chunk=512, k_chunk=1024,
                                  device="cuda") == tsa.kernel_chunks()
    _, kc = tab.resolve_attn_knobs(32, 145, 128, torch.bfloat16, op="attn_decode", device="cuda")
    assert kc == tsa.build.DECODE_CHUNK


def test_attention_backend_context_overrides_config(monkeypatch):
    cfg = get_config("qwen3_4b").reduced()
    assert cfg.attn_impl == "blockwise"
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    calls = {"fwd": 0, "decode": 0}
    real_fwd, real_dec = tsa.sfc_flash_fwd_plain, tsa.sfc_decode_attention_plain

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def dec(*a, **kw):
        calls["decode"] += 1
        return real_dec(*a, **kw)

    monkeypatch.setattr(tsa, "sfc_flash_fwd_plain", fwd)
    monkeypatch.setattr(tsa, "sfc_decode_attention_plain", dec)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))).long()
    _, cache = model.prefill(tokens, cache_len=12)
    assert calls == {"fwd": 0, "decode": 0}
    with tab.attention_backend("sfc"):
        assert tab.current_attention_backend() == "sfc"
        _, cache = model.prefill(tokens, cache_len=12)
        model.decode_step(tokens[:, :1], cache)
    assert tab.current_attention_backend() is None
    assert calls == {"fwd": cfg.n_layers, "decode": cfg.n_layers}
    with pytest.raises(ValueError, match="unknown attention backend"):
        with tab.attention_backend("xla"):
            pass


def test_negative_q_offset_raises():
    q, k, v = map(torch.from_numpy, _qkv(1, 16, 16, 2, 2, 8))
    with pytest.raises(ValueError, match="q_offset"):
        tab.flash_attention(q, k, v, causal=True, q_offset=-1)


def test_inputs_that_need_a_gradient_raise():
    """attn_impl="sfc" flash attention is differentiable (K12/K13 in its
    backward; its gradients match the blockwise attention's); the decode
    attention and the flash_pallas kernel are forward-only, as in the JAX
    package, and refuse inputs that need a gradient."""
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 2, 1, 8))
    qg = q.clone().requires_grad_(True)
    o = tab.flash_attention(qg, k, v)
    assert type(o.grad_fn).__name__ == "_FlashCoreBackward"
    (dq,) = torch.autograd.grad(o.square().sum(), qg)
    qb = q.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tl.blockwise_attention(qb, k, v, q_chunk=4, k_chunk=4).square().sum(), qb)
    _close(dq, want)
    with pytest.raises(NotImplementedError, match="forward-only, as in the JAX package"):
        tfa.flash_attention(qg, k, v)
    valid = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="forward-only, as in the JAX package"):
        tab.decode_attention(qg[:, :1], k, v, valid)
    with torch.no_grad():
        o = tab.flash_attention(qg, k, v)
    assert o.grad_fn is None
    _close(o, tab.flash_attention(q, k, v))


def test_unknown_attn_impl_raises():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tattn._attend(q, k, v, causal=True, q_chunk=8, k_chunk=8, attn_impl="xla")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tattn._attend_cached(q[:, :1], k, v, torch.tensor([8], dtype=torch.int32), attn_impl="xla")


def test_cpu_wrappers_count_no_launches():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 2, 1, 8))
    before = (tsa.sfc_flash_fwd.launches, tsa.sfc_decode_attention.launches, tfa.flash_attention.launches)
    tsa.sfc_flash_fwd(q, k, v, causal=True)
    tsa.sfc_decode_attention(q[:, :1], k, v, torch.tensor([3], dtype=torch.int32))
    tfa.flash_attention(q, k, v)
    assert (tsa.sfc_flash_fwd.launches, tsa.sfc_decode_attention.launches, tfa.flash_attention.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsa.sfc_flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), causal=True)


# ---------------------------------------------------------------------------
# reduced models under attn_impl="sfc" / "flash_pallas"
# ---------------------------------------------------------------------------

PROMPT, CACHE, DECODE_STEPS = 12, 20, 3


@pytest.mark.parametrize("impl", ["sfc", "flash_pallas"])
@pytest.mark.parametrize("arch", ["qwen3_4b", "yi_6b"])
def test_reduced_model_greedy_prefill_and_decode_match_jax(arch, impl):
    """Prefill logits and three greedy decode steps, the JAX package's model
    under the same attn_impl against the port's (f32, rtol 1e-4), with
    identical greedy tokens."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), attn_impl=impl)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prompt = np.random.default_rng(12).integers(0, jcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jmodel.prefill(p, t, cache_len=CACHE, remat="none"))(
        jparams, jnp.asarray(prompt))
    decode = jax.jit(jmodel.decode_step)
    want_logits, want_tokens = [np.asarray(logits)], []
    for _ in range(DECODE_STEPS):
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        want_tokens.append(np.asarray(tok))
        logits, cache = decode(jparams, tok, cache)
        want_logits.append(np.asarray(logits))

    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl=impl)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"))
    logits, cache = model.prefill(torch.from_numpy(prompt).long(), cache_len=CACHE)
    got_logits, got_tokens = [logits], []
    for _ in range(DECODE_STEPS):
        tok = logits.argmax(dim=-1)[:, None]
        got_tokens.append(tok.numpy())
        logits, cache = model.decode_step(tok, cache)
        got_logits.append(logits)
    for g, w in zip(got_logits, want_logits):
        _close(g, w)
    np.testing.assert_array_equal(np.concatenate(got_tokens, 1), np.concatenate(want_tokens, 1))
