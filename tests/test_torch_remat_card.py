"""The training path's new shapes and remat on the card (these tests skip
on the CPU; run them there with ``python -m pytest -m cuda tests/``): K12 and
K13 on their wgmma kernels at seamless-m4t-medium's D 64, causal and not,
S = T and S != T; the backward of `chunk_einsum`'s four signatures, dA and
dB on the forward kernel over per-batch B; and a reduced decoder trained on
the card under remat "dots", its recompute on autograd's device thread.
Each against the plain PyTorch versions: bf16 within one output rounding
(2^-7 |p| + 1e-3 max|p|), f32 at rtol 1e-4 (+1e-5 of the largest |value|);
the remat steps bitwise remat "none"'s.
"""

import collections
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gemm_backend import gemm_backend  # noqa: E402
from repro_torch.kernels.entry import recomputing  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train.step import BackendConfig, make_train_step  # noqa: E402


# the kernel entries, by the modules that call them
ENTRY_CALLERS = {
    "repro_torch.kernels.ops": ("sfc_gemm_fused", "sfc_gemm_replicated", "add_reduce", "sfc_gemm_nt", "sfc_gemm_tn",
                                "sfc_gemm_grouped", "sfc_gemm_grouped_nt", "sfc_gemm_grouped_tn"),
    "repro_torch.core.attention_backend": ("sfc_flash_fwd", "sfc_flash_bwd_dq", "sfc_flash_bwd_dkv",
                                           "sfc_decode_attention"),
}


def count_entries(monkeypatch) -> collections.Counter:
    """A Counter of the kernel-entry calls by wrapper name (a launch on the
    card, a plain version on the CPU), counted at the callers' names;
    those made in a remat unit's recompute also under
    ``"<name>:recompute"``.  The wrappers' own launch counters are
    untouched."""
    calls = collections.Counter()

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            if recomputing():
                calls[f"{name}:recompute"] += 1
            return fn(*args, **kwargs)
        return call

    for module, names in ENTRY_CALLERS.items():
        mod = importlib.import_module(module)
        for name in names:
            monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _agree(got, want, dtype):
    err = (got.float() - want.float()).abs()
    p = want.float().abs()
    bound = (1e-4 * p + 1e-5 * p.max()) if dtype == torch.float32 else (2.0**-7 * p + 1e-3 * p.max())
    return bool(torch.isfinite(got.float()).all()) and bool((err <= bound).all())


# seamless-m4t-medium's attention (16 / 16 heads of 64): the training
# step's decoder self-attention (causal), its encoder's and cross-
# attention's (non-causal, 256 queries over 256 frames), and the serve's
# cross-attention shape (128 queries over 256 frames) at S != T
SEAMLESS_BWD_CASES = {
    "decoder_self_causal": ((2, 256, 256), True),
    "encoder_and_cross_non_causal": ((2, 256, 256), False),
    "cross_128_over_256": ((2, 128, 256), False),
    "causal_ragged_s_ne_t": ((1, 100, 150), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEAMLESS_BWD_CASES))
def test_flash_bwd_wgmma_kernels_at_seamless_shapes_on_card(case):
    """K12 and K13 on their wgmma kernels at D 64, causal and not, S = T and
    S != T, against `sfc_flash_bwd_*_plain` in the kernels' order."""
    _card()
    from repro_torch.core.device import sm_count
    from repro_torch.kernels import build
    from repro_torch.kernels import sfc_attention as tsa

    (b, s, t), causal = SEAMLESS_BWD_CASES[case]
    h = hkv = 16
    d = 64
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal)
    o, lse = tsa.sfc_flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    _, cluster = tsa.bwd_wgmma_grid("dkv", b, s, t, h, hkv, sm_count(q.device))
    before = [dict(f.launches_by_kernel) for f in (tsa.sfc_flash_bwd_dq, tsa.sfc_flash_bwd_dkv)]
    dq = tsa.sfc_flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tsa.sfc_flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    added = [{key: n - old.get(key, 0) for key, n in f.launches_by_kernel.items() if n != old.get(key, 0)}
             for f, old in zip((tsa.sfc_flash_bwd_dq, tsa.sfc_flash_bwd_dkv), before)]
    assert added == [{("flash_bwd_dq_wgmma_kernel", 1): 1}, {("flash_bwd_dkv_wgmma_kernel", cluster): 1}]
    qc, kc = tsa.kernel_chunks()
    dqc, dkc = build.ATTN_DKV_TILE[build.DTYPE_NAMES["bfloat16"]]
    want_dq = tsa.sfc_flash_bwd_dq_plain(q, k, v, do, lse, delta, q_chunk=qc, k_chunk=kc, **kw)
    want_dk, want_dv = tsa.sfc_flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_chunk=dqc, k_chunk=dkc,
                                                   group_parts=cluster, **kw)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _agree(got, want, torch.bfloat16)


# chunk_einsum's four signatures at a training chunk (zamba2's SSD: 64
# state dims, 8 heads of 64 here; xlstm's mLSTM: 2 heads of 128), bf16 in
# (the f32-output products' cotangent cast to bf16) or f32 in
CHUNK_BWD_CASES = {
    "bcin,bcjn->bcij": ((2, 1, 256, 64), (2, 1, 256, 64), torch.bfloat16, torch.float32),
    "bcijh,bcjhp->bcihp": ((2, 1, 256, 256, 8), (2, 1, 256, 8, 64), torch.bfloat16, None),
    "blhp,bjhp->bljh": ((2, 256, 2, 128), (2, 256, 2, 128), torch.bfloat16, torch.float32),
    "bljh,bjhp->blhp": ((2, 256, 256, 2), (2, 256, 2, 128), torch.float32, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("subs", list(CHUNK_BWD_CASES))
def test_chunk_einsum_backward_over_per_batch_b_on_card(subs):
    """The backward of a chunk product: dA and dB on the forward kernel (K2)
    over per-batch B, transposed operands made contiguous, one launch each,
    against the same autograd through the plain versions (CPU tensors)."""
    _card()
    from repro_torch.core.gemm_backend import chunk_einsum
    from repro_torch.kernels import sfc_gemm as tk

    sa, sb, dt, out_dt = CHUNK_BWD_CASES[subs]
    rng = np.random.default_rng(41)
    a0, b0 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5).to(dt) for s in (sa, sb))
    grads = {}
    for device in ("cuda", "cpu"):
        a, b = a0.to(device).requires_grad_(), b0.to(device).requires_grad_()
        with gemm_backend("sfc_cuda"):
            y = chunk_einsum(subs, a, b, preferred_element_type=out_dt)
        cot = torch.from_numpy(np.random.default_rng(42).standard_normal(tuple(y.shape)).astype(np.float32))
        before = tk.sfc_gemm_fused.launches
        y.backward(cot.to(device, y.dtype))
        if device == "cuda":
            torch.cuda.synchronize()
            assert tk.sfc_gemm_fused.launches - before == 2  # dA and dB
        grads[device] = (y.detach().cpu(), a.grad.cpu(), b.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got.dtype == want.dtype and _agree(got, want, got.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_remat_on_card_recomputes_on_the_kernels_bitwise(fused, monkeypatch):
    """A reduced decoder (head dim 128) in bf16 on the card, two steps under
    sfc_cuda + "sfc": autograd runs the backward, and the recompute, on its
    device thread; under "dots" the recompute still launches the kernels
    (each forward wrapper twice its remat "none" count but the head's K2,
    the extra calls all made in the recompute), and the losses, weights and
    f32 masters are bitwise "none"'s."""
    _card()
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk

    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), head_dim=128, param_dtype="bfloat16")
    calls = count_entries(monkeypatch)
    out = {}
    for policy in ("none", "dots"):
        calls.clear()
        model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(5))
        step = make_train_step(model, tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3), remat=policy,
                               backend=BackendConfig(gemm_backend="sfc_cuda", attn_impl="sfc",
                                                     fused_optimizer=fused))
        state = tadamw.adamw_init(dict(model.named_parameters()))
        batch_fn = train_cli.make_batch_fn(cfg, batch=2, seq=96, seed=6, device="cuda")
        counts = (tk.sfc_gemm_fused.launches, tsa.sfc_flash_fwd.launches, tk.sfc_gemm_tn.launches)
        losses = []
        with remat.remat_stats() as st:
            for i in range(2):
                state, metrics = step(state, batch_fn(i))
                losses.append(metrics["loss"].clone())
        torch.cuda.synchronize()
        counts = [now - was for now, was in zip((tk.sfc_gemm_fused.launches, tsa.sfc_flash_fwd.launches,
                                                 tk.sfc_gemm_tn.launches), counts)]
        out[policy] = (losses, counts, st, {n: p.detach().clone() for n, p in model.named_parameters()},
                       {n: t.clone() for n, t in state["master"].items()}, dict(calls))
    (l0, c0, _, p0, m0, e0), (l1, c1, st, p1, m1, e1) = out["none"], out["dots"]
    assert st.recomputes == 2 * cfg.n_layers
    assert e1["sfc_gemm_fused:recompute"] == e1["sfc_gemm_fused"] - e0["sfc_gemm_fused"] == c0[0] - 2 > 0
    assert e1["sfc_flash_fwd:recompute"] == e0["sfc_flash_fwd"] == c0[1]
    assert c1 == [2 * c0[0] - 2, 2 * c0[1], c0[2]]  # the head's K2 once a step
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for n in p0:
        assert torch.equal(p0[n], p1[n]) and torch.equal(m0[n], m1[n]), n
