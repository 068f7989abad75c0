"""The port's CUDA kernels on the card (the fused GEMM with its preact mode,
the replicated form's partial copies (K4/K5) and their sum (K6), the NT/TN
backward GEMMs with K8's update and norm modes, their grouped
MoE modes K3, K9 and K10 (with K10's update and norm modes), the
attention flash forward in its band and dense modes, the flash backward's
dQ and dK/dV, and the decode attention), each against its plain PyTorch
version; the loss gradients of a dense decoder and of reduced olmoe under
the sfc_cuda backend against the torch backend's; and the build's
bookkeeping on the CPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch (the repository's conftest needs JAX; skip it):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

On a machine without a card the tests marked ``cuda`` skip.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sfc_attention as tsa  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402

CU_SOURCE = Path(build.__file__).resolve().parent / "csrc" / "sfc_gemm_fused.cu"
ATTN_SOURCE = CU_SOURCE.with_name("sfc_attention.cu")


def test_python_tile_matches_the_compiled_tile():
    src = CU_SOURCE.read_text()
    bm = int(re.search(r"constexpr int kBM = (\d+);", src).group(1))
    bn = int(re.search(r"constexpr int kBN = (\d+);", src).group(1))
    assert build.TILE == (bm, bn) == tk.kernel_tile()


def test_every_part_has_its_own_entry_point():
    names = {build.entry_name(dt, glu, act) for dt in ("f32", "bf16") for glu in (False, True)
             for act in build.ACTIVATION_CODES}
    assert len(names) == 16
    assert build.entry_name("bf16", True, "silu") == "sfc_gemm_fused_bf16_glu1_act1"


def test_attention_constants_match_the_compiled_source():
    src = ATTN_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert build.ATTN_TILE == (const("kBQ"), const("kBK")) == tsa.kernel_chunks()
    assert build.DECODE_CHUNK == const("kDecChunk")
    assert build.MAX_DECODE_GROUPS == const("kMaxGroups")
    for kind in ("FWD", "DECODE"):
        dims = tuple(int(d) for d in re.findall(rf"^SFC_{kind}_ENTRY\((\d+)\)", src, re.MULTILINE))
        assert dims == build.ATTN_HEAD_DIMS
    assert build.attn_entry_name("fwd", "bf16", 128) == "sfc_attn_fwd_bf16_d128"


def test_backward_parts_and_constants_match_the_compiled_sources():
    gemm = CU_SOURCE.read_text()
    attn = ATTN_SOURCE.read_text()
    parts = dict(build._gemm_parts())
    for dt in ("f32", "bf16"):
        flags = parts[f"sfc_gemm_bwd_{dt}"]
        assert "-DSFC_BWD=1" in flags
        assert f"-DSFC_NT_ENTRY={build.bwd_entry_name('nt', dt)}" in flags
        assert f"-DSFC_TN_ENTRY={build.bwd_entry_name('tn', dt)}" in flags
    assert "extern \"C\" int SFC_NT_ENTRY(" in gemm and "extern \"C\" int SFC_TN_ENTRY(" in gemm
    bq = re.search(r"return sizeof\(T\) == 2 \? (\d+) : (\d+);", attn)
    kbk = int(re.search(r"constexpr int kBK = (\d+);", attn).group(1))
    assert build.ATTN_DKV_TILE == {"bf16": (int(bq.group(1)), kbk), "f32": (int(bq.group(2)), kbk)}
    for kind in ("DQ", "DKV"):
        dims = tuple(int(d) for d in re.findall(rf"^SFC_{kind}_ENTRY\((\d+)\)", attn, re.MULTILINE))
        assert dims == build.ATTN_HEAD_DIMS
    assert {name for name, _ in build._attention_parts()} == {
        f"sfc_attention{half}_{dt}" for half in ("", "_bwd") for dt in ("f32", "bf16")}


def test_digest_covers_included_headers(tmp_path):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "common.cuh"\nint x;\n')
    (tmp_path / "common.cuh").write_text('#include "deeper.cuh"\n')
    (tmp_path / "deeper.cuh").write_text("int y;\n")
    first = build.source_digest(tmp_path / "k.cu", ["-O3"])
    assert build.source_digest(tmp_path / "k.cu", ["-O3"]) == first
    assert build.source_digest(tmp_path / "k.cu", ["-O2"]) != first
    (tmp_path / "deeper.cuh").write_text("int z;\n")
    assert build.source_digest(tmp_path / "k.cu", ["-O3"]) != first


def test_wrapper_rejects_other_devices_and_counts_nothing_on_cpu():
    a, b = torch.ones(4, 8), torch.ones(8, 8)
    before = tk.sfc_gemm_fused.launches
    out = tk.sfc_gemm_fused(a, b, activation="relu")
    assert torch.equal(out, torch.full((4, 8), 8.0))
    assert tk.sfc_gemm_fused.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.sfc_gemm_fused(a.to("meta"), b.to("meta"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(dtype, seed=10):
    rng = np.random.default_rng(seed)
    shapes = [(3, 77, 203), (203, 133), (203, 133), (133,), (1, 133), (3, 77, 133)]
    scales = [1.0, 0.1, 0.1, 1.0, 1.0, 1.0]
    return [torch.from_numpy((rng.standard_normal(s) * c).astype(np.float32)).to("cuda", dtype)
            for s, c in zip(shapes, scales)]


def _agree(got, want, dtype):
    err = (got.float() - want.float()).abs()
    p = want.float().abs()
    # f32: rtol 1e-4 (+1e-5 of the largest value for sums that cancel);
    # bf16: one output rounding, 2^-7 |p| + 1e-3 max|p|
    bound = (1e-4 * p + 1e-5 * p.max()) if dtype == torch.float32 else (2.0**-7 * p + 1e-3 * p.max())
    return bool(torch.isfinite(got.float()).all()) and bool((err <= bound).all())


# plain-mode products of at most 16 rows (the cluster kernel in bf16) and
# one of 17 (the 64 x 64 tile kernel): (M, K, N, GLU, bias, gate bias,
# residual, epilogue keywords); K 2056 and 1000 give slabs of 257 and 500
# rows (ragged, element loads), K 2560 whole 16-byte vectors
CLUSTER_CASES = {
    "m1_glu_every_flag_ragged": (1, 2056, 133, True, True, True, True, dict(activation="gelu", out_scale=0.7)),
    "m4_relu_bias_residual_scale": (4, 2560, 1024, False, True, False, True, dict(activation="relu", out_scale=0.5)),
    "m4_glu_silu": (4, 2560, 9728, True, False, False, False, dict(activation="silu")),
    "m16_glu_preact_ragged": (16, 1000, 133, True, True, True, False, dict(preact=True)),
    "m16_silu_ragged_k": (16, 203, 133, False, False, False, False, dict(activation="silu")),
    "m17_every_flag": (17, 2056, 133, True, True, True, True, dict(activation="gelu", out_scale=0.7)),
}


def _cluster_inputs(dtype, m, k, n, glu, has_bias, has_gbias, has_res, seed=13):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to("cuda", dtype)

    return (r(m, k), r(k, n, scale=0.05), r(k, n, scale=0.05) if glu else None, r(n) if has_bias else None,
            r(1, n) if has_gbias else None, r(m, n) if has_res else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case",
    ["batched_glu_every_flag", "plain_relu_bias_residual", "batched_silu", "per_batch_weights", "glu_no_act",
     *(f"plain_{name}" for name in CLUSTER_CASES)],
)
def test_kernel_matches_plain_version_on_card(dtype, case):
    """Each kernel of sfc_gemm_fused against its plain version; a bf16
    plain-mode A of at most 16 rows launches the cluster kernel, summed by
    the plain version over the same K layers."""
    _card()
    dt = getattr(torch, dtype)
    if case.startswith("plain_m"):
        m, k, n, *flags, kw = CLUSTER_CASES[case.removeprefix("plain_")]
        args = _cluster_inputs(dt, m, k, n, *flags)
        cluster = tk.uses_cluster_kernel(args[0])
        assert cluster == (dt == torch.bfloat16 and m <= build.SPLIT_MAX_ROWS)
        layers = tk.cluster_layers(k, n, torch.cuda.get_device_properties(0).multi_processor_count)
        want_kernel = ("sfc_gemm_cluster_kernel", layers) if cluster else ("sfc_gemm_fused_kernel", 1)
        plain_kw = dict(k_layers=layers if cluster else 1)
    else:
        a, b, bg, bias, gbias, res = _inputs(dt)
        args, kw = {
            "batched_glu_every_flag": ((a, b, bg, bias, gbias, res), dict(activation="gelu", out_scale=0.7)),
            "plain_relu_bias_residual": ((a[0], b, None, bias, None, res[0]), dict(activation="relu")),
            "batched_silu": ((a, b), dict(activation="silu")),
            "per_batch_weights": ((a, b[None].repeat(3, 1, 1).contiguous()), dict(out_scale=2.0)),
            "glu_no_act": ((a[1], b, bg), dict()),
        }[case]
        want_kernel, plain_kw = ("sfc_gemm_fused_kernel", 1), {}
    before = (tk.sfc_gemm_fused.launches, tk.sfc_gemm_fused.launches_by_kernel[want_kernel])
    got = tk.sfc_gemm_fused(*args, **kw)
    torch.cuda.synchronize()
    assert (tk.sfc_gemm_fused.launches, tk.sfc_gemm_fused.launches_by_kernel[want_kernel]) == (before[0] + 1,
                                                                                               before[1] + 1)
    want = tk.sfc_gemm_fused_plain(*args, bm=64, bn=64, **plain_kw, **kw)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert g.dtype == dt and g.shape == w.shape
        assert _agree(g, w, dt)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    _card()
    a, b = torch.ones(4, 8, device="cuda"), torch.ones(8, 8, device="cuda")
    with pytest.raises(TypeError):
        tk.sfc_gemm_fused(a.half(), b.half())
    with pytest.raises(TypeError):
        tk.sfc_gemm_fused(a, b, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="compiled for"):
        tk.sfc_gemm_fused(a, b, bm=32, bn=32)
    with pytest.raises(ValueError, match="contiguous"):
        tk.sfc_gemm_fused(a, torch.ones(8, 8, device="cuda").T)
    with pytest.raises(ValueError, match="is on"):
        tk.sfc_gemm_fused(a, b.cpu())


def _attn_inputs(b, s, t, h, hkv, d, dtype, seed=20):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case",
    ["prefill_gqa_ragged", "q_offset_48", "non_causal_cross", "masks_shorter_than_shapes"],
)
def test_flash_fwd_kernel_matches_plain_version_on_card(dtype, case):
    _card()
    dt = getattr(torch, dtype)
    (b, s, t, h, hkv, d), kw = {
        "prefill_gqa_ragged": ((2, 130, 130, 8, 2, 128), dict(causal=True)),
        "q_offset_48": ((1, 70, 118, 4, 4, 64), dict(causal=True, q_offset=48)),
        "non_causal_cross": ((2, 50, 200, 4, 1, 64), dict(causal=False)),
        "masks_shorter_than_shapes": ((1, 100, 100, 4, 2, 128), dict(causal=True, seq_q=90, seq_k=77)),
    }[case]
    q, k, v = _attn_inputs(b, s, t, h, hkv, d, dt)
    before = tsa.sfc_flash_fwd.launches
    o, lse = tsa.sfc_flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tsa.sfc_flash_fwd.launches == before + 1
    qc, kc = tsa.kernel_chunks()
    want_o, want_lse = tsa.sfc_flash_fwd_plain(q, k, v, q_chunk=qc, k_chunk=kc, **kw)
    assert o.dtype == dt and o.shape == want_o.shape and lse.shape == want_lse.shape
    assert _agree(o, want_o, dt)
    assert _agree(lse, want_lse, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_flash_kernel_matches_plain_version_on_card(dtype, causal):
    _card()
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(2, 130, 130, 8, 2, 128, dt, seed=21)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, q_chunk=512, k_chunk=1024)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    qc, kc = tsa.kernel_chunks()
    assert _agree(got, tfa.flash_attention_plain(q, k, v, causal=causal, q_chunk=qc, k_chunk=kc), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case", ["serve_shape", "strided_cache_with_empty_row", "cache_4096_ragged", "empty_full_and_past_t_g1"])
def test_decode_kernel_matches_plain_version_on_card(dtype, case):
    """The decode kernel (batch x Hkv clusters of S CTAs, one a cache
    segment) against its plain version over the same segments."""
    _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(22)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dt)

    if case == "serve_shape":
        b, t, h, hkv, d, valids = 4, 145, 32, 8, 128, (129, 134, 139, 144)
        k, v = r(b, t, hkv, d), r(b, t, hkv, d)
    elif case == "strided_cache_with_empty_row":  # a view of a wider cache: strided rows, the head dim contiguous
        b, t, h, hkv, d, valids = 3, 300, 16, 2, 64, (0, 1, 300)
        wide = r(2, b, t, hkv, 2 * d)
        k, v = wide[0, ..., :d], wide[1, ..., d:]
    elif case == "cache_4096_ragged":
        b, t, h, hkv, d, valids = 4, 4096, 32, 8, 128, (1, 1000, 2048, 4096)
        k, v = r(b, t, hkv, d), r(b, t, hkv, d)
    else:  # olmoe's heads (G = 1); a live length past T is clamped
        b, t, h, hkv, d, valids = 3, 200, 16, 16, 128, (0, 200, 377)
        k, v = r(b, t, hkv, d), r(b, t, hkv, d)
    q = r(b, 1, h, d)
    valid = torch.tensor(valids, dtype=torch.int32, device="cuda")
    splits = tsa.decode_splits(b, hkv, t, torch.cuda.get_device_properties(0).multi_processor_count)
    before = (tsa.sfc_decode_attention.launches, tsa.sfc_decode_attention.launches_by_splits[splits])
    got = tsa.sfc_decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert (tsa.sfc_decode_attention.launches, tsa.sfc_decode_attention.launches_by_splits[splits]) == (
        before[0] + 1, before[1] + 1)
    want = tsa.sfc_decode_attention_plain(q, k, v, valid, k_chunk=build.DECODE_CHUNK, splits=splits)
    assert _agree(got, want, dt)
    if 0 in valids:
        assert torch.all(got[valids.index(0)] == 0)


@pytest.mark.cuda
def test_cluster_kernels_replay_in_a_cuda_graph_with_no_state_left():
    """The split decode and the cluster GEMM keep no counter or scratch on
    the device: a captured graph of both, replayed three times, gives the
    eager outputs bitwise every time (a launch that left state behind would
    change the next one's), and the launch counters count the capture only."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn((4, 1, 32, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((4, 145, 8, 128), generator=gen, device="cuda").bfloat16() for _ in range(2))
    valid = torch.tensor([129, 134, 0, 145], dtype=torch.int32, device="cuda")
    a = torch.randn((4, 2560), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((2560, 1024), generator=gen, device="cuda") * 0.05).bfloat16()

    def step():
        return tsa.sfc_decode_attention(q, k, v, valid), tk.sfc_gemm_fused(a, w, abft=True)

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    counts = (tsa.sfc_decode_attention.launches, tk.sfc_gemm_fused.launches)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0])
        assert all(torch.equal(x, y) for x, y in zip(out[1], eager[1]))
    assert (tsa.sfc_decode_attention.launches, tk.sfc_gemm_fused.launches) == counts


@pytest.mark.cuda
def test_attention_kernels_reject_what_they_do_not_take():
    _card()
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        tsa.sfc_flash_fwd(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(ValueError, match="head dims"):
        tsa.sfc_flash_fwd(q[..., :32], k[..., :32], v[..., :32], causal=True)
    with pytest.raises(ValueError, match="compiled for"):
        tsa.sfc_flash_fwd(q, k, v, causal=True, q_chunk=32, k_chunk=32)
    with pytest.raises(ValueError, match="aligned"):
        tsa.sfc_flash_fwd(q.transpose(1, 3).contiguous().transpose(1, 3), k, v, causal=True)
    valid = torch.tensor([8], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        tsa.sfc_decode_attention(q[:, :1], k, v, valid.long())
    with pytest.raises(ValueError, match="exceeds"):
        tsa.sfc_decode_attention(q[:, :1].repeat(1, 1, 9, 1), k[:, :, :1], v[:, :, :1], valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_preact_kernel_matches_plain_version_on_card(dtype, batched):
    _card()
    dt = getattr(torch, dtype)
    a, b, bg, bias, gbias, _ = _inputs(dt, seed=11)
    a = a if batched else a[0]
    got = tk.sfc_gemm_fused(a, b, bg, bias, gbias, preact=True)
    torch.cuda.synchronize()
    want = tk.sfc_gemm_fused_plain(a, b, bg, bias, gbias, bm=64, bn=64, preact=True)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        assert _agree(g, w, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("shape", [(77, 133, 203), (256, 192, 512), (5, 64, 1000)])
def test_nt_tn_kernels_match_plain_versions_on_card(dtype, dual, shape):
    _card()
    dt = getattr(torch, dtype)
    m, k, n = shape  # forward (M, K) @ (K, N): dA (M, K) = dC W^T, dW (K, N) = A^T dC
    rng = np.random.default_rng(12)
    dc, dc2, x = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dt)
                  for s in ((m, n), (m, n), (m, k)))
    w, w2 = (torch.from_numpy((rng.standard_normal((k, n)) * 0.1).astype(np.float32)).to("cuda", dt)
             for _ in range(2))
    before = (tk.sfc_gemm_nt.launches, tk.sfc_gemm_tn.launches)
    da = tk.sfc_gemm_nt(dc, w, dc2 if dual else None, w2 if dual else None)
    dw = tk.sfc_gemm_tn(x, dc, dc2 if dual else None)
    torch.cuda.synchronize()
    assert (tk.sfc_gemm_nt.launches, tk.sfc_gemm_tn.launches) == (before[0] + 1, before[1] + 1)
    want_da = tk.sfc_gemm_nt_plain(dc, w, dc2 if dual else None, w2 if dual else None, bm=64, bn=64)
    want_dw = tk.sfc_gemm_tn_plain(x, dc, dc2 if dual else None, bm=64, bn=64)
    assert da.dtype == dt and da.shape == (m, k)
    assert _agree(da, want_da, dt)
    for g, w_ in zip(dw if dual else [dw], want_dw if dual else [want_dw]):
        assert g.dtype == dt and g.shape == (k, n)
        assert _agree(g, w_, dt)


@pytest.mark.cuda
def test_backward_gemm_kernels_reject_what_they_do_not_take():
    _card()
    a, b = torch.ones(4, 8, device="cuda"), torch.ones(8, 8, device="cuda")
    with pytest.raises(TypeError):
        tk.sfc_gemm_nt(a.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        tk.sfc_gemm_nt(a, b.T)
    with pytest.raises(ValueError, match="compiled for"):
        tk.sfc_gemm_tn(a, a, bm=32, bn=32)
    # the update mode needs W and a (12,) f32 hyper vector beside f32 state
    with pytest.raises(ValueError, match="update mode"):
        tk.sfc_gemm_tn(a, a, master=b, mu=b, nu=b, hyper=torch.zeros(12, device="cuda"))
    with pytest.raises(ValueError, match="hyper"):
        tk.sfc_gemm_tn(a, a, master=b, mu=b, nu=b, w=b.clone(), hyper=torch.zeros(11, device="cuda"))
    # no fallback: a launch the kernel refuses (update mode without W) raises
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk._launch_tn_update(a, a, None, [(b, b, b, None)], torch.zeros(12, device="cuda"), salt=0,
                             stochastic_round=False, rows=8, cols=8, depth=4, vec_a=False, vec_b=False)


@pytest.mark.cuda
@pytest.mark.parametrize("k_layers", [1, 2, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "batched_shared", "per_batch_weights", "f32_copies", "kbf4"])
def test_replicated_kernels_match_plain_versions_on_card(case, dtype, k_layers):
    """K4 / K5 (the partial copies) and K6 (their sum) against their plain
    versions on ragged shapes (K = 203, whose split at kbf 4 is the JAX
    package's 104 + 99, not 102 + 101), and the whole unfused product with
    every epilogue flag against the same call on the CPU."""
    _card()
    dt = getattr(torch, dtype)
    a, b, _, bias, _, res = _inputs(dt, seed=11)
    args, kw = {
        "plain": ((a[0], b), {}),
        "batched_shared": ((a, b), {}),
        "per_batch_weights": ((a, b[None].repeat(3, 1, 1).contiguous()), {}),
        "f32_copies": ((a, b), dict(out_dtype=torch.float32)),
        "kbf4": ((a, b), dict(k_block_factor=4)),
    }[case]
    kw = dict(kw, k_layers=k_layers)
    before = (tk.sfc_gemm_replicated.launches, tk.add_reduce.launches)
    copies = tk.sfc_gemm_replicated(*args, **kw)
    summed = tk.add_reduce(copies)
    torch.cuda.synchronize()
    assert (tk.sfc_gemm_replicated.launches, tk.add_reduce.launches) == (before[0] + 1, before[1] + 1)
    want = tk.sfc_gemm_replicated_plain(*args, bm=64, bn=64, **kw)
    assert copies.dtype == want.dtype and copies.shape == want.shape
    assert _agree(copies, want, copies.dtype)
    assert _agree(summed, tk.add_reduce_plain(copies), copies.dtype)
    if case == "batched_shared":
        # the unfused call: the sum of these copies in their type, then
        # the epilogue in f32 and one cast (in bf16 held to the copies the
        # kernel wrote: each is rounded before the sum); in f32 also
        # against the same call on the CPU
        ops_kw = dict(bias=bias, activation="gelu", out_scale=0.7, residual=res, k_layers=k_layers, fuse=False)
        got = tops.sfc_matmul(a, b, **ops_kw)
        want = tk._epilogue(tk.add_reduce_plain(copies).float(), None, bias, None, res, "gelu", 0.7).to(dt)
        assert got.dtype == dt and _agree(got, want, dt)
        if dt == torch.float32:
            cpu = tops.sfc_matmul(a.cpu(), b.cpu(), bm=64, bn=64,
                                  **{key: v.cpu() if isinstance(v, torch.Tensor) else v for key, v in ops_kw.items()})
            assert _agree(got.cpu(), cpu, dt)


@pytest.mark.cuda
def test_replicated_kernels_reject_what_they_do_not_take():
    _card()
    a, b = torch.ones(4, 8, device="cuda"), torch.ones(8, 8, device="cuda")
    with pytest.raises(TypeError):
        tk.sfc_gemm_replicated(a.bfloat16(), b.bfloat16(), out_dtype=torch.float16)
    with pytest.raises(ValueError, match="compiled for"):
        tk.sfc_gemm_replicated(a, b, bm=32, bn=32)
    with pytest.raises(ValueError, match="contiguous"):
        tk.sfc_gemm_replicated(a, torch.ones(8, 8, device="cuda").T)
    with pytest.raises(ValueError, match="contiguous"):
        tk.add_reduce(torch.ones(2, 8, 4, device="cuda").transpose(1, 2))
    with pytest.raises(TypeError):
        tk.add_reduce(torch.ones(2, 4, 8, device="cuda").half())


def _state(rng, k, n, dtype):
    """f32 master / mu / nu of a later step (the moments away from zero, so
    the update is smooth in dW) and the weight, all on the card."""
    mst = rng.standard_normal((k, n)) * 0.02
    mu = rng.standard_normal((k, n)) * 0.5
    nu = (rng.standard_normal((k, n)) * 2.0) ** 2 + 0.1
    f32 = [torch.from_numpy(x.astype(np.float32)).to("cuda") for x in (mst, mu, nu)]
    return f32, f32[0].to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.37, 0.0])
@pytest.mark.parametrize("dtype,sr", [("float32", False), ("bfloat16", False), ("bfloat16", True)])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("shape", [(77, 133, 203), (256, 192, 512)])
def test_tn_update_and_norm_modes_match_plain_versions_on_card(shape, dual, dtype, sr, scale):
    """K8's update mode against its plain version: master, mu, nu within
    the f32 bound (dW is summed in another order), a bf16 W with
    stochastic rounding bitwise the rounding of the kernel's own master
    with the plain version's tile bits and within one bf16 ulp of the plain
    W, scale 0 leaving the state bitwise unchanged; the norm mode's norms
    bitwise the update mode's and within the f32 bound of the plain's."""
    _card()
    from repro_torch.optim.adamw import AdamWConfig, pack_adamw_hyper

    dt = getattr(torch, dtype)
    m, k, n = shape
    rng = np.random.default_rng(31)
    x, dc, dc2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dt)
                  for s in ((m, k), (m, n), (m, n)))
    hyper = pack_adamw_hyper(AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device="cuda"),
                             torch.tensor(scale, device="cuda"))
    sets = [_state(rng, k, n, dt) for _ in range(2 if dual else 1)]
    kw = dict(salt=(5 << 16) + 3, stochastic_round=sr)

    def run(fn, **extra):
        state = [([t.clone() for t in f32], w.clone()) for f32, w in sets]
        args = [t for f32, _ in state for t in f32] + [None] * (0 if dual else 3)
        ws = dict(w=state[0][1], w2=state[1][1] if dual else None)
        norms = fn(x, dc, dc2 if dual else None, *args, hyper, **ws, **kw, **extra)
        return norms, state

    before = dict(tk.sfc_gemm_tn.launches_by_mode)
    got_norms, got = run(tk.sfc_gemm_tn)
    only_norms = tk.sfc_gemm_tn(x, dc, dc2 if dual else None, norm=True)
    torch.cuda.synchronize()
    after = tk.sfc_gemm_tn.launches_by_mode
    assert (after["update"] - before.get("update", 0), after["norm"] - before.get("norm", 0)) == (1, 1)
    want_norms, want = run(tk.sfc_gemm_tn_plain, bm=64, bn=64)
    assert torch.equal(only_norms, got_norms)
    assert _agree(got_norms, want_norms, torch.float32)
    for s, ((g_f32, g_w), (w_f32, w_w), (o_f32, o_w)) in enumerate(zip(got, want, sets)):
        if scale == 0.0:
            for g, o in zip(g_f32, o_f32):
                assert torch.equal(g, o)
            assert torch.equal(g_w, o_f32[0].to(dt))
            continue
        for g, w_ in zip(g_f32, w_f32):
            assert _agree(g, w_, torch.float32)
        if sr and dt == torch.bfloat16:
            bits = tk._tile_bits(k, n, 64, 64, hyper, kw["salt"], *((1,) if s else ()))
            assert torch.equal(g_w, tk.stochastic_round_to(g_f32[0], bits, dt))
        else:
            assert torch.equal(g_w, g_f32[0].to(dt))
        ulp = 2.0**-7 * torch.maximum(g_w.float().abs(), w_w.float().abs())
        assert bool(((g_w.float() - w_w.float()).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case",
    ["train_shape", "gqa_ragged_s_ne_t", "q_offset_past_the_queries", "non_causal_d64"],
)
def test_flash_bwd_kernels_match_plain_versions_on_card(dtype, case):
    _card()
    dt = getattr(torch, dtype)
    (b, s, t, h, hkv, d), kw = {
        "train_shape": ((2, 256, 256, 32, 8, 128), dict(causal=True)),
        "gqa_ragged_s_ne_t": ((2, 100, 150, 8, 2, 128), dict(causal=True, q_offset=30)),
        # k tiles past every query position (T > S + q_offset) flush zeros
        "q_offset_past_the_queries": ((1, 40, 230, 4, 1, 64), dict(causal=True, q_offset=20)),
        "non_causal_d64": ((1, 70, 130, 6, 3, 64), dict(causal=False)),
    }[case]
    q, k, v = _attn_inputs(b, s, t, h, hkv, d, dt, seed=23)
    do = _attn_inputs(b, s, t, h, hkv, d, dt, seed=24)[0]
    # bf16 takes the wgmma kernels (K13 a cluster of the group's q heads), f32 the tile kernels
    wgmma = dtype == "bfloat16"
    _check_flash_bwd(q, k, v, do, kw, ("flash_bwd_dq_wgmma_kernel", 1) if wgmma else ("flash_bwd_dq_kernel", 1),
                     _dkv_wgmma_key(q, k) if wgmma else ("flash_bwd_dkv_kernel", 1))


def _dkv_wgmma_key(q, k):
    """K13's launch key on the wgmma kernel: its CTAs a cluster,
    `bwd_wgmma_grid`'s on this card."""
    from repro_torch.core.device import sm_count

    _, cluster = tsa.bwd_wgmma_grid("dkv", q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                                    sm_count(q.device))
    return "flash_bwd_dkv_wgmma_kernel", cluster


def _check_flash_bwd(q, k, v, do, kw, dq_kernel, dkv_kernel):
    """One K12 and one K13 launch on the given (kernel, configuration)
    keys, each against its plain version in the same order (K13's parts of
    the group: its configuration, its CTAs a cluster)."""
    dt = q.dtype
    o, lse = tsa.sfc_flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    before = (tsa.sfc_flash_bwd_dq.launches, tsa.sfc_flash_bwd_dkv.launches)
    dq, (dk, dv) = _launched_bwd(q, k, v, do, lse, delta, kw, dq_kernel, dkv_kernel)
    torch.cuda.synchronize()
    assert (tsa.sfc_flash_bwd_dq.launches, tsa.sfc_flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    qc, kc = tsa.kernel_chunks()
    want_dq = tsa.sfc_flash_bwd_dq_plain(q, k, v, do, lse, delta, q_chunk=qc, k_chunk=kc, **kw)
    dqc, dkc = build.ATTN_DKV_TILE[build.DTYPE_NAMES[str(dt).split(".")[1]]]
    want_dk, want_dv = tsa.sfc_flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_chunk=dqc, k_chunk=dkc,
                                                   group_parts=dkv_kernel[1], **kw)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dt and got.shape == want.shape
        assert _agree(got, want, dt)


def _launched_bwd(q, k, v, do, lse, delta, kw, dq_kernel, dkv_kernel):
    """(dQ, (dK, dV)), asserting the one (kernel, configuration) key each
    wrapper's launches_by_kernel counted."""
    out = []
    for fn, key in ((tsa.sfc_flash_bwd_dq, dq_kernel), (tsa.sfc_flash_bwd_dkv, dkv_kernel)):
        before = dict(fn.launches_by_kernel)
        out.append(fn(q, k, v, do, lse, delta, **kw))
        added = {k_: n - before.get(k_, 0) for k_, n in fn.launches_by_kernel.items() if n != before.get(k_, 0)}
        assert added == {key: 1}, (fn.__name__, added)
    return tuple(out)


def _strided_qkv(b, s, h, hkv, d, dtype, seed):
    """q, k, v as the model's views of one fused (B, S, (H + 2 Hkv) D)
    projection: strided sequence rows, heads D apart."""
    rng = np.random.default_rng(seed)
    fused = torch.from_numpy(rng.standard_normal((b, s, (h + 2 * hkv) * d)).astype(np.float32)).to("cuda", dtype)
    q = fused[..., :h * d].view(b, s, h, d)
    k = fused[..., h * d:(h + hkv) * d].view(b, s, hkv, d)
    v = fused[..., (h + hkv) * d:].view(b, s, hkv, d)
    return q, k, v


# (b, s, t, h, hkv, d, causal keywords, strided): GQA 8:1, a group of 16
# past the 8-CTA cluster, and one group (olmoe's 16 / 16 heads) on the
# wgmma kernels; the model's strided views of a fused projection; ragged
# rows past every TMA edge
BWD_WGMMA_CASES = {
    "gqa_8_to_1": ((2, 256, 256, 32, 4, 128), dict(causal=True), False),
    "gqa_16_to_1": ((1, 300, 300, 16, 1, 128), dict(causal=True), False),
    "groups_1_olmoe": ((2, 256, 256, 16, 16, 128), dict(causal=True), False),
    "strided_fused_qkv_ragged": ((2, 190, 190, 8, 2, 128), dict(causal=True), True),
    "d64_ragged_q_offset": ((1, 77, 150, 6, 2, 64), dict(causal=True, q_offset=50), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_WGMMA_CASES))
def test_bwd_wgmma_kernels_match_plain_versions_on_card(case):
    _card()
    (b, s, t, h, hkv, d), kw, strided = BWD_WGMMA_CASES[case]
    if strided:
        q, k, v = _strided_qkv(b, s, h, hkv, d, torch.bfloat16, seed=25)
        assert not q.is_contiguous() and q.stride()[1] == (h + 2 * hkv) * d
    else:
        q, k, v = _attn_inputs(b, s, t, h, hkv, d, torch.bfloat16, seed=25)
    do = _attn_inputs(b, s, t, h, hkv, d, torch.bfloat16, seed=26)[0]
    _check_flash_bwd(q, k, v, do, kw, ("flash_bwd_dq_wgmma_kernel", 1), _dkv_wgmma_key(q, k))


@pytest.mark.cuda
def test_bwd_wgmma_kernels_replay_in_a_cuda_graph_with_no_state_left():
    """K12 and K13 on the wgmma kernels keep nothing on the device between
    launches: a CUDA graph of both replays to the eager results bitwise, and
    the replays count no launch."""
    _card()
    q, k, v = _attn_inputs(2, 256, 256, 32, 8, 128, torch.bfloat16, seed=27)
    do = _attn_inputs(2, 256, 256, 32, 8, 128, torch.bfloat16, seed=28)[0]
    o, lse = tsa.sfc_flash_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)

    def step():
        return (tsa.sfc_flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
                *tsa.sfc_flash_bwd_dkv(q, k, v, do, lse, delta, causal=True))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    counts = (dict(tsa.sfc_flash_bwd_dq.launches_by_kernel), dict(tsa.sfc_flash_bwd_dkv.launches_by_kernel))
    assert counts[0][("flash_bwd_dq_wgmma_kernel", 1)] >= 3 and counts[1][_dkv_wgmma_key(q, k)] >= 3
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(out, eager))
    assert (dict(tsa.sfc_flash_bwd_dq.launches_by_kernel), dict(tsa.sfc_flash_bwd_dkv.launches_by_kernel)) == counts


@pytest.mark.cuda
def test_calls_the_bwd_wgmma_rule_refuses_land_on_the_tile_kernels_on_card():
    """A kv cache broadcast over the batch (stride 0, which a tensor map
    does not take) and an f32 call take the 64 x 64 tile kernels; a wgmma
    launch that the kernel refuses (a cluster that does not divide the
    group) raises, with no fallback and no count."""
    _card()
    q, k, v = _attn_inputs(2, 100, 100, 8, 2, 128, torch.bfloat16, seed=29)
    do = _attn_inputs(2, 100, 100, 8, 2, 128, torch.bfloat16, seed=30)[0]
    kb, vb = k[:1].expand(2, -1, -1, -1), v[:1].expand(2, -1, -1, -1)
    assert kb.stride(0) == 0
    _check_flash_bwd(q, kb, vb, do, dict(causal=True), ("flash_bwd_dq_kernel", 1), ("flash_bwd_dkv_kernel", 1))
    o, lse = tsa.sfc_flash_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    tab_q, rows = tsa._device_band(2, 2, True, 0, q.device, 64, 64, True)
    counts = (tsa.sfc_flash_bwd_dkv.launches, dict(tsa.sfc_flash_bwd_dkv.launches_by_kernel))
    with pytest.raises(RuntimeError, match="CUDA error"):
        tsa._launch_bwd("dkv", q, k, v, do, lse, delta, (torch.empty_like(k), torch.empty_like(v)), tab_q, rows,
                        causal=True, seq_q=100, seq_k=100, q_offset=0, wgmma=True, cluster=3)
    assert (tsa.sfc_flash_bwd_dkv.launches, dict(tsa.sfc_flash_bwd_dkv.launches_by_kernel)) == counts
    q, k, v, do = (x.float() for x in (q, k, v, do))
    _check_flash_bwd(q, k, v, do, dict(causal=True), ("flash_bwd_dq_kernel", 1), ("flash_bwd_dkv_kernel", 1))



# the launch rule's table: (dtype, head dim, strides of q / k / v / dO,
# bases) -> the wgmma kernels?  Strides are (batch, seq, head, dim)
# in elements, as `_tma_strides` gives them.
_QS, _KS = (256 * 32 * 128, 32 * 128, 128, 1), (256 * 8 * 128, 8 * 128, 128, 1)
_FUSED = (256 * 48 * 128, 48 * 128, 128, 1)  # views of a fused (B, S, (32 + 2 * 8) * 128) projection
BWD_RULE_TABLE = {
    "train_bf16_d128": (torch.bfloat16, 128, (_QS, _KS, _KS, _QS), (0, 4096, 8192, 16), True),
    "fused_projection_views": (torch.bfloat16, 128, (_FUSED, _FUSED, _FUSED, _QS), (0, 8192, 10240, 64), True),
    "d64": (torch.bfloat16, 64, ((64, 64, 64, 1),) * 4, (0, 16, 32, 48), True),
    "f32": (torch.float32, 128, (_QS, _KS, _KS, _QS), (0, 4096, 8192, 16), False),
    "fp16": (torch.float16, 128, (_QS, _KS, _KS, _QS), (0, 4096, 8192, 16), False),
    "d16_reduced": (torch.bfloat16, 16, ((16, 16, 16, 1),) * 4, (0, 16, 32, 48), False),
    "base_8_bytes": (torch.bfloat16, 128, (_QS, _KS, _KS, _QS), (0, 4096, 8200, 16), False),
    "row_stride_not_16_bytes": (torch.bfloat16, 128, (_QS, (1, 132, 128, 1), _KS, _QS), (0, 16, 32, 48), False),
    "strided_dim": (torch.bfloat16, 128, (_QS, (1, 1024, 128, 2), _KS, _QS), (0, 16, 32, 48), False),
    "zero_batch_stride": (torch.bfloat16, 128, (_QS, (0, 1024, 128, 1), _KS, _QS), (0, 16, 32, 48), False),
}


@pytest.mark.parametrize("case", list(BWD_RULE_TABLE))
def test_bwd_wgmma_launch_rule_table(case):
    dtype, d, strides, bases, want = BWD_RULE_TABLE[case]
    assert tsa.uses_bwd_wgmma_kernel(dtype, d, strides, bases) is want


def test_tma_strides_replace_what_a_dim_of_extent_one_leaves_arbitrary():
    x = torch.zeros(2000, dtype=torch.bfloat16).as_strided((1, 5, 1, 64), (7, 320, 3, 1))
    assert tsa._tma_strides(x) == (1600, 320, 64, 1)
    y = torch.zeros(2, 256, 48, 128, dtype=torch.bfloat16)[:, :, :32]
    assert tsa._tma_strides(y) == y.stride() == (256 * 48 * 128, 48 * 128, 128, 1)


def test_bwd_wgmma_grids_are_functions_of_the_shapes():
    # qwen3-4b's training step (2 x 256 tokens, 32 / 8 heads): K12 256 CTAs;
    # K13 clusters of 2 CTAs, two q heads each (4 would need two waves at one
    # CTA an SM); olmoe's 16 / 16: 128 CTAs of one head
    assert tsa.bwd_wgmma_grid("dq", 2, 256, 256, 32, 8) == ((4, 64), 1)
    assert tsa.bwd_wgmma_grid("dkv", 2, 256, 256, 32, 8) == ((8, 16), 2)
    assert tsa.bwd_wgmma_grid("dkv", 2, 256, 256, 16, 16) == ((4, 32), 1)
    assert tsa.bwd_wgmma_grid("dq", 1, 2048, 2048, 32, 8) == ((32, 32), 1)
    # past one wave even at C 1: the smallest C of two waves or more
    assert tsa.bwd_wgmma_grid("dkv", 1, 2048, 2048, 32, 8) == ((64, 8), 2)
    assert tsa.bwd_wgmma_grid("dkv", 4, 2048, 2048, 32, 8) == ((32, 32), 1)
    assert tsa.bwd_wgmma_grid("dkv", 1, 1024, 1024, 64, 1) == ((128, 1), 8)  # 64 heads: at most 8 CTAs a cluster
    assert tsa.bwd_wgmma_grid("dkv", 1, 190, 250, 32, 8) == ((16, 8), 4)
    assert tsa.bwd_wgmma_grid("dkv", 2, 256, 256, 32, 8, sm_count=264) == ((16, 16), 4)
    assert tsa.bwd_wgmma_grid("dkv", 2, 256, 256, 24, 8) == ((4, 16), 1)  # a group of 3: 3 CTAs need two waves
    with pytest.raises(ValueError):
        tsa.bwd_wgmma_grid("fwd", 1, 64, 64, 4, 4)


def test_bwd_wgmma_entries_and_constants_match_the_compiled_source():
    src = ATTN_SOURCE.read_text()
    assert build.MAX_BWD_CLUSTER == int(re.search(r"constexpr int kMaxCluster = (\d+);", src).group(1))
    for kind in ("DQ", "DKV"):
        dims = tuple(int(d) for d in re.findall(rf"^SFC_{kind}_WGMMA_ENTRY\((\d+)\)", src, re.MULTILINE))
        assert dims == build.ATTN_HEAD_DIMS
    assert build.attn_entry_name("dq_wgmma", "bf16", 128) == "sfc_attn_dq_wgmma_bf16_d128"
    assert build.attn_entry_name("dkv_wgmma", "bf16", 64) == "sfc_attn_dkv_wgmma_bf16_d64"
    for kind in ("dq_wgmma", "dkv_wgmma"):
        with pytest.raises(ValueError):
            build.attn_entry_name(kind, "f32", 128)
    # both libraries take Hopper's primitives from the one header
    hopper = ATTN_SOURCE.with_name("hopper.cuh")
    assert '#include "hopper.cuh"' in src and '#include "hopper.cuh"' in WGMMA_SOURCE.read_text()
    assert hopper in build._sources(ATTN_SOURCE) and hopper in build._sources(CU_SOURCE)
    for fn in ("tma_load_4d", "tensor_map_4d", "wgmma_rs", "wgmma_ss", "desc_sw128", "mbar_wait"):
        assert re.search(rf"\b{fn}\(", hopper.read_text()), fn
        assert not re.search(rf"(void|int|uint64_t) {fn}\(", WGMMA_SOURCE.read_text()), fn


@pytest.mark.parametrize("dtype,parts", [(torch.bfloat16, 2), (torch.float32, 1)])
def test_cpu_dkv_wrapper_sums_in_the_order_the_card_takes(dtype, parts):
    """On a CPU tensor the dK/dV wrapper runs the plain version in the order
    the card's kernel for these operands would (`H100_SMS` SMs): in parts
    of the group, one a CTA of K13's cluster, for a call the wgmma kernel
    takes; one accumulator else."""
    rng = np.random.default_rng(32)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dtype)
                   for sh in ((2, 256, 32, 64), (2, 256, 8, 64), (2, 256, 8, 64), (2, 256, 32, 64)))
    o, lse = tsa.sfc_flash_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    assert tsa._bwd_route(q, k, v, do)[0] is (parts > 1)
    before = dict(tsa.sfc_flash_bwd_dkv.launches_by_kernel)
    got = tsa.sfc_flash_bwd_dkv(*args, causal=True)
    assert dict(tsa.sfc_flash_bwd_dkv.launches_by_kernel) == before
    want = tsa.sfc_flash_bwd_dkv_plain(*args, causal=True, q_chunk=64, k_chunk=64, group_parts=parts)
    other = tsa.sfc_flash_bwd_dkv_plain(*args, causal=True, q_chunk=64, k_chunk=64, group_parts=4 // parts)
    for g, w, o_ in zip(got, want, other):
        assert torch.equal(g, w)
        assert _agree(g, o_, torch.bfloat16)
    with pytest.raises(ValueError, match="divide"):
        tsa.sfc_flash_bwd_dkv_plain(*args, causal=True, q_chunk=64, k_chunk=64, group_parts=3)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["blockwise", "sfc"])
def test_decoder_loss_gradients_under_sfc_cuda_match_torch_on_card(attn_impl):
    """The backward of every projection runs on the NT/TN kernels: each
    projection weight gets a gradient, and every gradient matches the
    torch backend's (f32, a reduced decoder with the full head dim 128)."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.core.gemm_backend import gemm_backend
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), head_dim=128, attn_impl=attn_impl)
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(5))
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {key: torch.randint(0, cfg.vocab, (2, 96), generator=gen, device="cuda") for key in ("tokens", "labels")}
    grads, losses = {}, {}
    for backend in ("sfc_cuda", "torch"):
        model.zero_grad(set_to_none=True)
        before = (tk.sfc_gemm_nt.launches, tk.sfc_gemm_tn.launches)
        with gemm_backend(backend):
            loss = model.loss(batch)
            loss.backward()
        torch.cuda.synchronize()
        launched = (tk.sfc_gemm_nt.launches - before[0], tk.sfc_gemm_tn.launches - before[1])
        assert launched == ((6 * cfg.n_layers + 1,) * 2 if backend == "sfc_cuda" else (0, 0))
        losses[backend] = float(loss)
        grads[backend] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    names = {n for n, _ in model.named_parameters()}
    projections = {n for n in names if n.split(".")[-1] in ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "head")}
    assert len(projections) == 7 * cfg.n_layers + 1
    assert set(grads["sfc_cuda"]) == set(grads["torch"]) == names
    for n in projections:
        assert bool(grads["sfc_cuda"][n].abs().max() > 0), n
    assert abs(losses["sfc_cuda"] - losses["torch"]) <= 1e-4 * abs(losses["torch"])
    for n in names:
        assert _agree(grads["sfc_cuda"][n], grads["torch"][n], torch.float32), n


def test_grouped_modes_are_arguments_of_the_existing_entries():
    """K3, K9 and K10 (dW, and its update and norm modes) are the grouped
    modes of the forward, NT, TN and TN-update kernels: each entry takes
    the per-expert row array, and no part is added to the build."""
    src = CU_SOURCE.read_text()
    for entry in ("SFC_ENTRY", "SFC_NT_ENTRY", "SFC_TN_ENTRY", "SFC_TNU_ENTRY"):
        decl = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
        assert "const int* grp, int n_groups, void* stream" in decl, entry
    # 16 forward, 2 NT / TN and 2 TN-update parts, the replicated form's
    # own 2 (K4/K5 and K6, one per input type), and the ABFT lanes' 20 (a
    # twin of each forward part, a TN and a TN-update part per input type)
    parts = dict(build._gemm_parts())
    assert len(parts) == 42 and sum(name.startswith("sfc_gemm_rep_") for name in parts) == 2
    assert sum("abft" in name for name in parts) == 20


def _grouped_inputs(rng, group_sizes, k, n, dtype, scale=0.1):
    t, e = sum(group_sizes), len(group_sizes)

    def r(*shape, c=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * c).astype(np.float32)).to("cuda", dtype)

    return r(t, k), r(e, k, n, c=scale), r(e, k, n, c=scale), r(e, n), r(e, n), r(t, n), r(t, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kn", [(256, 192), (203, 133)])
@pytest.mark.parametrize("group_sizes", [(5, 0, 19, 32), (80,) * 6, (1, 130, 0, 64)])
def test_grouped_kernels_match_plain_versions_on_card(group_sizes, kn, dtype):
    """K3 (linear, GLU with its activation in the flush, GLU preact, bias +
    relu + scale), K9 (single and dual) and K10 (single and dual) against
    their plain versions, on ragged expert sizes with empty experts; one
    launch each."""
    _card()
    dt = getattr(torch, dtype)
    k, n = kn
    a, w, wg, bias, gbias, dc, dc2 = _grouped_inputs(np.random.default_rng(14), group_sizes, k, n, dt)
    gs = dict(group_sizes=group_sizes)
    forms = [((a, w), {}), ((a, w, wg), dict(activation="silu")), ((a, w, wg, bias, gbias), dict(preact=True)),
             ((a, w, None, bias), dict(activation="relu", out_scale=0.5))]
    for args, kw in forms:
        before = tk.sfc_gemm_grouped.launches
        got = tk.sfc_gemm_grouped(*args, **gs, **kw)
        torch.cuda.synchronize()
        assert tk.sfc_gemm_grouped.launches == before + 1
        want = tk.sfc_gemm_grouped_plain(*args, bm=64, bn=64, **gs, **kw)
        for g, w_ in zip(got if kw.get("preact") else [got], want if kw.get("preact") else [want]):
            assert g.dtype == dt and g.shape == (sum(group_sizes), n)
            assert _agree(g, w_, dt), kw
    for dual in (False, True):
        extra = (dc2, wg) if dual else (None, None)
        before = (tk.sfc_gemm_grouped_nt.launches, tk.sfc_gemm_grouped_tn.launches)
        da = tk.sfc_gemm_grouped_nt(dc, w, *extra, **gs)
        dw = tk.sfc_gemm_grouped_tn(a, dc, dc2 if dual else None, **gs)
        torch.cuda.synchronize()
        assert (tk.sfc_gemm_grouped_nt.launches, tk.sfc_gemm_grouped_tn.launches) == (before[0] + 1, before[1] + 1)
        assert da.shape == (sum(group_sizes), k) and _agree(da, tk.sfc_gemm_grouped_nt_plain(
            dc, w, *extra, bm=64, bn=64, **gs), dt)
        want_dw = tk.sfc_gemm_grouped_tn_plain(a, dc, dc2 if dual else None, bm=64, bn=64, **gs)
        for g, w_ in zip(dw if dual else [dw], want_dw if dual else [want_dw]):
            assert g.shape == (len(group_sizes), k, n) and _agree(g, w_, dt)
            for e, size in enumerate(group_sizes):
                if size == 0:
                    assert not bool(g[e].any())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.37, 0.0])
@pytest.mark.parametrize("dtype,sr", [("float32", False), ("bfloat16", False), ("bfloat16", True)])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("group_sizes,kn", [((5, 0, 19, 32), (203, 133)), ((80,) * 6, (256, 192)),
                                            ((0, 0, 0), (64, 96))])
def test_grouped_tn_update_and_norm_modes_match_plain_versions_on_card(group_sizes, kn, dual, dtype, sr, scale):
    """K10's update mode against its plain version, on ragged experts with
    an empty one and on a dispatch with no rows at all (every expert takes
    the g = 0 update): master, mu, nu within the f32 bound, a bf16 W with
    stochastic rounding bitwise the rounding of the kernel's own master
    with the plain version's grouped tile bits and within one bf16 ulp of
    the plain W, scale 0 leaving the state bitwise unchanged; the norm
    mode's norms bitwise the update mode's and within the f32 bound of the
    plain's; one launch of each mode."""
    _card()
    from repro_torch.optim.adamw import AdamWConfig, pack_adamw_hyper

    dt = getattr(torch, dtype)
    (k, n), e, t = kn, len(group_sizes), sum(group_sizes)
    rng = np.random.default_rng(32)
    x, dc, dc2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dt)
                  for s in ((t, k), (t, n), (t, n)))
    hyper = pack_adamw_hyper(AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device="cuda"),
                             torch.tensor(scale, device="cuda"))
    sets = []
    for _ in range(2 if dual else 1):
        mst, mu, nu = (rng.standard_normal((e, k, n)) * c for c in (0.02, 0.5, 2.0))
        f32 = [torch.from_numpy(v.astype(np.float32)).to("cuda") for v in (mst, mu, nu ** 2 + 0.1)]
        sets.append((f32, f32[0].to(dt)))
    kw = dict(group_sizes=group_sizes, salt=(5 << 16) + 3, stochastic_round=sr)

    def run(fn, **extra):
        state = [([v.clone() for v in f32], w.clone()) for f32, w in sets]
        args = [v for f32, _ in state for v in f32] + [None] * (0 if dual else 3)
        ws = dict(w=state[0][1], w2=state[1][1] if dual else None)
        norms = fn(x, dc, dc2 if dual else None, *args, hyper, **ws, **kw, **extra)
        return norms, state

    before = dict(tk.sfc_gemm_grouped_tn.launches_by_mode)
    got_norms, got = run(tk.sfc_gemm_grouped_tn)
    only_norms = tk.sfc_gemm_grouped_tn(x, dc, dc2 if dual else None, group_sizes=group_sizes, norm=True)
    torch.cuda.synchronize()
    after = tk.sfc_gemm_grouped_tn.launches_by_mode
    assert (after["update"] - before.get("update", 0), after["norm"] - before.get("norm", 0)) == (1, 1)
    want_norms, want = run(tk.sfc_gemm_grouped_tn_plain, bm=64, bn=64)
    assert torch.equal(only_norms, got_norms)
    assert _agree(got_norms, want_norms, torch.float32)
    for s, ((g_f32, g_w), (w_f32, w_w), (o_f32, o_w)) in enumerate(zip(got, want, sets)):
        if scale == 0.0:
            for g, o in zip(g_f32, o_f32):
                assert torch.equal(g, o)
            assert torch.equal(g_w, o_f32[0].to(dt))
            continue
        for g, w_, o in zip(g_f32, w_f32, o_f32):
            assert _agree(g, w_, torch.float32)
            assert not torch.equal(g, o)  # every expert moved, an empty one by its g = 0 update
        if sr and dt == torch.bfloat16:
            bits = tk._grouped_tile_bits(e, k, n, 64, 64, hyper, kw["salt"], s)
            assert torch.equal(g_w, tk.stochastic_round_to(g_f32[0], bits, dt))
        else:
            assert torch.equal(g_w, g_f32[0].to(dt))
        ulp = 2.0**-7 * torch.maximum(g_w.float().abs(), w_w.float().abs())
        assert bool(((g_w.float() - w_w.float()).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_tn_of_an_empty_dispatch_launches_and_writes_zeros_on_card(dtype):
    """A dispatch with no rows at all: K10's dW mode, single and dual,
    launches (its empty operands are null pointers) and writes zero stacks;
    the norm mode returns zero norms."""
    _card()
    dt = getattr(torch, dtype)
    a, dc = torch.empty(0, 72, device="cuda", dtype=dt), torch.empty(0, 40, device="cuda", dtype=dt)
    gs = dict(group_sizes=(0, 0, 0))
    before = tk.sfc_gemm_grouped_tn.launches
    single, (dw, dwg) = tk.sfc_gemm_grouped_tn(a, dc, **gs), tk.sfc_gemm_grouped_tn(a, dc, dc, **gs)
    norms = tk.sfc_gemm_grouped_tn(a, dc, dc, norm=True, **gs)
    torch.cuda.synchronize()
    assert tk.sfc_gemm_grouped_tn.launches == before + 3
    for out in (single, dw, dwg):
        assert out.shape == (3, 72, 40) and not bool(out.any())
    assert torch.equal(norms, torch.zeros(2, device="cuda"))


@pytest.mark.cuda
def test_grouped_tn_update_mode_rejects_what_it_does_not_take():
    """No fallback: update-mode misuse raises, and a launch the kernel
    refuses (update mode without W) raises with its CUDA error."""
    _card()
    a, dc = torch.ones(6, 8, device="cuda"), torch.ones(6, 4, device="cuda")
    st = torch.zeros(2, 8, 4, device="cuda")
    hyper = torch.zeros(12, device="cuda")
    kw = dict(group_sizes=(2, 4))
    with pytest.raises(ValueError, match=r"\(2, 8, 4\)"):
        tk.sfc_gemm_grouped_tn(a, dc, None, st[0], st[0], st[0], hyper=hyper, w=st[0].clone(), **kw)
    with pytest.raises(ValueError, match="master"):
        tk.sfc_gemm_grouped_tn(a, dc, None, st.bfloat16(), st, st, hyper=hyper, w=st.clone(), **kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tk._launch_tn_update(a, dc, None, [(st, st, st, None)], hyper, salt=0, stochastic_round=False, rows=8,
                             cols=4, depth=6, vec_a=False, vec_b=False, gs=(2, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["blockwise", "sfc"])
def test_olmoe_loss_gradients_under_sfc_cuda_match_torch_on_card(attn_impl):
    """Reduced olmoe (4 layers, 8 experts top-2, f32, head dim 128): the
    router and every expert stack get their gradients through K3, K9 and
    K10, and every gradient matches the torch backend's."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.core.gemm_backend import gemm_backend
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(), head_dim=128, attn_impl=attn_impl)
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(5))
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {key: torch.randint(0, cfg.vocab, (2, 96), generator=gen, device="cuda") for key in ("tokens", "labels")}
    grads, losses = {}, {}
    kernels = (tk.sfc_gemm_grouped, tk.sfc_gemm_grouped_nt, tk.sfc_gemm_grouped_tn)
    for backend in ("sfc_cuda", "torch"):
        model.zero_grad(set_to_none=True)
        before = [fn.launches for fn in kernels]
        with gemm_backend(backend):
            loss = model.loss(batch)
            loss.backward()
        torch.cuda.synchronize()
        launched = [fn.launches - b for fn, b in zip(kernels, before)]
        assert launched == ([2 * cfg.n_layers] * 3 if backend == "sfc_cuda" else [0, 0, 0])
        losses[backend] = float(loss)
        grads[backend] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    names = {n for n, _ in model.named_parameters()}
    assert set(grads["sfc_cuda"]) == set(grads["torch"]) == names
    for n in names:
        if ".moe." in n:
            assert bool(grads["sfc_cuda"][n].abs().max() > 0), n
    assert abs(losses["sfc_cuda"] - losses["torch"]) <= 1e-4 * abs(losses["torch"])
    for n in names:
        assert _agree(grads["sfc_cuda"][n], grads["torch"][n], torch.float32), n


@pytest.mark.cuda
def test_fused_train_step_on_card_matches_unfused():
    """The fused optimizer on the card (f32, a reduced decoder with head dim
    128): two steps with a clip that binds match the unfused sfc_cuda
    steps, no weight keeps a ``.grad``, and each step launches the TN
    kernel once per projection in its norm mode and once in its update
    mode, never in its dW mode."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as opt
    from repro_torch.train.step import BackendConfig, make_train_step

    cfg = dataclasses.replace(get_config("qwen3_4b").reduced(), head_dim=128, attn_impl="sfc")
    gen = torch.Generator(device="cuda").manual_seed(8)
    batches = [{key: torch.randint(0, cfg.vocab, (2, 96), generator=gen, device="cuda")
                for key in ("tokens", "labels")} for _ in range(2)]
    opt_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2, clip_norm=1e-2)
    runs = {}
    for fused in (False, True):
        model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(5))
        step = make_train_step(model, opt_cfg, backend=BackendConfig(gemm_backend="sfc_cuda", fused_optimizer=fused))
        state = opt.adamw_init(dict(model.named_parameters()))
        before = dict(tk.sfc_gemm_tn.launches_by_mode)
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        modes = {k: v - before.get(k, 0) for k, v in tk.sfc_gemm_tn.launches_by_mode.items()}
        runs[fused] = (dict(model.named_parameters()), state, metrics, modes)
    (pu, su, mu_, _), (pf, sf, mf, modes) = runs[False], runs[True]
    per_step = 6 * cfg.n_layers + 1
    assert (modes.get("norm"), modes.get("update"), modes.get("dw", 0)) == (2 * per_step, 2 * per_step, 0)
    assert all(p.grad is None for p in pf.values())
    assert min(mu_) > 1e-2  # the clip binds
    np.testing.assert_allclose(mf, mu_, rtol=1e-4)
    for n in pu:
        assert _agree(pf[n].detach(), pu[n].detach(), torch.float32), n
        for slot in ("mu", "nu", "master"):
            assert _agree(sf[slot][n], su[slot][n], torch.float32), (slot, n)


@pytest.mark.cuda
def test_olmoe_fused_train_step_on_card_matches_unfused():
    """The fused optimizer over reduced olmoe on the card (f32, head dim
    128): two steps with a clip that binds match the unfused sfc_cuda
    steps; each step launches K8's norm and update modes once per routed
    dense projection and K10's once per expert projection, K10 never in
    its dW mode and K8 only for the unrouted router, and no weight keeps a
    ``.grad``."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw as opt
    from repro_torch.train.step import BackendConfig, make_train_step

    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(), head_dim=128, attn_impl="sfc")
    gen = torch.Generator(device="cuda").manual_seed(8)
    batches = [{key: torch.randint(0, cfg.vocab, (2, 96), generator=gen, device="cuda")
                for key in ("tokens", "labels")} for _ in range(2)]
    opt_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2, clip_norm=1e-2)
    runs = {}
    for fused in (False, True):
        model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(5))
        step = make_train_step(model, opt_cfg, backend=BackendConfig(gemm_backend="sfc_cuda", fused_optimizer=fused))
        state = opt.adamw_init(dict(model.named_parameters()))
        before = [dict(fn.launches_by_mode) for fn in (tk.sfc_gemm_tn, tk.sfc_gemm_grouped_tn)]
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        modes = [{k: v - b.get(k, 0) for k, v in fn.launches_by_mode.items()}
                 for fn, b in zip((tk.sfc_gemm_tn, tk.sfc_gemm_grouped_tn), before)]
        runs[fused] = (dict(model.named_parameters()), state, metrics, modes)
    (pu, su, mu_, _), (pf, sf, mf, (dense, grouped)) = runs[False], runs[True]
    per_step = 4 * cfg.n_layers + 1  # q, k, v, o; the head (the router stays unrouted, as in JAX)
    assert (dense.get("norm"), dense.get("update"), dense.get("dw", 0)) == (2 * per_step, 2 * per_step,
                                                                           2 * cfg.n_layers)
    assert (grouped.get("norm"), grouped.get("update"), grouped.get("dw", 0)) == (4 * cfg.n_layers,) * 2 + (0,)
    assert all(p.grad is None for p in pf.values())
    assert min(mu_) > 1e-2  # the clip binds
    np.testing.assert_allclose(mf, mu_, rtol=1e-4)
    for n in pu:
        assert _agree(pf[n].detach(), pu[n].detach(), torch.float32), n
        for slot in ("mu", "nu", "master"):
            assert _agree(sf[slot][n], su[slot][n], torch.float32), (slot, n)


def test_abft_lane_entries_are_their_own():
    """The checksum lanes (-DSFC_ABFT=1) are entries of their own beside
    the parents' (K7 has no lane)."""
    lanes = {build.entry_name(dt, glu, act, abft=True) for dt in ("f32", "bf16") for glu in (False, True)
             for act in build.ACTIVATION_CODES}
    plain = {build.entry_name(dt, glu, act) for dt in ("f32", "bf16") for glu in (False, True)
             for act in build.ACTIVATION_CODES}
    assert len(lanes) == 16 and not lanes & plain
    assert build.bwd_entry_name("tn_update", "bf16", abft=True) == "sfc_gemm_tn_update_abft_bf16"
    with pytest.raises(ValueError):
        build.bwd_entry_name("nt", "bf16", abft=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abft_lanes_match_plain_versions_on_card(dtype):
    """Each checksum lane (K1/K2 with every epilogue flag, K3 on ragged
    experts with an empty one, K8 dW dual, K8's update and norm modes)
    within chip_smoke.py's `lane_limit` of its plain version's lane (1e-5
    of the sum of |64 x 64 raw tile sums|, below `robust.abft.tolerance()`),
    where a lane of 0 or one less its last tile would miss it, and the
    outputs with the lane on bitwise those with it off."""
    _card()
    import importlib.util
    import sys

    from repro_torch.optim import adamw as opt
    from repro_torch.robust import abft

    spec = importlib.util.spec_from_file_location("chip_smoke_limits", Path(__file__).resolve().parents[1]
                                                  / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cs  # dataclasses look their module up here
    spec.loader.exec_module(cs)
    dt = getattr(torch, dtype)
    a, b, bg, bias, gbias, res = _inputs(dt)

    def close(lane, plain, mag, depth, *raws):
        tiles = cs.raw_tile_sums(torch, *raws)
        limit = cs.lane_limit(tiles, abft.tolerance(mag, depth))
        assert abs(float(lane) - float(plain)) <= limit, (float(lane), float(plain), limit)
        for name, wrong in cs._dropped(plain, tiles).items():
            assert abs(wrong - float(plain)) > limit, (name, wrong, float(plain), limit)

    # the cluster kernel's twin (bf16; f32 takes the tile kernel's) at a
    # decode-like shape with a ragged N, its plain version over its K layers
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a4, w4, wg4, bias4, _, res4 = _cluster_inputs(dt, 4, 2056, 133, True, True, False, True)
    kw = dict(activation="silu", out_scale=0.5)
    on = tk.sfc_gemm_fused(a4, w4, wg4, bias4, None, res4, abft=True, **kw)
    assert torch.equal(on[0], tk.sfc_gemm_fused(a4, w4, wg4, bias4, None, res4, **kw))
    plain = tk.sfc_gemm_fused_plain(a4.cpu(), w4.cpu(), wg4.cpu(), bias4.cpu(), None, res4.cpu(), bm=64, bn=64,
                                    abft=True, k_layers=tk.cluster_layers(2056, 133, sms), **kw)
    close(on[-1], plain[-1], abft.gemm_checksum_ref(a4, w4, wg4)[1], 2056, a4.float() @ w4.float(),
          a4.float() @ wg4.float())
    on = tk.sfc_gemm_fused(a, b, bg, bias, gbias, res, abft=True, **kw)
    assert torch.equal(on[0], tk.sfc_gemm_fused(a, b, bg, bias, gbias, res, **kw))
    plain = tk.sfc_gemm_fused_plain(a.cpu(), b.cpu(), bg.cpu(), bias.cpu(), gbias.cpu(), res.cpu(), bm=64, bn=64,
                                    abft=True, **kw)
    close(on[-1], plain[-1], abft.gemm_checksum_ref(a, b, bg)[1], 203, a.float() @ b.float(), a.float() @ bg.float())
    gs = (5, 0, 19, 32)
    ag, wg = a.reshape(-1, 203)[:56].contiguous(), b.expand(4, 203, 133).contiguous()
    on = tk.sfc_gemm_grouped(ag, wg, wg, group_sizes=gs, activation="silu", abft=True)
    assert torch.equal(on[0], tk.sfc_gemm_grouped(ag, wg, wg, group_sizes=gs, activation="silu"))
    plain = tk.sfc_gemm_grouped_plain(ag.cpu(), wg.cpu(), wg.cpu(), group_sizes=gs, activation="silu", bm=64,
                                      bn=64, abft=True)
    close(on[-1], plain[-1], abft.grouped_checksum_ref(ag, wg, wg, gs)[1], 203,
          *(2 * [cs.grouped_raw(torch, ag, wg, gs)]))
    x, dc, dc2 = a[0], res[0], res[1]
    on = tk.sfc_gemm_tn(x, dc, dc2, abft=True)
    for o, p in zip(on[:-1], tk.sfc_gemm_tn(x, dc, dc2)):
        assert torch.equal(o, p)
    plain = tk.sfc_gemm_tn_plain(x.cpu(), dc.cpu(), dc2.cpu(), bm=64, bn=64, abft=True)
    for s, d in enumerate((dc, dc2)):
        close(on[-1][s, 0], plain[-1][s, 0], abft.tn_checksum_ref(x, d)[1], 77, x.float().T @ d.float())
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(), torch.tensor(2, dtype=torch.int32, device="cuda"),
                                 torch.tensor(0.5, device="cuda"))
    sets = [[torch.full((203, 133), v, device="cuda") for v in (0.1, 0.0, 0.01)] for _ in range(2)]
    ws = [torch.zeros((203, 133), dtype=dt, device="cuda") for _ in range(2)]
    norms, chk = tk.sfc_gemm_tn(x, dc, None, *sets[0], None, None, None, hyper, w=ws[0], salt=3,
                                stochastic_round=True, abft=True)
    norms_off = tk.sfc_gemm_tn(x, dc, None, *sets[1], None, None, None, hyper, w=ws[1], salt=3,
                               stochastic_round=True)
    assert torch.equal(norms, norms_off) and torch.equal(ws[0], ws[1])
    assert all(torch.equal(p, q) for p, q in zip(*sets))
    close(chk[0, 0], plain[-1][0, 0], abft.tn_checksum_ref(x, dc)[1], 77, x.float().T @ dc.float())
    nnorms, nchk = tk.sfc_gemm_tn(x, dc, norm=True, abft=True)
    assert torch.equal(nnorms, tk.sfc_gemm_tn(x, dc, norm=True))
    close(nchk[0, 0], plain[-1][0, 0], abft.tn_checksum_ref(x, dc)[1], 77, x.float().T @ dc.float())


# ---------------------------------------------------------------------------
# the wgmma kernels: K2 (sfc_gemm_wgmma_kernel, its lane twin) and K7
# (nt_wgmma_kernel), csrc/sfc_gemm_wgmma.cuh
# ---------------------------------------------------------------------------

WGMMA_SOURCE = CU_SOURCE.with_name("sfc_gemm_wgmma.cuh")


def test_wgmma_constants_and_entries_match_the_compiled_sources():
    """build.WGMMA_TILE / WGMMA_BK are the header's; every bf16 forward
    part and its lane twin hold a wgmma entry of their own, the bf16
    backward part the NT one; the f32 parts hold none."""
    src = WGMMA_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert build.WGMMA_TILE == (const("kBM"), const("kBN")) and build.WGMMA_BK == const("kBK")
    gemm = CU_SOURCE.read_text()
    assert 'extern "C" int SFC_WGMMA_ENTRY(' in gemm and 'extern "C" int SFC_NT_WGMMA_ENTRY(' in gemm
    assert '#include "sfc_gemm_wgmma.cuh"' in gemm
    parts = dict(build._gemm_parts())
    names = set()
    for glu in (False, True):
        for act in build.ACTIVATION_CODES:
            for abft in (False, True):
                name = build.wgmma_entry_name(glu, act, abft)
                assert f"-DSFC_WGMMA_ENTRY={name}" in parts[build.entry_name("bf16", glu, act, abft)]
                assert not any(f.startswith("-DSFC_WGMMA_ENTRY") for f in parts[build.entry_name("f32", glu, act, abft)])
                names.add(name)
    assert len(names) == 16 and build.wgmma_entry_name(True, "silu", True) == "sfc_gemm_wgmma_abft_bf16_glu1_act1"
    assert f"-DSFC_NT_WGMMA_ENTRY={build.bwd_entry_name('nt_wgmma', 'bf16')}" in parts["sfc_gemm_bwd_bf16"]
    assert not any("NT_WGMMA" in f for f in parts["sfc_gemm_bwd_f32"])
    with pytest.raises(ValueError):
        build.bwd_entry_name("nt_wgmma", "f32")


def _chip_smoke():
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location("chip_smoke_limits", Path(__file__).resolve().parents[1]
                                                  / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cs  # dataclasses look their module up here
    spec.loader.exec_module(cs)
    return cs


# (lead batch dims, M, K, N, GLU, per-batch B, flags, epilogue keywords):
# qwen3-4b's 512-row prefill and training shapes (the GLU takes the wide
# tile), and ragged ones whose TMA boxes run past every edge
WGMMA_CASES = {
    "prefill_q": ((4,), 128, 2560, 4096, False, False, (), dict()),
    "prefill_kv_bias_residual_scale": ((4,), 128, 2560, 1024, False, False, ("bias", "res"),
                                       dict(activation="relu", out_scale=0.5)),
    "prefill_glu_silu": ((4,), 128, 2560, 9728, True, False, (), dict(activation="silu")),
    "train_glu_preact_biases": ((2,), 256, 2560, 9728, True, False, ("bias", "gbias"), dict(preact=True)),
    "prefill_w_out": ((4,), 128, 9728, 2560, False, False, (), dict()),
    "plain_m200_every_flag_ragged": ((), 200, 264, 328, True, False, ("bias", "gbias", "res"),
                                     dict(activation="gelu", out_scale=0.7)),
    "batched_ragged_preact": ((3,), 77, 264, 328, True, False, ("bias", "gbias"), dict(preact=True)),
    "per_batch_weights_ragged": ((3,), 77, 264, 328, False, True, ("bias", "res"), dict(out_scale=2.0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_wgmma_kernel_matches_plain_version_on_card(case):
    """The wgmma kernel against its plain version at the main path's
    shapes and ragged ones (shared and per-batch B, every epilogue flag,
    the GLU's preact), the tile `wgmma_launch` chooses; its lane twin's
    outputs bitwise the kernel's and its lane within chip_smoke.py's
    `lane_limit` over the kernel's own tiles, where a lane of 0 or less its
    last tile misses it."""
    _card()
    from repro_torch.robust import abft

    cs = _chip_smoke()
    lead, m, k, n, glu, per_batch, flags, kw = WGMMA_CASES[case]
    rng = np.random.default_rng(31)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to("cuda", torch.bfloat16)

    a = r(*lead, m, k)
    b = r(*lead, k, n, scale=0.05) if per_batch else r(k, n, scale=0.05)
    bg = r(k, n, scale=0.05) if glu else None
    args = (a, b, bg, r(n) if "bias" in flags else None, r(1, n) if "gbias" in flags else None,
            r(*lead, m, n) if "res" in flags else None)
    assert tk.uses_wgmma_kernel(a, b, bg)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = m if per_batch else m * math.prod(lead)
    cfg = tk.wgmma_launch(rows, n, sms, glu, lead[0] if per_batch else 1)
    tile = f"128x{128 * (2 if cfg.wide else 1) // (2 if glu else 1)}"
    got, key = cs.launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: tk.sfc_gemm_fused(*args, **kw))
    torch.cuda.synchronize()
    assert key == ("sfc_gemm_wgmma_kernel", tile)
    want = tk.sfc_gemm_fused_plain(*args, bm=64, bn=64, **kw)
    got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got_t, want_t):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _agree(g, w, torch.bfloat16)
    on = tk.sfc_gemm_fused(*args, abft=True, **kw)
    assert all(torch.equal(x, y) for x, y in zip(on[:-1], got_t))
    plain = tk.sfc_gemm_fused_plain(*args, bm=64, bn=64, abft=True, **kw)
    raws = [torch.matmul(a.float(), b.float())] + ([a.float() @ bg.float()] if glu else [])
    if per_batch:  # each batch element's tiles in turn: fold nothing
        tiles = cs.raw_tile_sums(torch, *raws, tile=(128, int(tile.split("x")[1])))
    else:
        tiles = cs.kernel_tiles(torch, "sfc_gemm_wgmma_kernel", tile, *raws)
    limit = cs.lane_limit(tiles, abft.tolerance(abft.gemm_checksum_ref(a, b, bg)[1], k))
    assert abs(float(on[-1]) - float(plain[-1])) <= limit
    for name, wrong in cs._dropped(plain[-1], tiles).items():
        assert abs(wrong - float(plain[-1])) > limit, name


NT_WGMMA_CASES = {  # (M, K (the output's cols), N (the contraction), dual)
    "q": (512, 2560, 4096, False),
    "glu_dual": (512, 2560, 9728, True),
    "w_out_wide": (512, 9728, 2560, False),
    "head": (512, 2560, 151936, False),
    "ragged_odd_cols_dual": (200, 203, 264, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NT_WGMMA_CASES))
def test_nt_wgmma_kernel_matches_plain_version_on_card(case):
    """The wgmma NT kernel (dA = dC W^T [+ dC2 W2^T]) against its plain
    version: single and dual, the LM head's 151936-deep contraction, and
    an output of odd width (its pairs stored one by one)."""
    _card()
    m, k, n, dual = NT_WGMMA_CASES[case]
    rng = np.random.default_rng(32)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to("cuda", torch.bfloat16)

    args = (r(m, n), r(k, n, scale=0.02)) + ((r(m, n), r(k, n, scale=0.02)) if dual else ())
    assert tk.uses_nt_wgmma_kernel(*args)
    cfg = tk.wgmma_launch(m, k, torch.cuda.get_device_properties(0).multi_processor_count)
    got, key = _chip_smoke().launched(tk.sfc_gemm_nt.launches_by_kernel, lambda: tk.sfc_gemm_nt(*args))
    torch.cuda.synchronize()
    assert key == ("nt_wgmma_kernel", f"128x{256 if cfg.wide else 128}")
    want = tk.sfc_gemm_nt_plain(*args, bm=64, bn=64)
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    assert _agree(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_wgmma_kernels_replay_in_a_cuda_graph_with_no_state_left():
    """The wgmma kernels keep no counter or queue on the device (each CTA's
    segment comes from its index): a captured graph of the forward (wide
    GLU, narrow tile with its lane) and the dual NT, replayed three times,
    gives the eager outputs bitwise every time, and the launch counters
    count the capture only."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(24)
    a = torch.randn((4, 128, 2560), generator=gen, device="cuda").bfloat16()
    w, wg = ((torch.randn((2560, 9728), generator=gen, device="cuda") * 0.02).bfloat16() for _ in range(2))
    wkv = (torch.randn((2560, 1024), generator=gen, device="cuda") * 0.02).bfloat16()
    dc = torch.randn((512, 9728), generator=gen, device="cuda").bfloat16()

    def step():
        return (tk.sfc_gemm_fused(a, w, wg, activation="silu"), tk.sfc_gemm_fused(a, wkv, abft=True),
                tk.sfc_gemm_nt(dc, w, dc, wg))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    counts = (tk.sfc_gemm_fused.launches, tk.sfc_gemm_nt.launches)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[2], eager[2])
        assert all(torch.equal(x, y) for x, y in zip(out[1], eager[1]))
    assert (tk.sfc_gemm_fused.launches, tk.sfc_gemm_nt.launches) == counts


@pytest.mark.cuda
def test_calls_the_wgmma_predicates_refuse_land_on_the_tile_kernels_on_card():
    """K 203 (rows TMA cannot describe), f32, a base off a 16-byte
    boundary and the grouped mode keep their old kernels, by
    ``launches_by_kernel``."""
    _card()
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(25)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    fused, nt = tk.sfc_gemm_fused.launches_by_kernel, tk.sfc_gemm_nt.launches_by_kernel
    flat = r(3 * 77 * 264 + 8)
    shifted = flat[1:1 + 3 * 77 * 264].view(3, 77, 264)  # 2 bytes past a 16-byte boundary
    for a, b in ((r(3, 77, 203), r(203, 328)), (r(3, 77, 264, dtype=torch.float32), r(264, 328, dtype=torch.float32)),
                 (shifted, r(264, 328))):
        assert not tk.uses_wgmma_kernel(a, b)
        assert cs.launched(fused, lambda: tk.sfc_gemm_fused(a, b))[1] == ("sfc_gemm_fused_kernel", 1)
    for dtype, n in ((torch.bfloat16, 203), (torch.float32, 264)):
        a, b = r(77, n, dtype=dtype), r(133, n, dtype=dtype)
        assert not tk.uses_nt_wgmma_kernel(a, b)
        assert cs.launched(nt, lambda: tk.sfc_gemm_nt(a, b))[1] == ("nt_kernel", 1)
    before = (dict(fused), dict(nt), tk.sfc_gemm_grouped.launches, tk.sfc_gemm_grouped_nt.launches)
    x, w = r(56, 264), (r(4, 264, 328) * 0.05).contiguous()
    tk.sfc_gemm_grouped(x, w, group_sizes=(5, 0, 19, 32))
    tk.sfc_gemm_grouped_nt(r(56, 328), w, group_sizes=(5, 0, 19, 32))
    torch.cuda.synchronize()
    assert (dict(fused), dict(nt)) == before[:2]
    assert (tk.sfc_gemm_grouped.launches, tk.sfc_gemm_grouped_nt.launches) == (before[2] + 1, before[3] + 1)
