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

import collections
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
    # bf16 takes the wgmma kernel, f32 the 64 x 64 tile kernel
    _check_flash_fwd(q, k, v, kw, _fwd_wgmma_key(q, k) if dtype == "bfloat16" else ("flash_fwd_kernel", 1))


def _fwd_wgmma_key(q, k):
    """The forward's launch key on the wgmma kernel: its W, `fwd_wgmma_grid`'s
    on this card."""
    from repro_torch.core.device import sm_count

    return "flash_fwd_wgmma_kernel", tsa.fwd_wgmma_grid(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                                                        k.shape[2], sm_count(q.device))[1]


def _counted(fn, call):
    """(call(), the keys ``fn.launches_by_kernel`` gained and by how much),
    asserting ``fn.launches`` moved by as many."""
    before, launches = dict(fn.launches_by_kernel), fn.launches
    out = call()
    added = {k_: n - before.get(k_, 0) for k_, n in fn.launches_by_kernel.items() if n != before.get(k_, 0)}
    assert fn.launches == launches + sum(added.values())
    return out, added


def _check_flash_fwd(q, k, v, kw, key):
    """One K11 launch on the given (kernel, W) key against its plain version."""
    dt = q.dtype
    (o, lse), added = _counted(tsa.sfc_flash_fwd, lambda: tsa.sfc_flash_fwd(q, k, v, **kw))
    torch.cuda.synchronize()
    assert added == {key: 1}
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
    _check_dense_flash(q, k, v, causal, _fwd_wgmma_key(q, k) if dtype == "bfloat16" else ("flash_fwd_kernel", 1))


def _check_dense_flash(q, k, v, causal, key):
    """One K15 launch on the given (kernel, W) key against its plain version."""
    got, added = _counted(tfa.flash_attention,
                          lambda: tfa.flash_attention(q, k, v, causal=causal, q_chunk=512, k_chunk=1024))
    torch.cuda.synchronize()
    assert added == {key: 1}
    qc, kc = tsa.kernel_chunks()
    assert _agree(got, tfa.flash_attention_plain(q, k, v, causal=causal, q_chunk=qc, k_chunk=kc), q.dtype)


# (b, s, t, h, hkv, d, keywords, strided) of the wgmma forward: GQA 4:1 at
# the training shape, 8:1, 16:1 and one group (olmoe's 16 / 16 heads); the
# model's strided views of one fused projection; D 64 with ragged rows and
# q_offset; masks shorter than the shapes (rows at or past seq_q keep the
# plain version's masked arithmetic); non-causal cross attention
FWD_WGMMA_CASES = {
    "gqa_4_to_1_train": ((2, 256, 256, 32, 8, 128), dict(causal=True), False),
    "gqa_8_to_1": ((2, 256, 256, 32, 4, 128), dict(causal=True), False),
    "gqa_16_to_1": ((1, 300, 300, 16, 1, 128), dict(causal=True), False),
    "groups_1_olmoe": ((2, 256, 256, 16, 16, 128), dict(causal=True), False),
    "strided_fused_qkv_ragged": ((2, 190, 190, 8, 2, 128), dict(causal=True), True),
    "d64_ragged_q_offset": ((1, 77, 150, 6, 2, 64), dict(causal=True, q_offset=50), False),
    "masks_shorter_than_shapes": ((1, 100, 100, 4, 2, 128), dict(causal=True, seq_q=90, seq_k=77), False),
    "non_causal_cross_d64": ((2, 50, 200, 4, 1, 64), dict(causal=False), False),
    # seamless-m4t-medium's cross-attention: 4 x 128 decoder rows over a
    # 256-row memory, 16 / 16 heads of 64 (one q head a kv head)
    "seamless_cross_g1_d64": ((4, 128, 256, 16, 16, 64), dict(causal=False), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FWD_WGMMA_CASES))
def test_fwd_wgmma_kernel_matches_plain_version_on_card(case):
    _card()
    (b, s, t, h, hkv, d), kw, strided = FWD_WGMMA_CASES[case]
    if strided:
        q, k, v = _strided_qkv(b, s, h, hkv, d, torch.bfloat16, seed=35)
        assert not q.is_contiguous() and q.stride()[1] == (h + 2 * hkv) * d
    else:
        q, k, v = _attn_inputs(b, s, t, h, hkv, d, torch.bfloat16, seed=35)
    _check_flash_fwd(q, k, v, kw, _fwd_wgmma_key(q, k))


@pytest.mark.cuda
def test_fwd_wgmma_kernel_at_every_w_matches_plain_version_on_card():
    """Each W (q heads a CTA), forced, at a ragged GQA shape with q_offset:
    bitwise one result, o within the bf16 bound of the plain version that
    rounds P to bf16 for P v as both CUDA kernels do (the forward's
    contract), lse within the f32 bound of the plain version's.  At these
    inputs that rounding alone puts one element (q row 17, head 3) at 1.15x
    the bf16 bound of the f32-P result."""
    _card()
    q, k, v = _attn_inputs(1, 190, 250, 8, 2, 128, torch.bfloat16, seed=36)
    kw = dict(causal=True, seq_q=190, seq_k=250, q_offset=60)
    tab_k, rows = tsa._device_band(3, 4, True, 60, q.device)
    outs = {}
    for warpgroups in (1, 2):
        o, lse, key = tsa.launch_flash_fwd(q, k, v, tab_k, rows, want_lse=True, warpgroups=warpgroups, **kw)
        assert key == ("flash_fwd_wgmma_kernel", warpgroups)
        outs[warpgroups] = (o, lse)
    torch.cuda.synchronize()
    o, lse = outs[1]
    assert torch.equal(o, outs[2][0]) and torch.equal(lse, outs[2][1])
    want_o, want_lse = tsa.sfc_flash_fwd_plain(q, k, v, q_chunk=64, k_chunk=64, p_dtype=torch.bfloat16, **kw)
    assert _agree(o, want_o, torch.bfloat16) and _agree(lse, want_lse, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
def test_dense_flash_on_the_fwd_wgmma_kernel_matches_plain_version_on_card(strided):
    """K15 (ascending k tiles, no lse) on the wgmma kernel: the training
    shape's heads, contiguous and as the strided views of a fused projection."""
    _card()
    if strided:
        q, k, v = _strided_qkv(2, 256, 32, 8, 128, torch.bfloat16, seed=37)
    else:
        q, k, v = _attn_inputs(2, 256, 256, 32, 8, 128, torch.bfloat16, seed=37)
    _check_dense_flash(q, k, v, True, _fwd_wgmma_key(q, k))


@pytest.mark.cuda
def test_fwd_wgmma_kernel_replays_in_a_cuda_graph_with_no_state_left():
    """K11 and K15 on the wgmma kernel keep nothing on the device between
    launches: a CUDA graph of both replays to the eager results bitwise, and
    the replays count no launch."""
    _card()
    q, k, v = _attn_inputs(2, 256, 256, 32, 8, 128, torch.bfloat16, seed=38)

    def step():
        return (*tsa.sfc_flash_fwd(q, k, v, causal=True), tfa.flash_attention(q, k, v, causal=True))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    counts = (dict(tsa.sfc_flash_fwd.launches_by_kernel), dict(tfa.flash_attention.launches_by_kernel))
    key = _fwd_wgmma_key(q, k)
    assert counts[0][key] >= 3 and counts[1][key] >= 3
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(out, eager))
    assert (dict(tsa.sfc_flash_fwd.launches_by_kernel), dict(tfa.flash_attention.launches_by_kernel)) == counts


@pytest.mark.cuda
def test_calls_the_fwd_wgmma_rule_refuses_land_on_the_tile_kernel_on_card():
    """A kv cache broadcast over the batch (stride 0, which a tensor map does
    not take) and an f32 call take the 64 x 64 tile kernel; a wgmma launch
    that the kernel refuses (3 warpgroups a CTA) raises, with no fallback
    and no count."""
    _card()
    q, k, v = _attn_inputs(2, 100, 100, 8, 2, 128, torch.bfloat16, seed=39)
    kb, vb = k[:1].expand(2, -1, -1, -1), v[:1].expand(2, -1, -1, -1)
    assert kb.stride(0) == 0
    _check_flash_fwd(q, kb, vb, dict(causal=True), ("flash_fwd_kernel", 1))
    tab_k, rows = tsa._device_band(2, 2, True, 0, q.device)
    counts = (tsa.sfc_flash_fwd.launches, dict(tsa.sfc_flash_fwd.launches_by_kernel))
    with pytest.raises(RuntimeError, match="CUDA error"):
        tsa.launch_flash_fwd(q, k, v, tab_k, rows, causal=True, seq_q=100, seq_k=100, q_offset=0, want_lse=True,
                             warpgroups=3)
    assert (tsa.sfc_flash_fwd.launches, dict(tsa.sfc_flash_fwd.launches_by_kernel)) == counts
    _check_flash_fwd(q.float(), k.float(), v.float(), dict(causal=True), ("flash_fwd_kernel", 1))
    _check_dense_flash(q.float(), k.float(), v.float(), True, ("flash_fwd_kernel", 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case", ["serve_shape", "strided_cache_with_empty_row", "cache_4096_ragged", "empty_full_and_past_t_g1",
             "memory_valid_to_its_end"])
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
    elif case == "empty_full_and_past_t_g1":  # olmoe's heads (G = 1); a live length past T is clamped
        b, t, h, hkv, d, valids = 3, 200, 16, 16, 128, (0, 200, 377)
        k, v = r(b, t, hkv, d), r(b, t, hkv, d)
    else:  # seamless's decode over the encoder memory: every row valid, 16 / 16 heads of 64
        b, t, h, hkv, d, valids = 4, 256, 16, 16, 64, (256,) * 4
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
    # the cluster and wgmma routes check the tile knobs as the tile kernel does
    for x in (a.bfloat16(), torch.ones(2, 40, 8, device="cuda").bfloat16()):
        with pytest.raises(ValueError, match="compiled for"):
            tk.sfc_gemm_replicated(x, b.bfloat16(), bm=32, bn=32)
    with pytest.raises(ValueError, match="contiguous"):
        tk.sfc_gemm_replicated(a, torch.ones(8, 8, device="cuda").T)
    with pytest.raises(ValueError, match="contiguous"):
        tk.add_reduce(torch.ones(2, 8, 4, device="cuda").transpose(1, 2))
    with pytest.raises(TypeError):
        tk.add_reduce(torch.ones(2, 4, 8, device="cuda").half())


def _layer_order_sum(copies):
    """K6's sum as the kernel orders it: f32 over the copies in layer order
    from +0, cast once to the copies' type."""
    acc = torch.zeros(copies.select(-3, 0).shape, dtype=torch.float32, device=copies.device)
    for layer in range(copies.shape[-3]):
        acc = acc + copies.select(-3, layer).float()
    return acc.to(copies.dtype)


def _k6_copies(shape, dtype, seed, offset_bytes=0):
    """Seeded copies of ``shape`` on the card, their base ``offset_bytes``
    past an allocation's (16-byte aligned) start."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
    if not offset_bytes:
        return x
    skip = offset_bytes // x.element_size()
    buf = torch.empty(x.numel() + skip, dtype=dtype, device="cuda")
    view = buf[skip:].view(shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["3d", "4d"])
@pytest.mark.parametrize("path", ["vectors", "odd_n", "offset_4_bytes"])
@pytest.mark.parametrize("layers", [1, 2, 3, 8, 9, 16])
def test_add_reduce_kernel_is_the_layer_order_sum_on_card(layers, path, form, dtype):
    """K6 bitwise equal to the f32 layer-order loop cast once (the chunks
    of 8 copies keep that order: 9 and 16 cross a chunk), on the 16-byte
    vector path and on the element path (an odd N; a copies view 4 bytes
    past an aligned base), within the plain version's bound, one launch
    counted at `add_reduce_launch`'s configuration."""
    _card()
    dt = getattr(torch, dtype)
    m, n = (5, 133) if path == "odd_n" else (6, 1000)
    shape = ((3,) if form == "4d" else ()) + (layers, m, n)
    copies = _k6_copies(shape, dt, seed=layers, offset_bytes=4 if path == "offset_4_bytes" else 0)
    assert (copies.data_ptr() % 16 == 0) == (path != "offset_4_bytes")
    cfg = tk.add_reduce_launch(3 if form == "4d" else 0, m * n, layers, copies.element_size(),
                               torch.cuda.get_device_properties(0).multi_processor_count)
    before, by_kernel = tk.add_reduce.launches, collections.Counter(tk.add_reduce.launches_by_kernel)
    got = tk.add_reduce(copies)
    torch.cuda.synchronize()
    assert tk.add_reduce.launches == before + 1
    assert collections.Counter(tk.add_reduce.launches_by_kernel) - by_kernel == {("add_reduce_kernel", cfg): 1}
    assert got.dtype == dt and got.shape == copies.select(-3, 0).shape
    assert torch.equal(got, _layer_order_sum(copies))
    assert _agree(got, tk.add_reduce_plain(copies), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vec", [True, False])
def test_add_reduce_kernel_every_configuration_on_card(vec, dtype):
    """K6 at every V and width the entry takes (16-byte vectors, or the
    element path where the copies are not whole vectors), with one CTA, a
    few (the grid striding over the slots) and enough for one pass: each
    launch the layer-order sum, bitwise; a configuration the entry refuses
    raises."""
    _card()
    dt = getattr(torch, dtype)
    shape = (2, 9, 7, 1000 if vec else 997)
    copies = _k6_copies(shape, dt, seed=5)
    want = _layer_order_sum(copies)
    slots = math.ceil(shape[-1] * shape[-2] * copies.element_size() / 16)
    for threads in (64, 128, 256):
        for v in (1, 2, 4):
            for ctas in (1, 3, math.ceil(slots / (threads * v))):
                out = torch.full_like(want, float("nan"))
                tk.launch_add_reduce(copies, out, tk.AddReduceLaunch(threads, v, ctas))
                torch.cuda.synchronize()
                assert torch.equal(out, want), (threads, v, ctas)
    out = torch.empty_like(want)
    for bad in ((96 + 1, 1, 1), (512, 1, 1), (128, 3, 1), (128, 1, 0)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            tk.launch_add_reduce(copies, out, tk.AddReduceLaunch(*bad))


# K4 / K5 on their routes: (lead, M, K, N, per-batch B, knobs) -> the
# kernel a bf16 call launches.  M 1 / 4 / 16 take the cluster kernel (K 203
# and 2056: ragged slabs, element loads; N 133 ragged), M 17 / 130 and the
# batched calls the wgmma kernel (N 328: boxes past the edge; kbf 4 keeps a
# whole slab); a slab that is not a whole number of 64-row steps the tile
# kernel.
REP_ROUTE_CASES = {
    "m1_ragged": ((), 1, 2056, 133, False, dict()),
    "m4_k203_kbf4": ((), 4, 203, 133, False, dict(k_block_factor=4)),
    "m4_qwen_kv": ((), 4, 2560, 1024, False, dict()),
    "m16_ragged": ((), 16, 1000, 328, False, dict()),
    "m17": ((), 17, 512, 328, False, dict()),
    "m130": ((), 130, 512, 328, False, dict()),
    "batched_ragged_n": ((3,), 77, 512, 328, False, dict()),
    "per_batch_weights": ((3,), 77, 512, 328, True, dict()),
    "batched_kbf4": ((2,), 40, 1024, 136, False, dict(k_block_factor=4)),
    "batched_slab_not_whole": ((2,), 40, 264, 136, False, dict()),
}


def _rep_route(a, b, k_layers, kbf=1):
    """(kernel, config) the wrapper launches for these operands, and the
    plain version's split that follows it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if tk.uses_cluster_kernel(a):
        split = tk.replicated_cluster_split(a.shape[1], b.shape[-1], k_layers, sms, kbf)
        return ("sfc_gemm_replicated_cluster_kernel", split), split
    if tk.uses_replicated_wgmma_kernel(a, b, k_layers, kbf):
        cfg = tk.replicated_wgmma_launch(a.shape[0] if a.ndim == 3 else 0, a.shape[-2], b.shape[-1], k_layers, sms)
        return ("sfc_gemm_replicated_wgmma_kernel", tk._tile_name(cfg, False)), 1
    return ("sfc_gemm_replicated_kernel", 1), 1


@pytest.mark.cuda
@pytest.mark.parametrize("copies", ["bf16", "f32"])
@pytest.mark.parametrize("k_layers", [1, 2, 8])
@pytest.mark.parametrize("case", sorted(REP_ROUTE_CASES))
def test_replicated_routes_match_plain_versions_on_card(case, k_layers, copies):
    """Each bf16 route of K4 / K5 (the cluster kernel at M <= 16, the wgmma
    kernel past 16 rows and batched, the tile kernel for a ragged slab)
    against the plain version over the same split, in bf16 and f32
    copies; one launch a call, counted under its kernel and configuration."""
    _card()
    lead, m, k, n, per_batch, knobs = REP_ROUTE_CASES[case]
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.standard_normal((*lead, m, k)).astype(np.float32)).to("cuda", torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal(((lead[0],) if per_batch else ()) + (k, n)) * 0.05)
                         .astype(np.float32)).to("cuda", torch.bfloat16)
    kw = dict(knobs, k_layers=k_layers, out_dtype=torch.float32 if copies == "f32" else None)
    want_kernel, split = _rep_route(a, w, k_layers, knobs.get("k_block_factor", 1))
    assert (want_kernel[0] == "sfc_gemm_replicated_cluster_kernel") == (m <= build.SPLIT_MAX_ROWS and not lead)
    if case == "batched_slab_not_whole":
        assert want_kernel[0] == "sfc_gemm_replicated_kernel" or k_layers == 1
    before = (tk.sfc_gemm_replicated.launches, tk.sfc_gemm_replicated.launches_by_kernel[want_kernel])
    got = tk.sfc_gemm_replicated(a, w, **kw)
    torch.cuda.synchronize()
    assert (tk.sfc_gemm_replicated.launches, tk.sfc_gemm_replicated.launches_by_kernel[want_kernel]) == (
        before[0] + 1, before[1] + 1)
    want = tk.sfc_gemm_replicated_plain(a, w, bm=64, bn=64, split=split, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _agree(got, want, got.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k_layers", [2, 4])
@pytest.mark.parametrize("lead,m,k,n", [((), 4, 2560, 1024), ((), 1, 2056, 133), ((), 130, 512, 328),
                                        ((4,), 128, 1024, 1024)])
def test_the_next_slab_never_reaches_a_copy_on_card(lead, m, k, n, k_layers):
    """With the K rows of layer 1's slab all NaN in A and B, every other
    copy is finite and the plain version's, and copy 1 is NaN: no stage
    of the cluster or the wgmma kernel reads past its slab."""
    _card()
    rng = np.random.default_rng(32)
    a = torch.from_numpy(rng.standard_normal((*lead, m, k)).astype(np.float32)).to("cuda", torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(np.float32)).to("cuda", torch.bfloat16)
    slab = tk.layer_slab(k, k_layers)
    a[..., slab:2 * slab] = float("nan")
    w[slab:2 * slab] = float("nan")
    (kernel, _), split = _rep_route(a, w, k_layers)
    assert kernel != "sfc_gemm_replicated_kernel"
    got = tk.sfc_gemm_replicated(a, w, k_layers=k_layers)
    torch.cuda.synchronize()
    want = tk.sfc_gemm_replicated_plain(a, w, bm=64, bn=64, k_layers=k_layers, split=split)
    others = [layer for layer in range(k_layers) if layer != 1]
    assert _agree(got[..., others, :, :], want[..., others, :, :], torch.bfloat16)
    assert bool(torch.isnan(got[..., 1, :, :].float()).all())


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


# the forward's rule: (dtype, head dim, strides of q / k / v, bases) -> the
# wgmma kernel?  Strides as `_tma_strides` gives them.
FWD_RULE_TABLE = {
    "prefill_bf16_d128": (torch.bfloat16, 128, (_QS, _KS, _KS), (0, 4096, 8192), True),
    "fused_projection_views": (torch.bfloat16, 128, (_FUSED, _FUSED, _FUSED), (0, 8192, 10240), True),
    "d64": (torch.bfloat16, 64, ((64, 64, 64, 1),) * 3, (0, 16, 32), True),
    "f32": (torch.float32, 128, (_QS, _KS, _KS), (0, 4096, 8192), False),
    "d96": (torch.bfloat16, 96, ((96, 96, 96, 1),) * 3, (0, 16, 32), False),
    "base_8_bytes": (torch.bfloat16, 128, (_QS, _KS, _KS), (0, 4104, 8192), False),
    "row_stride_not_16_bytes": (torch.bfloat16, 128, (_QS, (132 * 8, 132, 128, 1), _KS), (0, 16, 32), False),
    "zero_batch_stride": (torch.bfloat16, 128, (_QS, (0, 1024, 128, 1), _KS), (0, 16, 32), False),
}


@pytest.mark.parametrize("case", list(FWD_RULE_TABLE))
def test_fwd_wgmma_launch_rule_table(case):
    dtype, d, strides, bases, want = FWD_RULE_TABLE[case]
    assert tsa.uses_fwd_wgmma_kernel(dtype, d, strides, bases) is want
    # the backward's rule over the same operands and dO laid out as q
    assert tsa.uses_bwd_wgmma_kernel(dtype, d, (*strides, strides[0]), (*bases, bases[0])) is want


def _route_operands(case):
    """q, k, v on the CPU (2 x 64 tokens, 8 / 2 heads) as `FWD_ROUTE_CASES`
    names them."""
    d = 96 if case == "d96" else 128
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    if case == "fused_projection_views":
        fused = torch.zeros((2, 64, 12 * d), dtype=dtype)
        return fused[..., :8 * d].view(2, 64, 8, d), fused[..., 8 * d:10 * d].view(2, 64, 2, d), \
            fused[..., 10 * d:].view(2, 64, 2, d)
    q = torch.zeros(2 * 64 * 8 * d + 4, dtype=dtype)
    q = (q[4:] if case == "misaligned_base" else q[:-4]).view(2, 64, 8, d)
    return q, torch.zeros((2, 64, 2, d), dtype=dtype), torch.zeros((2, 64, 2, d), dtype=dtype)


FWD_ROUTE_CASES = {"contiguous": True, "fused_projection_views": True, "misaligned_base": False, "f32": False,
                   "d96": False}


@pytest.mark.parametrize("case", list(FWD_ROUTE_CASES))
def test_fwd_route_of_real_operands(case):
    """The route a forward call's own tensors take: the model's contiguous
    and fused-projection-strided bf16 views to the wgmma kernel; a base 8
    bytes off 16, f32 and a head dim of 96 not."""
    q, k, v = _route_operands(case)
    assert (q.data_ptr() % 16 == 8) is (case == "misaligned_base")
    wgmma, strides = tsa._fwd_route(q, k, v)
    assert wgmma is FWD_ROUTE_CASES[case]
    assert strides == [tsa._tma_strides(x) for x in (q, k, v)]


def test_fwd_wgmma_grids_are_functions_of_the_shapes():
    # qwen3-4b's prefill (4 x 128 tokens) and training step (2 x 256), 32 /
    # 8 heads: W 2, 2 x (4 * 8 * 2) and 4 x (2 * 8 * 2) = 128 CTAs, one
    # wave of 132 SMs (W 1 would take 256)
    assert tsa.fwd_wgmma_grid(4, 128, 128, 32, 8) == ((64, 2), 2)
    assert tsa.fwd_wgmma_grid(2, 256, 256, 32, 8) == ((32, 4), 2)
    # olmoe's 16 / 16 heads: a group of one, W 1
    assert tsa.fwd_wgmma_grid(4, 128, 128, 16, 16) == ((64, 2), 1)
    # a small launch fits one wave at W 1 and spreads over the SMs
    assert tsa.fwd_wgmma_grid(1, 128, 128, 32, 8) == ((32, 2), 1)
    # past one wave at every W: the largest; the keys take no part
    assert tsa.fwd_wgmma_grid(1, 2000, 2000, 32, 8) == ((16, 32), 2)
    assert tsa.fwd_wgmma_grid(1, 2000, 2048, 32, 8) == ((16, 32), 2)
    # a group of 3: 2 does not divide it
    assert tsa.fwd_wgmma_grid(2, 256, 256, 24, 8) == ((48, 4), 1)
    # a card of 264 SMs takes the training step in one wave at W 1
    assert tsa.fwd_wgmma_grid(2, 256, 256, 32, 8, sm_count=264) == ((64, 4), 1)
    for b, s, h, hkv in ((1, 64, 64, 4), (3, 777, 32, 2), (2, 4096, 48, 8), (1, 1, 16, 1)):
        (gx, gy), w = tsa.fwd_wgmma_grid(b, s, s, h, hkv)
        assert (h // hkv) % w == 0 and 1 <= w <= build.MAX_FWD_WARPGROUPS
        assert (gx, gy) == (b * hkv * (h // hkv) // w, math.ceil(s / 64))


def test_fwd_wgmma_entries_and_constants_match_the_compiled_source():
    src = ATTN_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert build.MAX_FWD_WARPGROUPS == const("kMaxWarpgroups")
    assert build.FWD_WGMMA_STAGES == const("kFwdStages")
    dims = tuple(int(d) for d in re.findall(r"^SFC_FWD_WGMMA_ENTRY\((\d+)\)", src, re.MULTILINE))
    assert dims == build.ATTN_HEAD_DIMS
    assert build.attn_entry_name("fwd_wgmma", "bf16", 128) == "sfc_attn_fwd_wgmma_bf16_d128"
    with pytest.raises(ValueError):
        build.attn_entry_name("fwd_wgmma", "f32", 128)
    # the helpers the forward shares with K12 / K13 compile in both bf16
    # parts, ahead of the backward's own section
    shared = src.index("#if SFC_ATTN_DTYPE == 1\n")
    backward = src.index("#if SFC_ATTN_PART == 1 && SFC_ATTN_DTYPE == 1")
    forward = src.index("#if SFC_ATTN_PART == 0 && SFC_ATTN_DTYPE == 1")
    assert shared < backward < forward
    for fn in ("align1024", "desc_kmajor", "desc_nmajor", "acc_row", "acc_col", "pack_bf16", "seq_map"):
        at = re.search(rf"\b{fn}\(", src[shared:]).start() + shared
        assert shared < at < backward, fn
    assert "flash_fwd_wgmma_kernel" in src[forward:]


def test_cpu_forward_wrappers_count_nothing_by_kernel():
    """On CPU tensors K11 and K15 run their plain versions: no launch and no
    kernel key counted."""
    rng = np.random.default_rng(40)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).bfloat16()
               for sh in ((1, 70, 4, 64), (1, 70, 2, 64), (1, 70, 2, 64)))
    before = [(f.launches, dict(f.launches_by_kernel)) for f in (tsa.sfc_flash_fwd, tfa.flash_attention)]
    o, lse = tsa.sfc_flash_fwd(q, k, v, causal=True)
    o2 = tfa.flash_attention(q, k, v)
    assert o.shape == o2.shape == q.shape and lse.shape == q.shape[:3]
    assert [(f.launches, dict(f.launches_by_kernel)) for f in (tsa.sfc_flash_fwd, tfa.flash_attention)] == before


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
            loss = model.loss(batch, remat="none")  # one forward: K3's launches are counted
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


def test_f32_output_entries_match_the_compiled_sources():
    """K1/K2's f32-output mode lives in the bf16 part of (no GLU, no
    activation) and its lane twin only, behind entries of its own; the
    source defines both entries and their kernels under names of their
    own, and every other part's flags are as they were."""
    gemm = CU_SOURCE.read_text()
    for entry in ("SFC_F32_ENTRY", "SFC_WGMMA_F32_ENTRY"):
        assert gemm.count(f'extern "C" int {entry}(') == 2  # the part's and its lane twin's
    for kernel in ("sfc_gemm_fused_f32out_kernel", "sfc_gemm_fused_f32out_abft_kernel",
                   "sfc_gemm_wgmma_f32out_kernel", "sfc_gemm_wgmma_f32out_abft_kernel"):
        assert re.search(rf"\b{kernel}\(", gemm), kernel
    assert "struct OutF32" in WGMMA_SOURCE.read_text()
    parts = dict(build._gemm_parts())
    holders = {name for name, flags in parts.items() if any(f.startswith("-DSFC_F32_ENTRY") for f in flags)}
    assert holders == {build.entry_name("bf16", False, None, abft) for abft in (False, True)}
    for abft in (False, True):
        flags = parts[build.entry_name("bf16", False, None, abft)]
        assert f"-DSFC_F32_ENTRY={build.f32out_entry_name('tile', abft)}" in flags
        assert f"-DSFC_WGMMA_F32_ENTRY={build.f32out_entry_name('wgmma', abft)}" in flags
    assert build.f32out_entry_name("wgmma", True) == "sfc_gemm_wgmma_f32out_abft_bf16"
    assert build.f32out_entry_name("tile") == "sfc_gemm_fused_f32out_bf16"
    with pytest.raises(ValueError):
        build.f32out_entry_name("cluster")


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


# K2's f32-output mode (bf16 in, the f32 accumulator out): (lead batch
# dims, M, K, N, per-batch B, A a view 2 bytes past a 16-byte boundary, the
# kernel it takes).  The chunk-einsum shapes: the SSD scores at a 4 x 128
# prefill and at a 1 x 600 prompt's three 256-row chunks, xlstm-1.3b's
# mLSTM qk block at 4 x 128; shared B; a plain-mode A of 4 rows (the
# tile kernel: the cluster kernel writes bf16 only); the ragged case (K 50,
# N 70, an unaligned view) on the tile kernel
F32_OUT_CASES = {
    "ssd_scores_4x128": ((4,), 128, 64, 128, True, False, "sfc_gemm_wgmma_f32out_kernel"),
    "ssd_scores_1x600": ((3,), 256, 64, 256, True, False, "sfc_gemm_wgmma_f32out_kernel"),
    "mlstm_qk_4x128": ((16,), 128, 1024, 128, True, False, "sfc_gemm_wgmma_f32out_kernel"),
    "shared_b_ragged_rows": ((2,), 77, 264, 328, False, False, "sfc_gemm_wgmma_f32out_kernel"),
    "plain_m4": ((), 4, 2048, 256, False, False, "sfc_gemm_fused_f32out_kernel"),
    "ragged_unaligned_view": ((3,), 60, 50, 70, True, True, "sfc_gemm_fused_f32out_kernel"),
}


def _f32_out_operands(case, seed=33):
    lead, m, k, n, per_batch, shifted, _ = F32_OUT_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    count = math.prod(lead) * m * k
    flat = torch.randn(count + 8, generator=gen, device="cuda").bfloat16()
    a = (flat[1:1 + count] if shifted else flat[:count]).view(*lead, m, k)
    b = (torch.randn((*lead, k, n) if per_batch else (k, n), generator=gen, device="cuda") * 0.1).bfloat16()
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(F32_OUT_CASES))
def test_f32_output_mode_matches_plain_version_on_card(case):
    """K2's f32-output mode (``out_dtype=torch.float32`` on bf16 inputs):
    the route `_launch_f32_out` takes (the wgmma kernel where TMA can
    describe the rows, else the tile kernel), the f32 output within the f32
    tolerance of the plain version (both the f32 accumulation of the same
    bf16 products, in other orders), no bf16 rounding; its lane twin's
    output bitwise the kernel's and its lane within chip_smoke.py's
    `lane_limit` over the kernel's own tiles; the counter of the mode."""
    _card()
    from repro_torch.robust import abft

    cs = _chip_smoke()
    lead, m, k, n, per_batch, shifted, kernel = F32_OUT_CASES[case]
    a, b = _f32_out_operands(case)
    assert tk.uses_wgmma_kernel(a, b) == (kernel == "sfc_gemm_wgmma_f32out_kernel")
    before = tk.sfc_gemm_fused.f32_out_launches
    got, key = cs.launched(tk.sfc_gemm_fused.launches_by_kernel,
                           lambda: tk.sfc_gemm_fused(a, b, out_dtype=torch.float32))
    torch.cuda.synchronize()
    assert key[0] == kernel and tk.sfc_gemm_fused.f32_out_launches == before + 1
    want = tk.sfc_gemm_fused_plain(a, b, bm=64, bn=64, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _agree(got, want, torch.float32)
    exact = torch.matmul(a.float(), b.float())
    assert _agree(got, exact, torch.float32) and not torch.equal(got, exact.bfloat16().float())
    on = tk.sfc_gemm_fused(a, b, out_dtype=torch.float32, abft=True)
    assert torch.equal(on[0], got)
    plain = tk.sfc_gemm_fused_plain(a, b, bm=64, bn=64, out_dtype=torch.float32, abft=True)
    if kernel == "sfc_gemm_wgmma_f32out_kernel":
        tile = tuple(int(x) for x in key[1].split("x"))
        tiles = (cs.raw_tile_sums(torch, exact, tile=tile) if per_batch
                 else cs.raw_tile_sums(torch, exact.reshape(-1, n), tile=tile))
    else:
        tiles = cs.raw_tile_sums(torch, exact)
    limit = cs.lane_limit(tiles, abft.tolerance(abft.gemm_checksum_ref(a, b)[1], k))
    assert abs(float(on[1]) - float(plain[1])) <= limit
    for name, wrong in cs._dropped(plain[1], tiles).items():
        assert abs(wrong - float(plain[1])) > limit, name


@pytest.mark.cuda
def test_f32_output_mode_refuses_an_epilogue_on_card():
    """The f32-output mode is the plain product's: a GLU, preact or any
    epilogue flag with it raises, naming what was asked, before any launch;
    f32 out from f32 inputs is the f32 kernels' own type."""
    _card()
    a, b = _f32_out_operands("ssd_scores_4x128")
    n = b.shape[-1]
    w = b[0]
    launches = tk.sfc_gemm_fused.launches
    for kw, name in ((dict(b_gate=w), "GLU"), (dict(b_gate=w, preact=True), "GLU"),
                     (dict(bias=torch.zeros(n, device="cuda").bfloat16()), "bias"),
                     (dict(activation="silu"), "activation"), (dict(out_scale=0.5), "out_scale"),
                     (dict(residual=torch.zeros(4, 128, n, device="cuda").bfloat16()), "residual")):
        bb = w if "b_gate" in kw else b
        with pytest.raises((TypeError, ValueError), match=name):
            tk.sfc_gemm_fused(a, bb, out_dtype=torch.float32, **kw)
    assert tk.sfc_gemm_fused.launches == launches
    with pytest.raises(TypeError, match="writes its input type"):
        tk.sfc_gemm_fused(a, b, out_dtype=torch.float16)
    out = tk.sfc_gemm_fused(a.float(), b.float(), out_dtype=torch.float32)
    assert out.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["blockwise", "sfc"])
def test_zamba2_cut_prefill_logits_under_sfc_cuda_match_torch_on_card(attn_impl):
    """zamba2-1.2b at full width cut to 2 Mamba2 layers and one application
    of the shared block (attn_every 2), a 4 x 128 prompt, bf16: the
    prefill under sfc_cuda launches what the structure asks for (2 chunk
    products a layer on K2, the scores in its f32-output mode; 6 K1/K2 the
    shared block; K11 under "sfc"), and its logits, SSM states and KV
    caches are as close to the same weights run in f32 under torch as the
    torch backend's bf16 ones are (chip_smoke.py's ACCURACY_PARITY, the
    mean |error|): the two bf16 runs round at other places (torch rounds
    the GLU's g, h, silu(g) and their product apart, the kernel once), so
    they sit more than one rounding apart.  The same weights in f32 under
    sfc_cuda: every one of them within the bf16 bound of torch's, where
    only the order of the sums differs."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.core.gemm_backend import gemm_backend
    from repro_torch.models.registry import build_model

    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("zamba2_1_2b"), n_layers=2, attn_every=2, attn_impl=attn_impl)
    model = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(6))
    model32 = build_model(dataclasses.replace(cfg, param_dtype="float32"), device="cuda")
    model32.load_state_dict(model.state_dict())
    tokens = torch.randint(0, cfg.vocab, (4, 128), generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda")

    def leaves(out):
        logits, cache = out
        return [logits] + [cache[part][key] for part, key in (("mamba", "ssm"), ("mamba", "conv"), ("kv", "k"),
                                                                ("kv", "v"))]

    outs = {}
    for name, m in (("sfc_cuda", model), ("torch", model), ("sfc_cuda_f32", model32), ("torch_f32", model32)):
        before = (tk.sfc_gemm_fused.launches, tk.sfc_gemm_fused.f32_out_launches, tsa.sfc_flash_fwd.launches)
        with gemm_backend(name.split("_f32")[0]):
            outs[name] = leaves(m.prefill(tokens, cache_len=129))
        torch.cuda.synchronize()
        after = (tk.sfc_gemm_fused.launches, tk.sfc_gemm_fused.f32_out_launches, tsa.sfc_flash_fwd.launches)
        # 2 chunk products a layer (the bf16 scores in the f32-output mode), 6 K1/K2 the shared block
        k11 = int(attn_impl == "sfc")
        want = {"sfc_cuda": (2 * 2 + 6, 2, k11), "sfc_cuda_f32": (2 * 2 + 6, 0, k11)}.get(name, (0, 0, k11))
        assert tuple(x - y for x, y in zip(after, before)) == want, name
    assert outs["sfc_cuda"][0].dtype == torch.bfloat16 and outs["sfc_cuda"][0].shape == (4, cfg.vocab)
    for i, (got, ref, ref16) in enumerate(zip(outs["sfc_cuda"], outs["torch_f32"], outs["torch"])):
        noise, ref_noise = ((x.float() - ref.float()).abs().mean() for x in (got, ref16))
        assert bool(torch.isfinite(got.float()).all()) and noise <= cs.ACCURACY_PARITY * ref_noise, i
    for i, (got, ref) in enumerate(zip(outs["sfc_cuda_f32"], outs["torch_f32"])):
        assert _agree(got, ref, torch.bfloat16), i


@pytest.mark.cuda
def test_mlstm_output_product_in_f32_matches_plain_version_on_card():
    """xlstm-1.3b's mLSTM output product at one 512-step chunk of a 1 x 600
    prompt, ``chunk_einsum("bljh,bjhp->blhp", att, v)`` with f32 operands
    under "sfc_cuda": per-batch B (4 heads, M 512, K 512, N 1024) on the
    64 x 64 tile kernel in f32, within the f32 tolerance of its plain
    version and of the f32 einsum (no TF32)."""
    _card()
    from repro_torch.core.gemm_backend import chunk_einsum, gemm_backend

    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(37)
    att = torch.randn((1, 512, 512, 4), generator=gen, device="cuda")
    v = torch.randn((1, 512, 4, 1024), generator=gen, device="cuda")
    with gemm_backend("sfc_cuda"):
        got, key = cs.launched(tk.sfc_gemm_fused.launches_by_kernel,
                               lambda: chunk_einsum("bljh,bjhp->blhp", att, v))
    torch.cuda.synchronize()
    assert key == ("sfc_gemm_fused_kernel", 1) and got.dtype == torch.float32 and got.shape == (1, 512, 4, 1024)
    at, bt = att[0].permute(2, 0, 1), v[0].permute(1, 0, 2)  # (4, 512, 512), (4, 512, 1024)
    want = tk.sfc_gemm_fused_plain(at, bt, bm=64, bn=64)
    assert _agree(got[0].permute(1, 0, 2), want, torch.float32)
    assert _agree(got, torch.einsum("bljh,bjhp->blhp", att, v), torch.float32)


# seamless-m4t-medium's MLP input (d_model 1024 -> d_ff 4096, gelu in the
# flush): (rows, the kernel it takes) at a decode step (4 rows) and the
# 4 x 128 prefill
GELU_CASES = {"decode_m4": ((4,), "sfc_gemm_cluster_kernel"), "prefill_4x128": ((4, 128), "sfc_gemm_wgmma_kernel")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GELU_CASES))
def test_gelu_product_matches_plain_version_on_card(case):
    """The non-gated gelu product (``activation="gelu"``, the tanh form) at
    seamless-m4t-medium's widths on the kernel its rows take, within the
    bf16 bound of the plain version summed as the launch sums."""
    _card()
    cs = _chip_smoke()
    rows, kernel = GELU_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(38)
    a = torch.randn((*rows, 1024), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((1024, 4096), generator=gen, device="cuda") * 0.03).bfloat16()
    got, (name, config) = cs.launched(tk.sfc_gemm_fused.launches_by_kernel,
                                      lambda: tk.sfc_gemm_fused(a, w, activation="gelu"))
    torch.cuda.synchronize()
    assert name == kernel and got.dtype == torch.bfloat16
    want = tk.sfc_gemm_fused_plain(a, w, bm=64, bn=64, activation="gelu", k_layers=cs.plain_layers(name, config))
    assert _agree(got, want, torch.bfloat16)


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


def test_grouped_wgmma_modes_are_arguments_of_the_wgmma_entries():
    """K3 and K9 on the wgmma kernels are the grouped modes of the forward
    and NT wgmma entries (the per-expert row array after the launch
    configuration), under kernel names of their own: no part is added."""
    gemm = CU_SOURCE.read_text()
    for entry in ("SFC_WGMMA_ENTRY", "SFC_NT_WGMMA_ENTRY"):
        for decl in re.findall(rf'extern "C" int {entry}\(([^)]*)\)', gemm):
            assert "int ctas, int group," in " ".join(decl.split()) and "const int* grp, int n_groups," in " ".join(
                decl.split()), entry
    for kernel in ("sfc_gemm_grouped_wgmma_kernel(", "sfc_gemm_grouped_wgmma_abft_kernel(",
                   "grouped_nt_wgmma_kernel("):
        assert kernel in gemm
    assert gemm.count("wg::NoFlush, true>(") == 3  # each body in its grouped mode


# (group sizes, K, N): ragged experts, one empty and one over a 128-row
# tile, boxes past every edge (K 264, N 328 not multiples of 64); 80 rows
# an expert as olmoe's prefill; a row count of 1
GROUPED_WGMMA_CASES = {
    "ragged": ((5, 0, 19, 32), 264, 328),
    "long": ((80, 0, 45, 130), 256, 192),
    "olmoe_like": ((80,) * 6, 512, 1024),
    "one_row": ((1, 130, 0, 64), 264, 136),
}


def _grouped_forms(a, w, wg, bias, gbias):
    """K3's forms: linear, the GLU with silu in the flush, the GLU preact
    with both biases, bias + relu + scale."""
    return [((a, w), {}), ((a, w, wg), dict(activation="silu")), ((a, w, wg, bias, gbias), dict(preact=True)),
            ((a, w, None, bias), dict(activation="relu", out_scale=0.5))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPED_WGMMA_CASES))
def test_grouped_wgmma_kernels_match_plain_versions_on_card(case):
    """K3 on `sfc_gemm_grouped_wgmma_kernel` in every form and K9 on
    `grouped_nt_wgmma_kernel` (single and dual) against their plain
    versions, one launch each on the tile `grouped_wgmma_launch` chooses;
    K3's lane twin: outputs bitwise the kernel's, its lane within
    chip_smoke.py's `lane_limit` of the plain lane over the kernel's own
    128-row tiles of each expert, where a lane of 0 or less its last real
    tile misses it."""
    _card()
    from repro_torch.robust import abft

    cs = _chip_smoke()
    gs, k, n = GROUPED_WGMMA_CASES[case]
    dt = torch.bfloat16
    a, w, wg, bias, gbias, dc, dc2 = _grouped_inputs(np.random.default_rng(33), gs, k, n, dt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw_gs = dict(group_sizes=gs)
    for args, kw in _grouped_forms(a, w, wg, bias, gbias):
        glu = args[2] is not None if len(args) > 2 else False
        assert tk.uses_grouped_wgmma_kernel(*args[:3])
        cfg = tk.grouped_wgmma_launch(gs, n, sms, glu)
        got, key = cs.launched(tk.sfc_gemm_grouped.launches_by_kernel,
                               lambda: tk.sfc_gemm_grouped(*args, **kw_gs, **kw))
        torch.cuda.synchronize()
        assert key == ("sfc_gemm_grouped_wgmma_kernel", f"128x{128 * (2 if cfg.wide else 1) // (2 if glu else 1)}")
        want = tk.sfc_gemm_grouped_plain(*args, bm=64, bn=64, **kw_gs, **kw)
        got_t, want_t = (got, want) if kw.get("preact") else ((got,), (want,))
        for g, w_ in zip(got_t, want_t):
            assert g.dtype == dt and g.shape == (sum(gs), n) and _agree(g, w_, dt), kw
        on = tk.sfc_gemm_grouped(*args, **kw_gs, **kw, abft=True)
        assert all(torch.equal(x, y) for x, y in zip(on[:-1], got_t))
        plain = tk.sfc_gemm_grouped_plain(*args, bm=64, bn=64, **kw_gs, **kw, abft=True)
        raws = [cs.grouped_raw(torch, a, x, gs) for x in (args[1], args[2] if glu else None) if x is not None]
        tiles = cs.kernel_tiles(torch, key[0], key[1], *raws)
        limit = cs.lane_limit(tiles, abft.tolerance(abft.grouped_checksum_ref(a, w, wg if glu else None, gs)[1], k))
        assert abs(float(on[-1]) - float(plain[-1])) <= limit, kw
        # the controls drop the last real tile (a padded expert slab ends in zeros)
        for name, wrong in cs._dropped(plain[-1], tiles[tiles != 0]).items():
            assert abs(wrong - float(plain[-1])) > limit, (name, kw)
    for dual in (False, True):
        extra = (dc2, wg) if dual else (None, None)
        assert tk.uses_grouped_nt_wgmma_kernel(dc, w, *extra)
        cfg = tk.grouped_wgmma_launch(gs, k, sms)
        da, key = cs.launched(tk.sfc_gemm_grouped_nt.launches_by_kernel,
                              lambda: tk.sfc_gemm_grouped_nt(dc, w, *extra, **kw_gs))
        torch.cuda.synchronize()
        assert key == ("grouped_nt_wgmma_kernel", f"128x{256 if cfg.wide else 128}")
        assert da.shape == (sum(gs), k) and _agree(da, tk.sfc_gemm_grouped_nt_plain(dc, w, *extra, bm=64, bn=64,
                                                                                    **kw_gs), dt)


@pytest.mark.cuda
def test_the_next_experts_rows_never_reach_an_experts_outputs_on_card():
    """A 128-row box of an expert's rows runs into the next expert's: with
    the last expert's rows all NaN, every other expert's K3 (GLU, with its
    lane) and K9 outputs are finite and the plain version's, and the last
    expert's are NaN."""
    _card()
    gs, k, n = (45, 0, 130, 80), 256, 192
    dt = torch.bfloat16
    a, w, wg, bias, gbias, dc, dc2 = _grouped_inputs(np.random.default_rng(34), gs, k, n, dt)
    last = sum(gs) - gs[-1]
    a[last:] = float("nan")
    dc[last:] = float("nan")
    dc2[last:] = float("nan")
    kw = dict(group_sizes=gs)
    out, lane = tk.sfc_gemm_grouped(a, w, wg, bias, activation="silu", abft=True, **kw)
    da = tk.sfc_gemm_grouped_nt(dc, w, dc2, wg, **kw)
    torch.cuda.synchronize()
    assert tk.uses_grouped_wgmma_kernel(a, w, wg) and tk.uses_grouped_nt_wgmma_kernel(dc, w, dc2, wg)
    want = tk.sfc_gemm_grouped_plain(a, w, wg, bias, activation="silu", bm=64, bn=64, **kw)
    want_da = tk.sfc_gemm_grouped_nt_plain(dc, w, dc2, wg, bm=64, bn=64, **kw)
    for got, ref in ((out, want), (da, want_da)):
        assert _agree(got[:last], ref[:last], dt)
        assert bool(torch.isnan(got[last:].float()).all())
    assert bool(torch.isnan(lane))  # the last expert's NaN rows are its own lane's


@pytest.mark.cuda
def test_wgmma_kernels_replay_in_a_cuda_graph_with_no_state_left():
    """The wgmma kernels keep no counter or queue on the device (each CTA's
    segment comes from its index): a captured graph of the forward (wide
    GLU, narrow tile with its lane), the dual NT and their grouped modes
    (K3's GLU with its lane over ragged experts, K9's dual), the
    replicated copies (K5 on the wgmma kernel, K4 on the cluster kernel, f32
    copies) and the f32-output mode with its lane (the SSD scores of a
    600-token prompt, per-batch B), replayed three times, gives the eager
    outputs bitwise every time, and the launch counters count the capture
    only."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(24)
    a = torch.randn((4, 128, 2560), generator=gen, device="cuda").bfloat16()
    w, wg = ((torch.randn((2560, 9728), generator=gen, device="cuda") * 0.02).bfloat16() for _ in range(2))
    wkv = (torch.randn((2560, 1024), generator=gen, device="cuda") * 0.02).bfloat16()
    dc = torch.randn((512, 9728), generator=gen, device="cuda").bfloat16()
    gs = (80, 0, 45, 130)
    xe = torch.randn((sum(gs), 512), generator=gen, device="cuda").bfloat16()
    we, wge = ((torch.randn((4, 512, 1024), generator=gen, device="cuda") * 0.05).bfloat16() for _ in range(2))
    dce = torch.randn((sum(gs), 1024), generator=gen, device="cuda").bfloat16()

    ssd_c, ssd_b = _f32_out_operands("ssd_scores_1x600")

    def step():
        return (tk.sfc_gemm_fused(a, w, wg, activation="silu"), tk.sfc_gemm_fused(a, wkv, abft=True),
                tk.sfc_gemm_nt(dc, w, dc, wg), tk.sfc_gemm_grouped(xe, we, wge, activation="silu", group_sizes=gs,
                                                                   abft=True),
                tk.sfc_gemm_grouped_nt(dce, we, dce, wge, group_sizes=gs), tk.sfc_gemm_replicated(a, wkv, k_layers=2),
                tk.sfc_gemm_replicated(a[0, :4], wkv, k_layers=2, out_dtype=torch.float32),
                tk.sfc_gemm_fused(ssd_c, ssd_b, out_dtype=torch.float32, abft=True))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    fns = (tk.sfc_gemm_fused, tk.sfc_gemm_nt, tk.sfc_gemm_grouped, tk.sfc_gemm_grouped_nt, tk.sfc_gemm_replicated)
    counts = [(f.launches, dict(f.launches_by_kernel)) for f in fns]
    assert counts[2][1].get(("sfc_gemm_grouped_wgmma_kernel", "128x64"), 0) >= 3
    assert sum(n for (name, _), n in counts[3][1].items() if name == "grouped_nt_wgmma_kernel") >= 3
    for name in ("sfc_gemm_replicated_wgmma_kernel", "sfc_gemm_replicated_cluster_kernel"):
        assert sum(n for (kernel, _), n in counts[4][1].items() if kernel == name) >= 3
    assert sum(n for (kernel, _), n in counts[0][1].items() if kernel == "sfc_gemm_wgmma_f32out_kernel") >= 3
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[2], eager[2]) and torch.equal(out[4], eager[4])
        assert torch.equal(out[5], eager[5]) and torch.equal(out[6], eager[6])
        assert all(torch.equal(x, y) for x, y in zip(out[1], eager[1]))
        assert all(torch.equal(x, y) for x, y in zip(out[3], eager[3]))
        assert all(torch.equal(x, y) for x, y in zip(out[7], eager[7]))
    assert [(f.launches, dict(f.launches_by_kernel)) for f in fns] == counts


@pytest.mark.cuda
def test_calls_the_wgmma_predicates_refuse_land_on_the_tile_kernels_on_card():
    """K 203 (rows TMA cannot describe), f32 and a base off a 16-byte
    boundary keep their old kernels, by ``launches_by_kernel``: K1/K2's and
    K7's, and in the grouped mode K3's and K9's tile kernels, where the
    aligned bf16 grouped calls take the grouped wgmma kernels and count
    nothing under K1/K2 or K7."""
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
    gs = (5, 0, 19, 32)
    g_fwd, g_nt = tk.sfc_gemm_grouped.launches_by_kernel, tk.sfc_gemm_grouped_nt.launches_by_kernel
    x, w = r(56, 264), (r(4, 264, 328) * 0.05).contiguous()
    assert cs.launched(g_fwd, lambda: tk.sfc_gemm_grouped(x, w, group_sizes=gs))[1][0] == (
        "sfc_gemm_grouped_wgmma_kernel")
    assert cs.launched(g_nt, lambda: tk.sfc_gemm_grouped_nt(r(56, 328), w, group_sizes=gs))[1][0] == (
        "grouped_nt_wgmma_kernel")
    torch.cuda.synchronize()
    assert (dict(fused), dict(nt)) == before[:2]
    assert (tk.sfc_gemm_grouped.launches, tk.sfc_gemm_grouped_nt.launches) == (before[2] + 1, before[3] + 1)
    flat = r(56 * 264 + 8)
    x_off = flat[1:1 + 56 * 264].view(56, 264)  # 2 bytes past a 16-byte boundary
    for xa, wa in ((r(56, 203), r(4, 203, 328)), (x.float(), w.float()), (x_off, w)):
        assert not tk.uses_grouped_wgmma_kernel(xa, wa)
        assert cs.launched(g_fwd, lambda: tk.sfc_gemm_grouped(xa, wa, group_sizes=gs))[1] == (
            "sfc_gemm_grouped_kernel", 1)
    for dca, wa in ((r(56, 203), r(4, 328, 203)), (r(56, 264).float(), w.float().transpose(1, 2).contiguous()),
                    (x_off, w.transpose(1, 2).contiguous())):
        assert not tk.uses_grouped_nt_wgmma_kernel(dca, wa)
        assert cs.launched(g_nt, lambda: tk.sfc_gemm_grouped_nt(dca, wa, group_sizes=gs))[1] == (
            "grouped_nt_kernel", 1)


# ---------------------------------------------------------------------------
# the TN wgmma kernels: K8 (tn_wgmma_kernel, tn_update_wgmma_kernel, their
# lane twins) and K10 (grouped_tn_wgmma_kernel, grouped_tn_update_wgmma_kernel)
# ---------------------------------------------------------------------------

# (expert row counts or None, token rows, K, N, dual): qwen3-4b's training
# dW shapes (512 token rows), ragged ones whose boxes run past every edge,
# and expert sizes that are not multiples of 64, with empty experts
TN_WGMMA_CASES = {
    "q": (None, 512, 2560, 4096, False),
    "glu_dual": (None, 512, 2560, 9728, True),
    "ragged_m200_dual": (None, 200, 264, 328, True),
    "m5": (None, 5, 64, 1000, False),
    "grouped_ragged_dual": ((5, 0, 19, 32), None, 264, 328, True),
    "grouped_80_rows": ((80,) * 6, None, 256, 192, False),
    "grouped_130_rows_dual": ((1, 130, 0, 64), None, 264, 136, True),
}


def _tn_case_inputs(case, dtype=torch.bfloat16, seed=41):
    gs, m, k, n, dual = TN_WGMMA_CASES[case]
    t = sum(gs) if gs else m
    e = len(gs) if gs else 1
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to("cuda", dt)

    stack = (e, k, n) if gs else (k, n)
    sets = []
    for _ in range(2 if dual else 1):
        mst = r(*stack, scale=0.02, dt=torch.float32)
        sets.append((mst, r(*stack, scale=0.5, dt=torch.float32), r(*stack, scale=2.0, dt=torch.float32) ** 2 + 0.1,
                     mst.to(dtype)))
    return gs, (r(t, k), r(t, n), r(t, n) if dual else None), sets


def _tn_update(fn, x, dc, dc2, sets, hyper, gs, **kw):
    """One update-mode call on clones of ``sets``; returns (norms, sets)."""
    sets = [tuple(v.clone() for v in st) for st in sets]
    second = list(sets[1][:3]) if len(sets) > 1 else [None] * 3
    extra = dict(group_sizes=gs) if gs else {}
    norms = fn(x, dc, dc2, *sets[0][:3], *second, hyper, w=sets[0][3], w2=sets[1][3] if len(sets) > 1 else None,
               salt=(5 << 16) + 3, stochastic_round=True, **extra, **kw)
    return norms, sets


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TN_WGMMA_CASES))
def test_tn_wgmma_kernels_match_plain_versions_on_card(case):
    """K8 and K10 on the wgmma kernels, single and dual, against their
    plain versions in every mode, one launch each by ``launches_by_kernel``:
    dW within one bf16 rounding (an empty expert's exactly zero); the norm
    mode's norms bitwise the update mode's and within the f32 bound of the
    plain's; master, mu and nu within the f32 bound; a bf16 W bitwise the
    stochastic rounding of the kernel's own master with the plain version's
    64 x 64 tile bits; K8's lane twins' outputs bitwise the kernels'."""
    _card()
    from repro_torch.optim.adamw import AdamWConfig, pack_adamw_hyper

    gs, (x, dc, dc2), sets = _tn_case_inputs(case)
    dual, (_, _, k, n, _) = dc2 is not None, TN_WGMMA_CASES[case]
    fn, plain = (tk.sfc_gemm_grouped_tn, tk.sfc_gemm_grouped_tn_plain) if gs else (tk.sfc_gemm_tn, tk.sfc_gemm_tn_plain)
    prefix = "grouped_" if gs else ""
    grp = dict(group_sizes=gs) if gs else {}
    assert tk.uses_tn_wgmma_kernel(x, dc, dc2, *(v for st in sets for v in st))
    cs = _chip_smoke()
    got, key = cs.launched(fn.launches_by_kernel, lambda: fn(x, dc, dc2, **grp))
    assert key == (f"{prefix}tn_wgmma_kernel", "128x128")
    want = plain(x, dc, dc2, bm=64, bn=64, **grp)
    for g, w in zip(got if dual else [got], want if dual else [want]):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and _agree(g, w, torch.bfloat16)
        for e, size in enumerate(gs or ()):
            if size == 0:
                assert not bool(g[e].any())
    hyper = pack_adamw_hyper(AdamWConfig(lr=1e-2), torch.tensor(7, dtype=torch.int32, device="cuda"),
                             torch.tensor(0.37, device="cuda"))
    # the norm and update modes' tile: 128 x 64 a set in the dual form
    upd_tile = "128x64" if dual else "128x128"
    (norms, got_sets), key = cs.launched(fn.launches_by_kernel,
                                         lambda: _tn_update(fn, x, dc, dc2, sets, hyper, gs))
    assert key == (f"{prefix}tn_update_wgmma_kernel", upd_tile)
    only, key = cs.launched(fn.launches_by_kernel, lambda: fn(x, dc, dc2, norm=True, **grp))
    assert key == (f"{prefix}tn_update_wgmma_kernel", upd_tile)
    torch.cuda.synchronize()
    want_norms, want_sets = _tn_update(plain, x, dc, dc2, sets, hyper, gs, bm=64, bn=64)
    assert torch.equal(only, norms) and _agree(norms, want_norms, torch.float32)
    for s, (g_set, p_set) in enumerate(zip(got_sets, want_sets)):
        for g, w in zip(g_set[:3], p_set[:3]):
            assert _agree(g, w, torch.float32)
        bits = (tk._grouped_tile_bits(len(gs), k, n, 64, 64, hyper, (5 << 16) + 3, s) if gs
                else tk._tile_bits(k, n, 64, 64, hyper, (5 << 16) + 3, *((1,) if s else ())))
        assert torch.equal(g_set[3], tk.stochastic_round_to(g_set[0], bits, torch.bfloat16))
    if gs:
        return
    on = tk.sfc_gemm_tn(x, dc, dc2, abft=True)
    assert all(torch.equal(a, b) for a, b in zip(on[:-1], got if dual else [got]))
    norms_on, chk = _tn_update(lambda *a, **kw: tk.sfc_gemm_tn(*a, abft=True, **kw), x, dc, dc2, sets, hyper, gs)[0]
    assert torch.equal(norms_on, norms) and chk.shape == (2 if dual else 1, 1)
    assert torch.equal(tk.sfc_gemm_tn(x, dc, dc2, norm=True, abft=True)[0], norms)


@pytest.mark.cuda
def test_tn_wgmma_kernels_replay_in_a_cuda_graph_with_no_state_left():
    """The TN wgmma kernels keep no counter or queue on the device: a
    captured graph of K8's dual dW, K10's ragged dW, its norm mode and K8's
    update (its state reset before each replay), replayed three times, gives
    the eager outputs bitwise every time, and the counters count the
    capture only."""
    _card()
    from repro_torch.optim.adamw import AdamWConfig, pack_adamw_hyper

    _, (x, dc, dc2), sets = _tn_case_inputs("glu_dual")
    gs, (xg, dcg, dcg2), _ = _tn_case_inputs("grouped_ragged_dual")
    hyper = pack_adamw_hyper(AdamWConfig(lr=1e-2), torch.tensor(3, dtype=torch.int32, device="cuda"),
                             torch.tensor(0.5, device="cuda"))
    work = [tuple(v.clone() for v in st) for st in sets]

    def step():
        (m1, u1, v1, w1), (m2, u2, v2, w2) = work
        return (tk.sfc_gemm_tn(x, dc, dc2), tk.sfc_gemm_grouped_tn(xg, dcg, dcg2, group_sizes=gs),
                tk.sfc_gemm_grouped_tn(xg, dcg, dcg2, group_sizes=gs, norm=True),
                tk.sfc_gemm_tn(x, dc, dc2, m1, u1, v1, m2, u2, v2, hyper, w=w1, w2=w2, salt=9,
                               stochastic_round=True))

    def reset():
        for dst, src in zip(work, sets):
            for d, s_ in zip(dst, src):
                d.copy_(s_)

    eager = step()
    eager_state = [tuple(v.clone() for v in st) for st in work]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    counts = (tk.sfc_gemm_tn.launches, tk.sfc_gemm_grouped_tn.launches)
    for _ in range(3):
        reset()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(out, eager):
            assert all(torch.equal(a, b) for a, b in zip(o if isinstance(o, tuple) else (o,),
                                                         e if isinstance(e, tuple) else (e,)))
        assert all(torch.equal(a, b) for st, est in zip(work, eager_state) for a, b in zip(st, est))
    assert (tk.sfc_gemm_tn.launches, tk.sfc_gemm_grouped_tn.launches) == counts


@pytest.mark.cuda
def test_calls_the_tn_wgmma_predicate_refuses_land_on_the_tile_kernels_on_card():
    """f32, N 133 (rows TMA cannot describe), an empty contraction and a
    misaligned master keep the 64 x 64 TN tile kernels, by
    ``launches_by_kernel``, in every mode."""
    _card()
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(26)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    fn = tk.sfc_gemm_tn.launches_by_kernel
    for x, dc in ((r(77, 264, dtype=torch.float32), r(77, 328, dtype=torch.float32)), (r(77, 264), r(77, 133)),
                  (r(0, 264), r(0, 328))):
        assert not tk.uses_tn_wgmma_kernel(x, dc)
        assert cs.launched(fn, lambda: tk.sfc_gemm_tn(x, dc))[1] == ("tn_kernel", 1)
        assert cs.launched(fn, lambda: tk.sfc_gemm_tn(x, dc, norm=True))[1] == ("tn_update_kernel", 1)
    x, dc = r(77, 264), r(77, 328)
    hyper = torch.zeros(12, device="cuda")
    flat = torch.zeros(264 * 328 + 4, device="cuda")
    mst = flat[1:1 + 264 * 328].view(264, 328)  # 4 bytes past a 16-byte boundary
    state = dict(master=mst, mu=torch.zeros_like(mst), nu=torch.ones_like(mst), w=mst.bfloat16())
    assert not tk.uses_tn_wgmma_kernel(x, dc, None, *state.values())
    assert cs.launched(fn, lambda: tk.sfc_gemm_tn(x, dc, hyper=hyper, **state))[1] == ("tn_update_kernel", 1)


# the last configs' widths: qwen2-72b / qwen2-vl-72b (d_model 8192, 64 / 8
# heads of 128, a GLU of 29568, vocab 152064; its LM head weight is 1.25 G
# elements, 2.49 GB, byte offsets past 2 GiB), at the serve's decode (M 4,
# the cluster kernel) and 4 x 128 prefill (the wgmma kernel): (lead, M, K,
# N, GLU)
WIDE_GEMM_CASES = {
    "decode_q_o": ((), 4, 8192, 8192, False),
    "decode_k_v": ((), 4, 8192, 1024, False),
    "decode_glu": ((), 4, 8192, 29568, True),
    "decode_w_out": ((), 4, 29568, 8192, False),
    "decode_head": ((), 4, 8192, 152064, False),
    "prefill_q_o": ((4,), 128, 8192, 8192, False),
    "prefill_k_v": ((4,), 128, 8192, 1024, False),
    "prefill_glu": ((4,), 128, 8192, 29568, True),
    "prefill_w_out": ((4,), 128, 29568, 8192, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDE_GEMM_CASES))
def test_kernels_at_qwen2_72b_widths_match_plain_versions_on_card(case):
    """K1 (cluster kernel, its K layers from `cluster_layers`) and K2 (the
    wgmma kernel) at qwen2-72b's serve shapes, the LM head included, in
    bf16 against the plain version (summed over the same K layers)."""
    _card()
    lead, m, k, n, glu = WIDE_GEMM_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(41)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    a, w = r(*lead, m, k), r(k, n, scale=0.02)
    wg = r(k, n, scale=0.02) if glu else None
    kw = dict(activation="silu") if glu else {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cs = _chip_smoke()
    got, key = cs.launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: tk.sfc_gemm_fused(a, w, wg, **kw))
    torch.cuda.synchronize()
    if lead:
        assert key[0] == "sfc_gemm_wgmma_kernel"
        layers = 1
    else:
        layers = tk.cluster_layers(k, n, sms)
        assert key == ("sfc_gemm_cluster_kernel", layers)
    want = tk.sfc_gemm_fused_plain(a, w, wg, bm=128, bn=1024, k_layers=layers, **kw)
    assert got.shape == (*lead, m, n) and _agree(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 40])
@pytest.mark.parametrize("form", ["glu", "w_out"])
def test_grouped_wgmma_kernel_at_128_experts_matches_plain_version_on_card(form, rows):
    """K3 at qwen3-moe-30b-a3b's widths (128 experts of 768, d_model 2048):
    32 rows an expert (the serve's decode) and 40 (its 4 x 128 prefill),
    the GLU with silu in the flush and w_out, on the grouped wgmma kernel."""
    _card()
    gs = (rows,) * 128
    k, n = (2048, 768) if form == "glu" else (768, 2048)
    a, w, wg, *_ = _grouped_inputs(np.random.default_rng(43), gs, k, n, torch.bfloat16, scale=0.02)
    args, kw = ((a, w, wg), dict(activation="silu")) if form == "glu" else ((a, w), {})
    got, key = _chip_smoke().launched(tk.sfc_gemm_grouped.launches_by_kernel,
                                      lambda: tk.sfc_gemm_grouped(*args, group_sizes=gs, **kw))
    torch.cuda.synchronize()
    assert key[0] == "sfc_gemm_grouped_wgmma_kernel"
    want = tk.sfc_gemm_grouped_plain(*args, group_sizes=gs, bm=64, bn=64, **kw)
    assert got.shape == (sum(gs), n) and _agree(got, want, torch.bfloat16)


# (heads, kv heads, head dim): qwen2-72b's group 8 of D 128 and
# stablelm-1.6b's 32 / 32 of D 64
LAST_HEADS = {"group8_d128": (64, 8, 128), "group1_d64": (32, 32, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("heads", sorted(LAST_HEADS))
def test_attention_kernels_at_the_last_configs_heads_match_plain_versions_on_card(heads):
    """K11 at the serve's 4 x 128 prefill (bf16, the wgmma kernel at its W)
    and K14 over the serve's 145-row cache at its segments, each against
    its plain version."""
    _card()
    h, hkv, d = LAST_HEADS[heads]
    q, k, v = _attn_inputs(4, 128, 128, h, hkv, d, torch.bfloat16)
    _check_flash_fwd(q, k, v, dict(causal=True), _fwd_wgmma_key(q, k))
    qd, kc, vc = _attn_inputs(4, 1, 145, h, hkv, d, torch.bfloat16, seed=21)
    valid = torch.tensor((129, 134, 139, 144), dtype=torch.int32, device="cuda")
    splits = tsa.decode_splits(4, hkv, 145, torch.cuda.get_device_properties(0).multi_processor_count)
    got, added = _chip_smoke().launched(tsa.sfc_decode_attention.launches_by_splits,
                                        lambda: tsa.sfc_decode_attention(qd, kc, vc, valid))
    torch.cuda.synchronize()
    assert added == splits
    want = tsa.sfc_decode_attention_plain(qd, kc, vc, valid, k_chunk=build.DECODE_CHUNK, splits=splits)
    assert _agree(got, want, torch.bfloat16)
