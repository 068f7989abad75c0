"""CPU checks of helpers that the card-side scripts run: `chip_smoke.py`'s
routing reading where two backends' greedy tokens part, on reduced
olmoe-1b-7b, and the ptxas log and SASS parsers of
`scripts/dense_kernel_ab.py`."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up here
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_counts_reads_registers_and_spills(tmp_path):
    ab = _load(ROOT / "scripts" / "dense_kernel_ab.py", "dense_kernel_ab")
    log = tmp_path / "build" / "sfc_gemm_fused-0" / "nvcc.log"
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : Compiling entry function '_Z9nt_kernelIfLb0EEv9BwdParams' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z9nt_kernelIfLb0EEv9BwdParams\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 552 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z9tn_kernelIfLb1EEv9BwdParams' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z9tn_kernelIfLb1EEv9BwdParams\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 552 bytes cmem[0]\n")
    counts = ab.ptxas_counts(tmp_path)
    assert sorted(counts.values()) == [[96, 8, 12], [128, 0, 0]]
    assert [k for k in counts if "nt_kernel" in k] and [k for k in counts if "tn_kernel" in k]


def test_sass_digests_compare_instructions_only():
    ab = _load(ROOT / "scripts" / "dense_kernel_ab.py", "dense_kernel_ab")

    def listing(name, at, insns):
        rows = [f"\t\tFunction : {name}\n", "\t.headerflags\t@\"EF_CUDA_SM90\"\n"]
        rows += [f"        /*{at + 16 * i:04x}*/                   {ins} ;   /* 0x{at + i:016x} */\n"
                 for i, ins in enumerate(insns)]
        return rows

    body = ["LDC R1, c[0x0][0x28]", "@P0 BRA 0x80", "EXIT"]
    digests = ab._sass_digests(listing("_Z1aIfEvv", 0, body) + listing("_Z1bIfEvv", 0x100, body)
                               + listing("_Z1cIfEvv", 0, body[:1] + ["EXIT"]))
    assert set(digests) == {"_Z1aIfEvv", "_Z1bIfEvv", "_Z1cIfEvv"}
    # the same instructions at other addresses and encodings digest alike
    assert digests["_Z1aIfEvv"] == digests["_Z1bIfEvv"] != digests["_Z1cIfEvv"]


def test_routing_at_divergence_replays_both_backends():
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(), param_dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=8).astype(np.int32) for _ in range(2)]
    engines = {name: ServingEngine(cfg, params, max_batch=2, max_seq=13, gemm_backend=name, device="cpu")
               for name in ("sfc_cuda", "torch")}
    batch = engines["torch"].run(engines["torch"].submit_many(prompts, max_new_tokens=4))
    torch_tokens = np.array([r.output for r in batch])
    route = tmoe.route
    same = {"sfc_cuda": torch_tokens.copy(), "torch": torch_tokens}
    assert cs.moe_routing_at_divergence(torch, np, engines, prompts, same, cfg.moe_top_k) == {"diverged_requests": 0}
    parted = torch_tokens.copy()
    parted[1, 2] = (parted[1, 2] + 1) % cfg.vocab
    out = cs.moe_routing_at_divergence(torch, np, engines, prompts, {"sfc_cuda": parted, "torch": torch_tokens},
                                       cfg.moe_top_k)
    assert tmoe.route is route
    assert out["diverged_requests"] == 1
    (req,) = out["requests"]
    assert (req["request"], req["first_divergent_token"], req["step"]) == (1, 2, "decode 2")
    assert req["layers"] == cfg.n_layers
    assert 0 <= req["layers_with_different_topk"] == len(req["swapped_prob_gap_torch"]) <= cfg.n_layers
    # the prompt's 8 tokens at the prefill, then one token at each of 2 decode steps
    assert req["sets_through_step"] == (8 + 2) * cfg.n_layers
    assert 0 <= req["sets_different_through_step"] <= req["sets_through_step"]
    assert req["topk_margin_median_torch"] >= 0 and req["torch_top1_logit_margin"] >= 0


def test_routing_reading_of_a_model_without_moe_layers_has_no_median():
    """A dense model records no routing: where its greedy tokens part, the
    reading has an empty layer list and writes ``None`` for the median of
    the top-k margins (no "Mean of empty slice" warning, no NaN)."""
    import warnings

    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    cfg = get_config("qwen3_4b").reduced()
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=8).astype(np.int32) for _ in range(2)]
    engines = {name: ServingEngine(cfg, params, max_batch=2, max_seq=13, gemm_backend=name, device="cpu")
               for name in ("sfc_cuda", "torch")}
    batch = engines["torch"].run(engines["torch"].submit_many(prompts, max_new_tokens=3))
    torch_tokens = np.array([r.output for r in batch])
    parted = torch_tokens.copy()
    parted[0, 1] = (parted[0, 1] + 1) % cfg.vocab
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        out = cs.moe_routing_at_divergence(torch, np, engines, prompts, {"sfc_cuda": parted, "torch": torch_tokens},
                                           cfg.moe_top_k)
    (req,) = out["requests"]
    assert (req["layers"], req["layers_with_different_topk"], req["first_layer_different"]) == (0, 0, None)
    assert req["topk_margin_median_torch"] is None and req["sets_through_step"] == 0


def test_replicated_rows_cover_every_serve_shape_with_their_bounds():
    """chip_smoke.py's replicated-form rows: every projection of the
    qwen3-4b serve at decode (K4) and prefill (K5) at each k_layers, the LM
    head at 1 and 8; the bounds count A and B once and the L copies once
    (K4/K5) or the L copies and C once (K6)."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    cfg = get_config("qwen3_4b")
    gemms = cs.replicated_gemms(cfg)
    assert len(gemms) == 2 * 5 * len(cs.REP_LAYERS) + len(cs.REP_HEAD_LAYERS)
    assert {(g.kernel, g.m) for g in gemms} == {("K4", cs.BATCH), ("K5", cs.PROMPT)}
    kv8 = next(g for g in gemms if g.name == "decode/k,v" and g.layers == 8)
    assert kv8.key == (0, cs.BATCH, 2560, 1024, 8) and kv8.reduce_key == (0, 8, cs.BATCH, 1024)
    ms, by = kv8.bound()
    nbytes = 2 * (4 * 2560 + 2560 * 1024) + 2 * 8 * 4 * 1024
    assert by == "bytes" and ms == pytest.approx(nbytes / cs.PEAK_BYTES * 1e3)
    glu = next(g for g in gemms if g.name == "prefill/mlp_glu" and g.layers == 8)
    ms, by = glu.reduce_bound()
    assert glu.copy_elem == 4 and by == "bytes"
    assert ms == pytest.approx(4 * 9 * 4 * 128 * cfg.d_ff / cs.PEAK_BYTES * 1e3)
    head = [g.layers for g in gemms if g.name == "head"]
    assert head == list(cs.REP_HEAD_LAYERS) and glu.shape()["copies"] == "float32"


def test_raw_tile_sums_and_grouped_raw_are_the_lane_partials():
    """chip_smoke.py's `raw_tile_sums` against a loop over 64 x 64 tiles
    (edge tiles clipped, the GLU's two products added tile by tile), and
    `grouped_raw` against each expert's own product (an empty expert a
    zero slab), at f32 rtol 1e-6 (the same elements summed in other
    orders)."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    g = torch.Generator().manual_seed(5)
    c, d = torch.randn(2, 70, 130, generator=g), torch.randn(2, 70, 130, generator=g)
    want = [(c[b, r:r + 64, q:q + 64] + d[b, r:r + 64, q:q + 64]).sum()
            for b in range(2) for r in range(0, 70, 64) for q in range(0, 130, 64)]
    torch.testing.assert_close(cs.raw_tile_sums(torch, c, d), torch.stack(want), rtol=1e-6, atol=1e-5)
    sizes = (5, 0, 19, 32)
    a, w = torch.randn(sum(sizes), 24, generator=g), torch.randn(4, 24, 40, generator=g)
    raw = cs.grouped_raw(torch, a, w, sizes)
    assert raw.shape == (4, 32, 40)
    off = 0
    for e, n in enumerate(sizes):
        torch.testing.assert_close(raw[e, :n], a[off:off + n] @ w[e], rtol=1e-6, atol=1e-5)
        assert not raw[e, n:].any()
        off += n


@pytest.mark.parametrize("kernel", ["fused_glu", "grouped_ragged", "tn_dual", "tn_dual_wgmma_tile"])
def test_lane_limit_holds_a_reordered_lane_and_misses_a_faulty_one(kernel):
    """chip_smoke.py's lane-against-plain limit (1e-5 of the sum of |64 x
    64 raw tile sums|, never above `tolerance()`): the plain lane at 16 x
    16 tiles (its sums in another order, as the kernel's are) lies within
    it, and the lane-side controls (a lane of 0, the lane less its last
    tile, the sum after the epilogue) lie beyond it, in f32 and bf16."""
    from repro_torch.kernels import sfc_gemm as tk
    from repro_torch.robust import abft

    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    g = torch.Generator().manual_seed(6)
    for dt in (torch.float32, torch.bfloat16):
        def r(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(dt)

        if kernel == "fused_glu":
            a, w, wg, bias = r(3, 77, 203), r(203, 133, scale=0.1), r(203, 133, scale=0.1), r(133)
            lanes = [tk.sfc_gemm_fused_plain(a, w, wg, bias, activation="silu", bm=b, bn=b, abft=True)
                     for b in (64, 16)]
            tiles = cs.raw_tile_sums(torch, a.float() @ w.float(), a.float() @ wg.float())
            ref, mag = abft.gemm_checksum_ref(a, w, wg)
            lane, other, out, depth = lanes[0][-1], lanes[1][-1], lanes[0][0], 203
        elif kernel == "grouped_ragged":
            sizes = (5, 0, 19, 70)
            a, w = r(sum(sizes), 96), r(4, 96, 80, scale=0.1)
            lanes = [tk.sfc_gemm_grouped_plain(a, w, group_sizes=sizes, activation="gelu", bm=b, bn=b, abft=True)
                     for b in (64, 16)]
            tiles = cs.raw_tile_sums(torch, cs.grouped_raw(torch, a, w, sizes))
            ref, mag = abft.grouped_checksum_ref(a, w, None, sizes)
            lane, other, out, depth = lanes[0][-1], lanes[1][-1], lanes[0][0], 96
        else:
            x, dc, dc2 = r(150, 90), r(150, 140), r(150, 140)
            lanes = [tk.sfc_gemm_tn_plain(x, dc, dc2, bm=b, bn=b, abft=True) for b in (64, 16)]
            # the TN wgmma kernels' lane sums 128 x 128 tiles
            tiles = (cs.kernel_tiles(torch, "tn_wgmma_kernel", "128x128", x.float().T @ dc.float())
                     if kernel == "tn_dual_wgmma_tile" else cs.raw_tile_sums(torch, x.float().T @ dc.float()))
            ref, mag = abft.tn_checksum_ref(x, dc)
            lane, other, out, depth = lanes[0][-1][0, 0], lanes[1][-1][0, 0], None, 150
        limit = cs.lane_limit(tiles, abft.tolerance(mag, depth))
        assert limit < float(abft.tolerance(mag, depth))
        assert abs(float(lane) - float(other)) <= limit
        wrong = cs._dropped(lane, tiles)
        if out is not None:
            wrong["after_epilogue"] = out.float().sum()
        for name, v in wrong.items():
            assert abs(float(v) - float(lane)) > limit, (kernel, str(dt), name)


def test_kernel_tiles_are_the_tiles_each_lane_sums():
    """chip_smoke.py's `kernel_tiles`: for the wgmma kernel the batch folds
    into the rows (shared weights) and the blocks are its C tile ("128x64",
    a narrow GLU tile), against a loop; every other kernel's are
    `raw_tile_sums`'s 64 x 64 blocks of each batch element."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    g = torch.Generator().manual_seed(7)
    c, d = torch.randn(3, 77, 130, generator=g), torch.randn(3, 77, 130, generator=g)
    flat = (c + d).reshape(231, 130)
    want = [flat[r:r + 128, q:q + 64].sum() for r in range(0, 231, 128) for q in range(0, 130, 64)]
    torch.testing.assert_close(cs.kernel_tiles(torch, "sfc_gemm_wgmma_kernel", "128x64", c, d), torch.stack(want),
                               rtol=1e-6, atol=1e-5)
    for name, config in (("sfc_gemm_fused_kernel", 1), ("sfc_gemm_cluster_kernel", 4)):
        assert torch.equal(cs.kernel_tiles(torch, name, config, c, d), cs.raw_tile_sums(torch, c, d))
    assert cs.plain_layers("sfc_gemm_cluster_kernel", 4) == 4 and cs.plain_layers("sfc_gemm_wgmma_kernel", "128x64") == 1


def test_kernel_tiles_of_the_tn_wgmma_kernels_are_their_128_by_128_tiles():
    """K8's wgmma lanes (dW, update and norm) sum each set's (K, N) dW over
    128 x 128 tiles; its tile kernels' over 64 x 64 ones."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    c = torch.randn(264, 328, generator=torch.Generator().manual_seed(8))
    want = torch.stack([c[r:r + 128, q:q + 128].sum() for r in range(0, 264, 128) for q in range(0, 328, 128)])
    for name in ("tn_wgmma_kernel", "tn_update_wgmma_kernel"):
        torch.testing.assert_close(cs.kernel_tiles(torch, name, "128x128", c), want, rtol=1e-6, atol=1e-4)
    for name in ("tn_kernel", "tn_update_kernel"):
        assert torch.equal(cs.kernel_tiles(torch, name, 1, c), cs.raw_tile_sums(torch, c))


# profiler keys of the TN kernels (demangled) -> (group, update instantiation)
_TN_PROFILE_KEYS = {
    "void (anonymous namespace)::tn_update_wgmma_kernel<true, true>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params, (anonymous namespace)::TnFlush<2, true, false, false>)": ("K8 wgmma norm/update", True),
    "void (anonymous namespace)::tn_update_wgmma_kernel<false, false>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params, (anonymous namespace)::TnFlush<1, false, false, false>)":
        ("K8 wgmma norm/update", False),
    "void (anonymous namespace)::grouped_tn_update_wgmma_kernel<true, true>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params, (anonymous namespace)::TnFlush<2, true, true, false>)": ("K10 wgmma norm/update", True),
    "void (anonymous namespace)::grouped_tn_wgmma_kernel<true, false>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params, (anonymous namespace)::TnFlush<0, true, true, false>)": ("K10 wgmma", None),
    "void (anonymous namespace)::tn_wgmma_kernel<false, false>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
    "wg::Params, (anonymous namespace)::TnFlush<0, false, false, false>)": ("K8 wgmma", None),
    "void (anonymous namespace)::tn_update_kernel<__nv_bfloat16, true, true, true>((anonymous namespace)::BwdParams, "
    "(anonymous namespace)::UpdParams)": ("K8 norm/update", True),
    "void (anonymous namespace)::grouped_tn_update_kernel<float, false, false, false>((anonymous namespace)::"
    "BwdParams, (anonymous namespace)::UpdParams)": ("K10 norm/update", False),
    "void (anonymous namespace)::grouped_tn_kernel<float, true>((anonymous namespace)::BwdParams)": ("K10", None),
    "void (anonymous namespace)::tn_kernel<__nv_bfloat16, false>((anonymous namespace)::BwdParams)": ("K8", None),
    "void (anonymous namespace)::nt_wgmma_kernel<128>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
    "wg::Params)": ("K7 wgmma", None),
}


@pytest.mark.parametrize("key", sorted(_TN_PROFILE_KEYS))
def test_a_step_profile_names_every_tn_kernel_and_splits_norm_from_update(key):
    """chip_smoke.py's profile groups, matched as `profile_step` matches
    them (the first fragment of the MoE list in a key), give each TN
    kernel its own group, and the norm / update split reads each kernel's
    UPDATE template argument."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    label, update = _TN_PROFILE_KEYS[key]
    assert next(lab for frag, lab in cs._MOE_KERNEL_GROUPS if frag in key) == label
    if not label.startswith("K10"):
        assert next(lab for frag, lab in cs._KERNEL_GROUPS if frag in key) == label
    if update is not None:
        assert cs._is_update(key) is update


def test_kernel_counts_split_every_wgmma_family_from_its_tile_kernels():
    """`_kernel_counts`: K8's and K10's launches on their wgmma kernels
    (every mode) and on the tile kernels (dW and the update / norm kernel)."""
    import collections
    import types

    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")

    def fn(**counts):
        return types.SimpleNamespace(launches_by_kernel=collections.Counter(
            {(name, cfg): n for (name, cfg), n in counts.values()}))

    counted = {"sfc_gemm_tn": fn(a=(("tn_wgmma_kernel", "128x128"), 3), b=(("tn_update_wgmma_kernel", "128x128"), 4),
                                 c=(("tn_kernel", 1), 5), d=(("tn_update_kernel", 1), 6)),
               "sfc_gemm_grouped_tn": fn(a=(("grouped_tn_update_wgmma_kernel", "128x128"), 2),
                                         b=(("grouped_tn_kernel", 1), 1), c=(("grouped_tn_update_kernel", 1), 7))}
    assert cs._kernel_counts(counted) == {"sfc_gemm_tn:wgmma": 7, "sfc_gemm_tn:tile": 11,
                                          "sfc_gemm_grouped_tn:wgmma": 2, "sfc_gemm_grouped_tn:tile": 8}


# profiler keys of the grouped forward and dA kernels (demangled) -> group
_GROUPED_PROFILE_KEYS = {
    "void (anonymous namespace)::sfc_gemm_grouped_wgmma_kernel<true, 1, 256>(CUtensorMap, CUtensorMap, "
    "CUtensorMap, CUtensorMap, wg::Params)": "K3 wgmma",
    "void (anonymous namespace)::grouped_nt_wgmma_kernel<256>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params)": "K9 wgmma",
    "void (anonymous namespace)::sfc_gemm_grouped_kernel<float, true, 1, false, false, false, true>("
    "(anonymous namespace)::Params, (anonymous namespace)::GroupRows)": "K3",
    "void (anonymous namespace)::grouped_nt_kernel<float, true>((anonymous namespace)::BwdParams)": "K9",
    "void (anonymous namespace)::sfc_gemm_wgmma_kernel<true, 1, 256>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params)": "K2 wgmma",
}


@pytest.mark.parametrize("key", sorted(_GROUPED_PROFILE_KEYS))
def test_a_moe_step_profile_tells_the_grouped_wgmma_kernels_from_k2_and_k7(key):
    """The MoE step's profile groups, matched as `profile_step` matches
    them: K3's and K9's wgmma kernels have groups of their own, ahead of
    K2's and K7's, whose names ("nt_wgmma_kernel") are fragments of
    theirs."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    assert next(lab for frag, lab in cs._MOE_KERNEL_GROUPS if frag in key) == _GROUPED_PROFILE_KEYS[key]


def test_kernel_tiles_of_the_grouped_wgmma_kernel_are_each_experts_128_row_tiles():
    """K3's wgmma lane sums each expert's rows (`grouped_raw`'s slabs) over
    128 x BN tiles, never folding one expert's rows into another's; its
    tile kernel's over 64 x 64 tiles."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    g = torch.Generator().manual_seed(9)
    sizes = (80, 0, 45, 130)
    a, w = torch.randn(sum(sizes), 24, generator=g), torch.randn(4, 24, 136, generator=g)
    raw = cs.grouped_raw(torch, a, w, sizes)
    want, off = [], 0
    for e, rows in enumerate(sizes):
        for r in range(0, max(sizes), 128):
            for q in range(0, 136, 64):
                want.append((a[off:off + rows] @ w[e])[r:r + 128, q:q + 64].sum())
        off += rows
    torch.testing.assert_close(cs.kernel_tiles(torch, "sfc_gemm_grouped_wgmma_kernel", "128x64", raw),
                               torch.stack(want), rtol=1e-5, atol=1e-3)
    assert torch.equal(cs.kernel_tiles(torch, "sfc_gemm_grouped_kernel", 1, raw), cs.raw_tile_sums(torch, raw))


def test_kernel_counts_split_k3_and_k9_from_their_tile_kernels():
    """`_kernel_counts` of a MoE run: K3's and K9's launches on their
    grouped wgmma kernels and on their 64 x 64 tile kernels, apart."""
    import collections
    import types

    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")

    def fn(counts):
        return types.SimpleNamespace(launches_by_kernel=collections.Counter(counts))

    counted = {"sfc_gemm_grouped": fn({("sfc_gemm_grouped_wgmma_kernel", "128x128"): 16,
                                       ("sfc_gemm_grouped_wgmma_kernel", "128x256"): 3,
                                       ("sfc_gemm_grouped_kernel", 1): 2}),
               "sfc_gemm_grouped_nt": fn({("grouped_nt_wgmma_kernel", "128x256"): 16})}
    assert cs._kernel_counts(counted) == {"sfc_gemm_grouped:wgmma": 19, "sfc_gemm_grouped:tile": 2,
                                          "sfc_gemm_grouped_nt:wgmma": 16, "sfc_gemm_grouped_nt:tile": 0}


# profiler keys (demangled) of the replicated serve's kernels -> group
_REP_PROFILE_KEYS = {
    "void (anonymous namespace)::sfc_gemm_replicated_cluster_kernel<__nv_bfloat16>((anonymous namespace)::Params, "
    "int, int)": "K4/K5",
    "void (anonymous namespace)::sfc_gemm_replicated_wgmma_kernel<128, true>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params)": "K4/K5",
    "void (anonymous namespace)::sfc_gemm_replicated_kernel<__nv_bfloat16, float>((anonymous namespace)::Params, "
    "int, int)": "K4/K5",
    "void (anonymous namespace)::add_reduce_kernel<__nv_bfloat16, 1, true, int>(__nv_bfloat16 const*, "
    "__nv_bfloat16*, int, int)": "K6",
    "void (anonymous namespace)::sfc_gemm_cluster_kernel<false, 0, false, false, false, false, false>("
    "(anonymous namespace)::Params, int)": "K1 cluster",
    "void (anonymous namespace)::sfc_gemm_wgmma_kernel<false, 0, 128>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, wg::Params)": "K2 wgmma",
}


@pytest.mark.parametrize("key", sorted(_REP_PROFILE_KEYS))
def test_a_decode_profile_files_every_replicated_kernel_under_k4_k5(key):
    """`profile_decode`'s groups, matched as it matches them (the first
    fragment in a key): K4 / K5's cluster, wgmma and tile kernels are
    "K4/K5", and K1's cluster and K2's wgmma kernels keep their groups."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    assert next(lab for frag, lab in cs._SERVE_KERNEL_GROUPS if frag in key) == _REP_PROFILE_KEYS[key]


def test_replicated_routes_and_splits_of_the_smoke_run():
    """phase 2's K4 rows take the cluster kernel and sum the plain version
    over its L'; K5's the wgmma kernel, one sum a layer."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    assert cs.REP_ROUTES == {"K4": "sfc_gemm_replicated_cluster_kernel", "K5": "sfc_gemm_replicated_wgmma_kernel"}
    assert cs.rep_split("sfc_gemm_replicated_cluster_kernel", 4) == 4
    assert cs.rep_split("sfc_gemm_replicated_wgmma_kernel", "128x128") == 1
    assert cs.rep_split("sfc_gemm_replicated_kernel", 1) == 1
    assert cs.kernel_source("sfc_gemm_replicated_wgmma_kernel") == cs.WGMMA_SOURCE
    assert cs.kernel_source("sfc_gemm_replicated_cluster_kernel") == cs.GEMM_SOURCE


def test_the_ab_scripts_k4_k5_rows_are_the_serves_products_at_both_splits():
    """`dense_kernel_ab.replicated_ab_gemms`: every K4 (decode and the LM
    head) and K5 (prefill) product of the "replicated" serve at k_layers 1
    and 8, and `--only` keeps one family."""
    ab = _load(ROOT / "scripts" / "dense_kernel_ab.py", "dense_kernel_ab")
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    cfg = get_config("qwen3_4b")
    rows = ab.replicated_ab_gemms(cs, cfg)
    assert len(rows) == 2 * (5 + 5 + 1) and {g.layers for g in rows} == {1, 8}
    assert {g.name for g in rows if g.kernel == "K4"} == {f"decode/{n}" for n in ("q", "k,v", "o", "mlp_glu",
                                                                                    "mlp_out")} | {"head"}
    assert all(g.kernel == "K5" and g.m == cs.PROMPT for g in rows if g.name.startswith("prefill/"))
    assert all(g.k % g.layers == 0 for g in rows)  # the library's K-slab views
    assert {g.kernel for g in ab.replicated_ab_gemms(cs, cfg, lambda family: family == "K5")} == {"K5"}


def test_the_ab_scripts_forward_rows_are_k11_and_k15_at_the_smoke_runs_shapes():
    """`dense_kernel_ab.fwd_ab_cases`: K11 at the prefill, the training step
    and 1 x 2000 tokens (q_offset 0 and 48) and K15 at the prefill, as
    `chip_smoke.attention_cases` has them; `--only` keeps one family."""
    ab = _load(ROOT / "scripts" / "dense_kernel_ab.py", "dense_kernel_ab")
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    cfg = get_config("qwen3_4b")
    rows = ab.fwd_ab_cases(cs, cfg)
    assert [(c.kernel, c.name, c.b, c.s, c.t, c.q_offset) for c in rows] == [
        ("sfc_flash_fwd", "prefill", 4, 128, 128, 0), ("sfc_flash_fwd", "train", 2, 256, 256, 0),
        ("sfc_flash_fwd", "long_1x2000", 1, 2000, 2000, 0),
        ("sfc_flash_fwd", "long_1x2000_q_offset_48", 1, 2000, 2048, 48),
        ("flash_attention", "prefill", 4, 128, 128, 0)]
    assert all((c.h, c.hkv, c.d, c.causal) == (32, 8, 128, True) for c in rows)
    assert [c.kernel for c in ab.fwd_ab_cases(cs, cfg, lambda family: family == "K15")] == ["flash_attention"]
    assert len(ab.fwd_ab_cases(cs, cfg, lambda family: family == "K11")) == 4


def test_split_sweep_takes_k11_and_its_shapes():
    """`split_sweep.py` sweeps every kernel by default, the named ones else,
    and refuses an unknown name; its K11 shapes are the smoke run's four
    and one prompt's prefill, with the W the wrapper chooses on an H100's
    132 SMs."""
    from repro_torch.kernels import sfc_attention as tsa

    sw = _load(ROOT / "scripts" / "split_sweep.py", "split_sweep")
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    assert sw.sweep_parts([]) == {"k14", "k1", "k13", "k11", "k6"}
    assert sw.sweep_parts(["k11"]) == {"k11"}
    with pytest.raises(SystemExit):
        sw.sweep_parts(["k12"])
    cases = sw.k11_cases(cs, get_config("qwen3_4b"))
    assert [(c.b, c.s, c.t, c.q_offset) for c in cases] == [(4, 128, 128, 0), (2, 256, 256, 0), (1, 2000, 2000, 0),
                                                             (1, 2000, 2048, 48), (1, 128, 128, 0)]
    assert {(c.kernel, c.h, c.hkv, c.d) for c in cases} == {("sfc_flash_fwd", 32, 8, 128)}
    assert [tsa.fwd_wgmma_grid(c.b, c.s, c.t, c.h, c.hkv)[1] for c in cases] == [2, 2, 2, 2, 1]


# profiler keys of the flash forward's kernels (demangled) -> group
_FWD_PROFILE_KEYS = {
    "void (anonymous namespace)::fw::flash_fwd_wgmma_kernel<128, 2>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "(anonymous namespace)::FwdParams)": "K11 wgmma",
    "void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 128>((anonymous namespace)::FwdParams)": "K11",
    "void (anonymous namespace)::bw::flash_bwd_dq_wgmma_kernel<128>(CUtensorMap, CUtensorMap, CUtensorMap, "
    "CUtensorMap, (anonymous namespace)::BwdParams)": "K12 wgmma",
}


@pytest.mark.parametrize("key", sorted(_FWD_PROFILE_KEYS))
def test_a_step_profile_tells_the_wgmma_flash_forward_from_the_tile_kernel(key):
    """chip_smoke.py's profile groups, matched as `profile_step` matches
    them, in the dense and the MoE steps: the wgmma flash forward has a group
    of its own ("flash_fwd_kernel" is no fragment of its name)."""
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    for groups in (cs._KERNEL_GROUPS, cs._MOE_KERNEL_GROUPS):
        assert next(lab for frag, lab in groups if frag in key) == _FWD_PROFILE_KEYS[key]


def test_kernel_counts_split_k11_from_its_tile_kernel():
    """`_kernel_counts`: K11's launches on the wgmma kernel (every W) and on
    the 64 x 64 tile kernel."""
    import collections
    import types

    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    counted = {"sfc_flash_fwd": types.SimpleNamespace(launches_by_kernel=collections.Counter(
        {("flash_fwd_wgmma_kernel", 2): 36, ("flash_fwd_wgmma_kernel", 1): 4, ("flash_fwd_kernel", 1): 3}))}
    assert cs._kernel_counts(counted) == {"sfc_flash_fwd:wgmma": 40, "sfc_flash_fwd:tile": 3}


def test_split_sweep_takes_k6_at_the_smoke_runs_reduce_shapes():
    """`split_sweep.py k6`: K6 at every product of `chip_smoke.py`'s
    replicated rows past one K layer (decode and prefill at k_layers 2, 4
    and 8, the LM head at 8), the eleven split-serve shapes among them."""
    sw = _load(ROOT / "scripts" / "split_sweep.py", "split_sweep")
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    assert sw.sweep_parts(["k6"]) == {"k6"}
    cases = sw.k6_cases(cs, get_config("qwen3_4b"))
    assert len(cases) == 10 * 3 + 1 and {g.layers for g in cases} == {2, 4, 8}
    assert sum(g.layers == 8 for g in cases) == 11
    assert {g.name for g in cases if g.name.startswith("decode/")} == {
        f"decode/{n}" for n in ("q", "k,v", "o", "mlp_glu", "mlp_out")}
    assert [g.copy_elem for g in cases if g.glu] == [4] * 6


def test_the_ab_scripts_k6_rows_are_the_split_serves_sums():
    """`dense_kernel_ab.reduce_ab_gemms` (`--only K6`): the eleven K6 shapes
    of the k_layers-8 serve, each with its byte bound: 9 copies' bytes
    (8 read, 1 written)."""
    ab = _load(ROOT / "scripts" / "dense_kernel_ab.py", "dense_kernel_ab")
    cs = _load(ROOT / "chip_smoke.py", "chip_smoke_under_test")
    rows = ab.reduce_ab_gemms(cs, get_config("qwen3_4b"))
    assert len(rows) == 11 and {g.layers for g in rows} == {8}
    assert {g.reduce_key for g in rows} >= {(0, 8, cs.BATCH, 151936), (cs.BATCH, 8, cs.PROMPT, 9728)}
    for g in rows:
        ms, by = g.reduce_bound()
        assert by == "bytes" and ms == pytest.approx(g.copy_elem * 9 * g.rows * g.n / cs.PEAK_BYTES * 1e3)
