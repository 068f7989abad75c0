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


@pytest.mark.parametrize("kernel", ["fused_glu", "grouped_ragged", "tn_dual"])
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
            tiles = cs.raw_tile_sums(torch, x.float().T @ dc.float())
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
