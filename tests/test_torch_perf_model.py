"""The port's decomposition and performance model (`repro_torch.core.
decomposition`, `repro_torch.core.perf_model`) against the JAX package's on
the CPU: the same patches, grids and word counts (integers exactly), every
perf-model function's result within 1e-12 relative for floats, over a grid
of shapes, under the data-sheet model and a calibrated-like one; and the
`H100_SXM` model's data-sheet constants."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import decomposition as jdec  # noqa: E402
from repro.core import perf_model as jpm  # noqa: E402
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core import perf_model as tpm  # noqa: E402

REL = 1e-12


def same(got, want):
    """Equal: integers and strings exactly, floats within 1e-12 relative,
    containers element by element."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0) or got == want, (got, want)
    else:
        assert got == want, (got, want)


def hw_pair(calibrated: bool):
    """(port, JAX) TPU v5e models, optionally with every overhead set."""
    if not calibrated:
        return tpm.TPU_V5E, jpm.TPU_V5E
    kw = dict(launch_overhead_s=3e-6, flush_overhead_s=2e-7, drain_byte_s=1e-13, vmem_penalty=5e-12,
              reuse_miss_beta=2e-13, gamma=tpm.TPU_V5E.gamma * 1.3, beta=tpm.TPU_V5E.beta * 1.3)
    return dataclasses.replace(tpm.TPU_V5E, **kw), dataclasses.replace(jpm.TPU_V5E, **kw)


def test_all_is_the_jax_modules_and_the_h100():
    assert set(tdec.__all__) == set(jdec.__all__)
    assert set(tpm.__all__) == set(jpm.__all__) | {"H100_SXM", "H100_SMS"}
    assert dataclasses.asdict(tpm.TPU_V5E) == dataclasses.asdict(jpm.TPU_V5E)


def test_h100_sxm_is_its_data_sheet():
    hw = tpm.H100_SXM
    assert tpm.H100_SMS == 132
    assert math.isclose(hw.peak_flops, 989e12, rel_tol=REL)
    assert math.isclose(hw.mem_bw, 3.35e12, rel_tol=REL)
    assert hw.fast_bytes == 50 * 2**20 // 132  # an SM's share of the 50 MB L2
    assert hw.vmem_budget_bytes == 227 * 1024  # a CTA's shared memory at most
    assert math.isclose(hw.machine_balance, 989e12 / 3.35e12, rel_tol=1e-9)
    assert not hw.calibrated and hw.launch_overhead_s == hw.flush_overhead_s == 0.0


@pytest.mark.parametrize("mb,nb,t,c", [(1, 1, 1, 1), (4, 4, 4, 1), (8, 4, 8, 2), (6, 10, 12, 3), (16, 16, 32, 4),
                                        (3, 7, 5, 1), (2, 2, 8, 2), (12, 5, 24, 8)])
def test_sfc_decompose_matches_jax(mb, nb, t, c):
    got, want = tdec.sfc_decompose(mb, nb, t, c), jdec.sfc_decompose(mb, nb, t, c)
    assert (got.mb, got.nb, got.k_layers, got.n_workers, got.workers_per_layer) == (
        want.mb, want.nb, want.k_layers, want.n_workers, want.workers_per_layer)
    assert len(got.patches) == len(want.patches)
    for g, w in zip(got.patches, want.patches):
        assert (g.worker, g.layer, g.start, g.stop, g.bbox) == (w.worker, w.layer, w.start, w.stop, w.bbox)
        np.testing.assert_array_equal(g.cells, w.cells)
        assert (g.n_cells, g.bbox_shape, g.is_rectangle) == (w.n_cells, w.bbox_shape, w.is_rectangle)
        if g.n_cells:
            assert (g.n_rows, g.n_cols) == (w.n_rows, w.n_cols)
    assert got.implied_grid() == want.implied_grid() == tdec.implied_worker_grid(got)
    assert [len(got.layer_patches(i)) for i in range(c)] == [len(want.layer_patches(i)) for i in range(c)]
    assert tdec.partition_curve(mb, nb, t) == jdec.partition_curve(mb, nb, t)


def test_bad_decompositions_raise_as_in_jax():
    with pytest.raises(ValueError):
        tdec.sfc_decompose(4, 4, 6, 4)
    with pytest.raises(ValueError):
        tdec.sfc_grid_factorization(6, 4, 4, 4)


@pytest.mark.parametrize("t,mb,nb,c", [(1, 4, 4, 1), (8, 16, 16, 1), (16, 64, 8, 2), (12, 9, 30, 3), (64, 200, 200, 1),
                                        (32, 1024, 64, 4), (7, 5, 11, 1)])
def test_grid_factorizations_and_words_match_jax(t, mb, nb, c):
    assert tdec.divisor_factorizations(t) == jdec.divisor_factorizations(t)
    assert tdec.sfc_grid_factorization(t, mb, nb, c) == jdec.sfc_grid_factorization(t, mb, nb, c)
    tm, tn = tdec.sfc_grid_factorization(t, mb, nb, c)
    for dtype_bytes in (2, 4):
        same(tdec.words_moved(mb * 128, nb * 128, 4096, tm, tn, c, dtype_bytes),
             jdec.words_moved(mb * 128, nb * 128, 4096, tm, tn, c, dtype_bytes))


GEMMS = [(256, 256, 256, 1, 1, 1), (512, 1024, 2048, 4, 2, 2), (1024, 512, 4096, 8, 4, 1),
         (768, 768, 1536, 2, 1, 4), (256, 2560, 2560, 1, 1, 1), (2048, 256, 512, 6, 2, 1)]


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("m,n,k,t,c,kbf", GEMMS)
def test_gemm_simulators_match_jax(m, n, k, t, c, kbf, calibrated):
    thw, jhw = hw_pair(calibrated)
    for bm, bn, dtype_bytes, mats in ((256, 256, 2, 1), (128, 256, 4, 2)):
        kw = dict(n_workers=t, k_layers=c, k_block_factor=kbf, bm=bm, bn=bn, dtype_bytes=dtype_bytes)
        same(tpm.simulate_gemm(m, n, k, hw=thw, n_b_mats=mats, **kw),
             jpm.simulate_gemm(m, n, k, hw=jhw, n_b_mats=mats, **kw))
        for opt in (None, "unfused", "fused"):
            same(tpm.simulate_train_gemm(m, n, k, hw=thw, optimizer=opt, **kw),
                 jpm.simulate_train_gemm(m, n, k, hw=jhw, optimizer=opt, **kw))
        same(tpm.shared_memory_floor(m, n, k, hw=thw, dtype_bytes=dtype_bytes, n_b_mats=mats),
             jpm.shared_memory_floor(m, n, k, hw=jhw, dtype_bytes=dtype_bytes, n_b_mats=mats))
        same(tpm.abft_overhead(m, n, k, bm=bm, bn=bn, k_block_factor=kbf, hw=thw, dtype_bytes=dtype_bytes,
                               n_b_mats=mats, n_workers=t),
             jpm.abft_overhead(m, n, k, bm=bm, bn=bn, k_block_factor=kbf, hw=jhw, dtype_bytes=dtype_bytes,
                               n_b_mats=mats, n_workers=t))
        same(tpm.vmem_excess_bytes(bm, bn, k // kbf, dtype_bytes=dtype_bytes, n_b_mats=mats, hw=thw),
             jpm.vmem_excess_bytes(bm, bn, k // kbf, dtype_bytes=dtype_bytes, n_b_mats=mats, hw=jhw))
    d = tdec.sfc_decompose(m // 256, n // 256, t, c)
    for p in d.patches[:3]:
        g = tpm.simulate_patch_traversal(p.cells, bm=256, bn=256, K=k, k_layers=c, k_block_factor=kbf, hw=thw,
                                         c_resident_bytes=2**20, n_b_mats=2)
        w = jpm.simulate_patch_traversal(p.cells, bm=256, bn=256, K=k, k_layers=c, k_block_factor=kbf, hw=jhw,
                                         c_resident_bytes=2**20, n_b_mats=2)
        same(g.as_dict(), w.as_dict())
        assert (g.total, g.nocache_bytes) == (w.total, w.nocache_bytes)


@pytest.mark.parametrize("m,n,k,t", [(512, 512, 512, 1), (1024, 4096, 2560, 8), (128, 151936, 2560, 16),
                                     (4096, 4096, 4096, 64), (300, 700, 900, 6)])
def test_rooflines_and_knob_choices_match_jax(m, n, k, t):
    for dtype_bytes in (2, 4):
        for tm, tn in tdec.divisor_factorizations(t)[:3]:
            for c in (1, 2):
                same(tpm.analytical_time(m, n, k, tm=tm, tn=tn, c=c, dtype_bytes=dtype_bytes),
                     jpm.analytical_time(m, n, k, tm=tm, tn=tn, c=c, dtype_bytes=dtype_bytes))
        same(tpm.roofline_best_time(m, n, k, t, dtype_bytes=dtype_bytes),
             jpm.roofline_best_time(m, n, k, t, dtype_bytes=dtype_bytes))
        same(tpm.train_roofline_time(m, n, k, t, dtype_bytes=dtype_bytes),
             jpm.train_roofline_time(m, n, k, t, dtype_bytes=dtype_bytes))
        assert tpm.choose_knobs_analytical(m, n, k, t, dtype_bytes=dtype_bytes) == jpm.choose_knobs_analytical(
            m, n, k, t, dtype_bytes=dtype_bytes)
    assert tpm.gemm_flops(m, n, k) == jpm.gemm_flops(m, n, k)
    assert tpm.backward_gemm_shapes(m, n, k) == jpm.backward_gemm_shapes(m, n, k)
    for opt_fused in (False, True):
        same(tpm.optimizer_update_bytes(k, n, fused=opt_fused), jpm.optimizer_update_bytes(k, n, fused=opt_fused))


def test_knob_autotune_and_the_nearest_neighbour_model_match_jax():
    shapes = [(512, 512, 512), (1024, 512, 2048), (256, 1024, 1024)]
    for m, n, k in shapes:
        got, want = tpm.choose_knobs_autotune(m, n, k, 4, bm=128, bn=128), jpm.choose_knobs_autotune(
            m, n, k, 4, bm=128, bn=128)
        assert got[0] == want[0]
        same(got[1], want[1])
    tnn = tpm.NearestNeighborModel().fit_autotuned(shapes, 4, bm=128, bn=128)
    jnn = jpm.NearestNeighborModel().fit_autotuned(shapes, 4, bm=128, bn=128)
    for q in [(600, 500, 500), (1000, 600, 1900), (200, 1200, 900)]:
        assert tnn.predict(*q) == jnn.predict(*q)
    with pytest.raises(RuntimeError):
        tpm.NearestNeighborModel().predict(1, 2, 3)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,qc,kc", [(1, 1, 1, 128, 128, 128, 64, 64), (4, 32, 8, 128, 128, 128, 64, 64),
                                                   (2, 8, 2, 300, 300, 64, 128, 64),
                                                   (1, 4, 4, 200, 520, 64, 64, 128)])
def test_attention_models_match_jax(b, h, hkv, sq, sk, d, qc, kc, calibrated):
    thw, jhw = hw_pair(calibrated)
    for causal in (True, False):
        for phase in ("fwd", "bwd"):
            kw = dict(q_chunk=qc, k_chunk=kc, causal=causal, phase=phase, hkv=hkv, dtype_bytes=2)
            same(tpm.simulate_flash_attention(b, h, sq, sk, d, hw=thw, **kw),
                 jpm.simulate_flash_attention(b, h, sq, sk, d, hw=jhw, **kw))
    for frac in (1.0, 0.3):
        same(tpm.simulate_decode_attention(b, h, hkv, sk, d, valid_frac=frac, hw=thw),
             jpm.simulate_decode_attention(b, h, hkv, sk, d, valid_frac=frac, hw=jhw))
    same(tpm.unfused_attention_bytes(b, h, sq, sk, d, hkv=hkv), jpm.unfused_attention_bytes(b, h, sq, sk, d, hkv=hkv))
    same(tpm.unfused_decode_attention_bytes(b, h, hkv, sk, d), jpm.unfused_decode_attention_bytes(b, h, hkv, sk, d))
    assert tpm.attention_phase_shapes(sq, sk, d, n_heads=h, cache_len=sk) == jpm.attention_phase_shapes(
        sq, sk, d, n_heads=h, cache_len=sk)
    assert tpm.attention_phase_shapes(sq, sk, d) == jpm.attention_phase_shapes(sq, sk, d)
    with pytest.raises(ValueError):
        tpm.simulate_flash_attention(b, h, sq, sk, d, q_chunk=qc, k_chunk=kc, phase="sideways")
