"""K3 and K9 on the wgmma kernels, their host side on the CPU: the grouped
task table at the kernels' 128-row blocks against the JAX package's; the
device's task -> (expert, first row, row end) mapping, written again here
and held to the kernel's source, covering every expert's rows once; the
launch configuration (`grouped_wgmma_launch`) as a pure function of the
group sizes, the width, the SM count and the GLU form; the dispatch
predicates; and the plain versions of K3 (every epilogue form and the ABFT
lane) and K9 (single and dual) at the kernels' tiles (128 rows; 128 or 256
columns, the GLU's 64 or 128) against the JAX kernels in interpret mode,
on expert sizes that are not multiples of 128 with an empty expert and one
over 128 rows.  The kernels themselves run only on the card
(``tests/test_torch_kernels.py``, marked ``cuda``).

Tolerances: f32 rtol 1e-4 (atol 1e-5); bf16 inputs within one output
rounding, ``2^-7 |ref| + 1e-3 max|ref|`` (both sides accumulate in f32 and
round once, in different orders); the lane as `_lane_close` of
tests/test_torch_abft.py holds it (rtol 1e-4, atol 1e-6 of the operand
magnitude).
"""

import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.robust import abft  # noqa: E402

H100_SMS = 132
BM = 128
WGMMA_SOURCE = Path(build.__file__).resolve().parent / "csrc" / "sfc_gemm_wgmma.cuh"
RTOL, ATOL = 1e-4, 1e-5
CPU = torch.device("cpu")

# ragged expert sizes: one expert empty, one over 128 rows, none a multiple of 128
RAGGED = [(80, 0, 45, 130), (5, 0, 19, 32)]


def _blocks(gs):
    return [math.ceil(g / BM) for g in gs]


@pytest.mark.parametrize("gs", RAGGED + [(32,) * 64, (80,) * 64, (0, 300, 1), (128, 129)])
@pytest.mark.parametrize("nb", [1, 4, 16])
def test_the_grouped_table_at_128_row_blocks_is_jaxs(gs, nb):
    """The device table of the wgmma kernels is the JAX package's
    `build_grouped_task_table` over each expert's ceil(rows / 128) blocks,
    byte for byte; the (3, E) row array holds each expert's first row, its
    rows and its first 128-row block."""
    got = tk._device_grouped_table.__wrapped__(gs, BM, nb, CPU).numpy()
    want = jk.build_grouped_task_table(_blocks(gs), nb)
    assert got.dtype == want.dtype == np.int32 and got.tobytes() == want.tobytes()
    grp = tk._device_groups.__wrapped__(gs, BM, CPU).numpy()
    assert grp.dtype == np.int32 and grp.shape == (3, len(gs))
    assert grp[0].tolist() == np.concatenate([[0], np.cumsum(gs)[:-1]]).tolist()
    assert grp[1].tolist() == list(gs)
    assert grp[2].tolist() == np.concatenate([[0], np.cumsum(_blocks(gs))[:-1]]).tolist()


def _task_tile(tab, grp, t, tn):
    """The kernel's grouped `task_tile` (csrc/sfc_gemm_wgmma.cuh), written
    again: task t's expert, first output row and column, and row end."""
    tiles, n_groups = tab.shape[1], grp.shape[1]
    flat_tab, flat_grp = tab.reshape(-1), grp.reshape(-1)
    b = int(flat_tab[2 * tiles + t])
    start = int(flat_grp[b])
    row0 = start + (int(flat_tab[t]) - int(flat_grp[2 * n_groups + b])) * BM
    col0 = int(flat_tab[tiles + t]) * tn
    row_end = start + int(flat_grp[n_groups + b])
    return b, row0, col0, row_end


def test_the_kernels_grouped_task_mapping_is_written_as_mirrored():
    """The kernel's source computes the task's tile as `_task_tile` does,
    masks its rows at the row end, writes at the packed rows with the
    expert's bias rows, and reads A at batch 0 and B at the expert."""
    src = WGMMA_SOURCE.read_text()
    assert "b = __ldg(p.tab + 2 * p.tiles + t);" in src
    assert "const int start = __ldg(p.grp + b);" in src
    assert "row0 = start + (__ldg(p.tab + t) - __ldg(p.grp + 2 * p.n_groups + b)) * kBM;" in src
    assert "col0 = __ldg(p.tab + p.tiles + t) * TN;" in src
    assert "row_end = start + __ldg(p.grp + p.n_groups + b);" in src
    assert "if (gr >= row_end || gc >= p.N) return;" in src
    assert "const long long c_off = GROUPED ? 0 : static_cast<long long>(b) * p.M * p.N;" in src
    assert "const int vec_off = GROUPED ? b * p.N : 0;" in src
    assert "x += __bfloat162float(p.bias[vec_off + gc + e]);" in src
    assert "gg += __bfloat162float(p.gbias[vec_off + gc + e]);" in src
    assert "const int bb = GROUPED || p.b_batched ? b : 0;" in src
    assert "tma_load(st, pair ? &tm_a2 : &tm_a, &full[stage], k0, row0, GROUPED ? 0 : b);" in src
    assert "tma_load(sb, pair ? &tm_b2 : &tm_b, &full[stage], k0, col0, GROUPED ? bb : 0);" in src
    # both the producer's and the consumers' walk take the grouped tile
    assert src.count("task_tile<TN, GROUPED>(p, t, b, row0, col0, row_end);") == 2


@pytest.mark.parametrize("gs", RAGGED + [(32,) * 8, (0, 300, 1), (128, 129, 0)])
@pytest.mark.parametrize("n,tn", [(136, 64), (136, 128), (1000, 256)])
def test_the_grouped_tasks_cover_every_experts_rows_once(gs, n, tn):
    """Every (row, column tile) of every expert is one task's, inside the
    task's own expert; a task starts inside its expert and at most 128
    rows before its row end, and no task belongs to an empty expert."""
    nb = math.ceil(n / tn)
    tab = tk._device_grouped_table.__wrapped__(gs, BM, nb, CPU).numpy()
    grp = tk._device_groups.__wrapped__(gs, BM, CPU).numpy()
    starts = np.concatenate([[0], np.cumsum(gs)[:-1]])
    seen = np.zeros((sum(gs), nb), dtype=np.int64)
    for t in range(tab.shape[1]):
        e, row0, col0, row_end = _task_tile(tab, grp, t, tn)
        assert gs[e] > 0 and row_end == starts[e] + gs[e]
        assert starts[e] <= row0 < row_end and (row0 - starts[e]) % BM == 0
        assert col0 % tn == 0 and col0 < n
        seen[row0:min(row0 + BM, row_end), col0 // tn] += 1
    assert (seen == 1).all()


# olmoe-1b-7b's expert products on 132 SMs: (group sizes, output cols,
# GLU) -> (wide, row blocks, column tiles, CTAs, CTAs a worker); decode 32
# rows an expert, prefill and training 80, the K9 dA's output cols the
# forward's K
LAUNCHES = {
    "decode/glu": (((32,) * 64, 1024, True), (True, 64, 8, 132, 1)),
    "decode/w_out": (((32,) * 64, 2048, False), (True, 64, 8, 132, 1)),
    "prefill/glu": (((80,) * 64, 1024, True), (True, 64, 8, 132, 1)),
    "train/w_out": (((80,) * 64, 2048, False), (True, 64, 8, 132, 1)),
    "train/glu_da": (((80,) * 64, 2048, False), (True, 64, 8, 132, 1)),
    "train/w_out_da": (((80,) * 64, 1024, False), (True, 64, 4, 132, 1)),
    "ragged": (((80, 0, 45, 130), 136, True), (False, 4, 3, 12, 1)),
    "long_experts": (((600, 700), 4096, False), (True, 11, 16, 132, 4)),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_grouped_wgmma_launch_at_olmoes_shapes(name):
    (gs, n, glu), want = LAUNCHES[name]
    cfg = tk.grouped_wgmma_launch(gs, n, H100_SMS, glu)
    assert tuple(cfg) == want
    assert cfg.mb == sum(_blocks(gs)) and (cfg.mb, cfg.nb) == (cfg.mb, tk.wgmma_grid(1, n, glu, cfg.wide)[1])


@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("sms", [1, 7, 78, 132])
@pytest.mark.parametrize("gs,n", [((5, 0, 19, 32), 8), ((80, 0, 45, 130), 136), ((32,) * 64, 1024),
                                  ((80,) * 64, 2048), ((0, 1000, 3), 4096)])
def test_grouped_wgmma_launch_holds_its_invariants_on_any_card(gs, n, sms, glu):
    """At most one CTA an SM and a task a CTA, whole worker groups of at
    most the largest expert's row blocks, a group only where a CTA has more
    than one task; the column tiles cover the output; the dense rule's
    answer for one expert; the same configuration every call."""
    cfg = tk.grouped_wgmma_launch(gs, n, sms, glu)
    cols = 128 * (2 if cfg.wide else 1) // (2 if glu else 1)
    tasks = cfg.mb * cfg.nb
    assert cfg.mb == sum(_blocks(gs)) and (cfg.nb - 1) * cols < n <= cfg.nb * cols
    assert 1 <= cfg.ctas <= min(sms, tasks) and cfg.ctas % cfg.group == 0
    assert cfg.group == (min(4, max(_blocks(gs)), sms) if tasks > min(sms, tasks) else 1)
    assert tk.grouped_wgmma_launch(gs, n, sms, glu) == cfg
    one = max(gs)
    assert tk.grouped_wgmma_launch((one,), n, sms, glu) == tk.wgmma_launch(one, n, sms, glu)
    with pytest.raises(ValueError):
        tk.grouped_wgmma_launch((0, 0), n, sms, glu)


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose base lies 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(math.prod(shape) + 8, dtype=dtype)
    return flat[1:1 + math.prod(shape)].view(shape)


def test_the_grouped_predicates_are_type_rows_and_alignment():
    """bf16 with K and N multiples of 8 and every operand 16-byte aligned
    takes the wgmma kernels; f32, K 203, N 133 and a base off a 16-byte
    boundary keep the tile kernels."""
    bf = torch.bfloat16
    a, w = torch.zeros(2048, 2048, dtype=bf), torch.zeros(64, 2048, 1024, dtype=bf)
    assert tk.uses_grouped_wgmma_kernel(a, w) and tk.uses_grouped_wgmma_kernel(a, w, w.clone())
    assert tk.uses_grouped_wgmma_kernel(torch.zeros(56, 264, dtype=bf), torch.zeros(4, 264, 328, dtype=bf))
    assert not tk.uses_grouped_wgmma_kernel(a.float(), w.float())
    assert not tk.uses_grouped_wgmma_kernel(torch.zeros(56, 203, dtype=bf), torch.zeros(4, 203, 328, dtype=bf))
    assert not tk.uses_grouped_wgmma_kernel(torch.zeros(56, 264, dtype=bf), torch.zeros(4, 264, 133, dtype=bf))
    assert not tk.uses_grouped_wgmma_kernel(_misaligned((2048, 2048)), w)
    assert not tk.uses_grouped_wgmma_kernel(a, _misaligned((64, 2048, 1024)))
    assert not tk.uses_grouped_wgmma_kernel(a, w, _misaligned((64, 2048, 1024)))
    dc, wt = torch.zeros(5120, 1024, dtype=bf), torch.zeros(64, 2048, 1024, dtype=bf)
    assert tk.uses_grouped_nt_wgmma_kernel(dc, wt) and tk.uses_grouped_nt_wgmma_kernel(dc, wt, dc.clone(), wt)
    assert tk.uses_grouped_nt_wgmma_kernel(torch.zeros(56, 264, dtype=bf), torch.zeros(4, 133, 264, dtype=bf))
    assert not tk.uses_grouped_nt_wgmma_kernel(dc.float(), wt.float())
    assert not tk.uses_grouped_nt_wgmma_kernel(torch.zeros(56, 203, dtype=bf), torch.zeros(4, 133, 203, dtype=bf))
    assert not tk.uses_grouped_nt_wgmma_kernel(dc, wt, dc.clone(), _misaligned((64, 2048, 1024)))
    assert not tk.uses_grouped_nt_wgmma_kernel(_misaligned((5120, 1024)), wt)


def test_cpu_tensors_still_run_the_plain_versions_and_count_nothing():
    """On the CPU the grouped wrappers run their plain versions whatever the
    predicates say, and count nothing, by kernel or otherwise."""
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    gs = (7, 0, 33)
    x = torch.randn(40, 64, generator=gen).to(bf)
    w = (torch.randn(3, 64, 136, generator=gen) * 0.1).to(bf)
    assert tk.uses_grouped_wgmma_kernel(x, w) and tk.uses_grouped_nt_wgmma_kernel(x, w.transpose(1, 2).contiguous())
    fns = (tk.sfc_gemm_grouped, tk.sfc_gemm_grouped_nt)
    before = [(f.launches, dict(f.launches_by_shape), dict(f.launches_by_kernel)) for f in fns]
    out = tk.sfc_gemm_grouped(x, w, group_sizes=gs, activation="relu")
    da = tk.sfc_gemm_grouped_nt(out, w, group_sizes=gs)
    assert torch.equal(out, tk.sfc_gemm_grouped_plain(x, w, group_sizes=gs, activation="relu", bm=64, bn=64))
    assert torch.equal(da, tk.sfc_gemm_grouped_nt_plain(out, w, group_sizes=gs, bm=64, bn=64))
    assert before == [(f.launches, dict(f.launches_by_shape), dict(f.launches_by_kernel)) for f in fns]


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [None if s is None else (rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _pair(x, dtype):
    """(torch tensor, jax array) holding the same values in ``dtype``."""
    if x is None:
        return None, None
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


def _close(got, want, dtype):
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    else:
        bound = 2.0**-7 * np.abs(w) + 1e-3 * np.abs(w).max()
        assert np.all(np.abs(g - w) <= bound), float(np.max(np.abs(g - w) - bound))


def _pad_rows(x, gs, cols):
    """The JAX kernels' packing: each expert's rows padded to a multiple of
    128 (an empty expert takes none), the columns padded to ``cols``."""
    slabs, off = [], 0
    for g in gs:
        if g:
            slabs.append(jnp.zeros((-(-g // BM) * BM, cols), x.dtype).at[:g, :x.shape[1]].set(x[off:off + g]))
        off += g
    return jnp.concatenate(slabs), tuple(_blocks(gs))


def _unpad_rows(out, gs, n):
    parts, off = [], 0
    for g in gs:
        parts.append(np.asarray(out[off:off + g, :n], np.float32))
        off += -(-g // BM) * BM
    return np.concatenate(parts)


K, N = 72, 136
FORMS = {"linear": {}, "glu_silu": dict(activation="silu"), "glu_preact": dict(preact=True),
         "bias_relu_scaled": dict(activation="relu", out_scale=0.5)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gs", RAGGED)
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_grouped_at_the_kernels_tile_matches_jax(form, wide, gs, dtype):
    """K3's plain version at the wgmma kernel's tile (128 rows; 128 or 256
    columns, the GLU's 64 or 128) against JAX ``sfc_gemm_grouped`` in
    interpret mode at the same tile, N padded on the JAX side only: every
    epilogue form the MoE path and its VJP use."""
    glu = form.startswith("glu")
    bn = 128 * (2 if wide else 1) // (2 if glu else 1)
    e, t = len(gs), sum(gs)
    a, b, bg, bias, gbias = _arrays(t + bn, (t, K), (e, K, N), (e, K, N) if glu else None,
                                    (e, N) if form != "linear" else None, (e, N) if form == "glu_preact" else None,
                                    scale=1.0)
    (ta, ja), (tb, jb), (tbg, jbg), (tbias, jbias), (tgbias, jgbias) = (_pair(x, dtype) for x in (a, b, bg, bias, gbias))
    kw = FORMS[form]
    np_ = -(-N // bn) * bn
    a_p, row_blocks = _pad_rows(ja, gs, K)
    pad_w = (lambda w: None if w is None else jnp.pad(w, ((0, 0), (0, 0), (0, np_ - N))))
    pad_vec = (lambda v: None if v is None else jnp.pad(v, ((0, 0), (0, np_ - N))).reshape(e, 1, np_))
    want = jk.sfc_gemm_grouped(a_p, pad_w(jb), pad_w(jbg), pad_vec(jbias), pad_vec(jgbias), row_blocks=row_blocks,
                               bm=BM, bn=bn, interpret=True, preact_out=kw.get("preact", False),
                               activation=kw.get("activation"), out_scale=kw.get("out_scale"))
    got = tk.sfc_gemm_grouped_plain(ta, tb, tbg, tbias, tgbias, group_sizes=gs, bm=BM, bn=bn, **kw)
    preact = kw.get("preact", False)
    for g, w in zip(got if preact else [got], want if preact else [want]):
        assert g.dtype == getattr(torch, dtype)
        _close(g, _unpad_rows(w, gs, N), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gs", RAGGED)
@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("dual", [False, True])
def test_plain_grouped_nt_at_the_kernels_tile_matches_jax(dual, bn, gs, dtype):
    """K9's plain version at the wgmma kernel's tile (128 rows, 128 or 256
    columns) against JAX ``sfc_gemm_grouped_nt`` in interpret mode: dA[rows
    of e] = dC_e @ W[e]ᵀ (+ the dual GLU pair), W read as stored (E, N, K)."""
    e, t = len(gs), sum(gs)
    a, b, a2, b2 = _arrays(t + bn + 1, (t, K), (e, N, K), (t, K) if dual else None, (e, N, K) if dual else None)
    (ta, ja), (tb, jb), (ta2, ja2), (tb2, jb2) = (_pair(x, dtype) for x in (a, b, a2, b2))
    np_ = -(-N // bn) * bn
    a_p, row_blocks = _pad_rows(ja, gs, K)
    a2_p = _pad_rows(ja2, gs, K)[0] if dual else None
    pad_w = (lambda w: None if w is None else jnp.pad(w, ((0, 0), (0, np_ - N), (0, 0))))
    want = jk.sfc_gemm_grouped_nt(a_p, pad_w(jb), a2_p, pad_w(jb2), row_blocks=row_blocks, bm=BM, bn=bn,
                                  interpret=True)
    got = tk.sfc_gemm_grouped_nt_plain(ta, tb, ta2, tb2, group_sizes=gs, bm=BM, bn=bn)
    assert got.shape == (t, N) and got.dtype == getattr(torch, dtype)
    _close(got, _unpad_rows(want, gs, N), dtype)


@pytest.mark.parametrize("gs", RAGGED)
@pytest.mark.parametrize("form", ["linear", "glu_silu", "glu_preact"])
def test_plain_grouped_lane_at_the_kernels_tile_matches_jax(form, gs):
    """K3's checksum lane at the wgmma kernel's 128-row tile against the
    JAX kernel's at the same tile (its rows padded with zeros that add
    nothing), within the lane tolerance of tests/test_torch_abft.py; the
    outputs with the lane are those without it."""
    glu = form.startswith("glu")
    bn = 64 if glu else 128
    e, t = len(gs), sum(gs)
    a, b, bg = _arrays(7 + t, (t, K), (e, K, N), (e, K, N) if glu else None)
    (ta, ja), (tb, jb), (tbg, jbg) = (_pair(x, "float32") for x in (a, b, bg))
    kw = FORMS[form]
    np_ = -(-N // bn) * bn
    a_p, row_blocks = _pad_rows(ja, gs, K)
    pad_w = (lambda w: None if w is None else jnp.pad(w, ((0, 0), (0, 0), (0, np_ - N))))
    want = jk.sfc_gemm_grouped(a_p, pad_w(jb), pad_w(jbg), row_blocks=row_blocks, bm=BM, bn=bn, interpret=True,
                               abft=True, preact_out=kw.get("preact", False), activation=kw.get("activation"))
    got = tk.sfc_gemm_grouped_plain(ta, tb, tbg, group_sizes=gs, bm=BM, bn=bn, abft=True, **kw)
    off = tk.sfc_gemm_grouped_plain(ta, tb, tbg, group_sizes=gs, bm=BM, bn=bn, **kw)
    rows = np.split(a, np.cumsum(gs)[:-1])
    mag = sum(float(abft.gemm_checksum_ref(torch.from_numpy(r), torch.from_numpy(b[i]),
                                           None if bg is None else torch.from_numpy(bg[i]))[1])
              for i, r in enumerate(rows))
    np.testing.assert_allclose(float(got[-1]), float(want[-1]), rtol=1e-4, atol=1e-6 * mag)
    for g, o in zip(got[:-1], off if isinstance(off, tuple) else (off,)):
        assert torch.equal(g, o)
