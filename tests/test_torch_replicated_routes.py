"""K4 / K5 (the replicated form's partial copies) on their Hopper routes,
the host side on the CPU: which kernel a call takes (`uses_cluster_kernel`,
`uses_replicated_wgmma_kernel`) by type, rows, alignment and slab; the
cluster kernel's split L' (`replicated_cluster_split`) as a pure function
of the shape and the SM count, `cluster_layers` at k_layers 1; the wgmma
kernel's task table at 128-row blocks against the JAX package's
`gemm_spec(mb, nb, k_layers)` table; the device's task -> (batch element,
layer, tile, K range) mapping, written again here and held to the
kernel's source, covering every copy's every tile once; and the plain
version at every sub-slab split against the JAX kernels in interpret
mode.  The kernels themselves run only on the card
(``tests/test_torch_kernels.py``, marked ``cuda``).

Tolerances: f32 rtol 1e-4 (atol 1e-5), the order of the f32 sums; bf16
inputs within one output rounding, 2^-7 relative (atol 1e-2 at these
magnitudes), as ``tests/test_torch_replicated.py`` holds the copies.
"""

import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402

H100_SMS = 132
BM = 128
CPU = torch.device("cpu")
WGMMA_SOURCE = Path(build.__file__).resolve().parent / "csrc" / "sfc_gemm_wgmma.cuh"
CU_SOURCE = WGMMA_SOURCE.with_name("sfc_gemm_fused.cu")
RTOL, ATOL = 1e-4, 1e-5
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# qwen3-4b's products of the replicated serve: (name, K, N); the GLU's two
# products share a shape
QWEN = {"q": (2560, 4096), "k,v": (2560, 1024), "o": (4096, 2560), "glu": (2560, 9728), "w_out": (9728, 2560),
        "head": (2560, 151936)}


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k_layers", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(QWEN))
def test_qwen3_serve_shapes_take_the_cluster_kernel_at_decode_and_the_wgmma_kernel_at_prefill(name, k_layers):
    """Every bf16 K4 of the serve (4 rows) takes the cluster kernel, every
    bf16 K5 (4 x 128 rows) the wgmma kernel: each slab of qwen3-4b at
    k_layers 1, 2, 4 and 8 is a whole number of 64-row steps; f32 takes
    neither."""
    k, n = QWEN[name]
    assert tk.layer_slab(k, k_layers) % build.WGMMA_BK == 0
    a4, w = _bf16(4, k), _bf16(k, n)
    assert tk.uses_cluster_kernel(a4) and not tk.uses_replicated_wgmma_kernel(a4, w, k_layers)
    a5 = _bf16(4, 128, k)
    assert not tk.uses_cluster_kernel(a5) and tk.uses_replicated_wgmma_kernel(a5, w, k_layers)
    assert not tk.uses_cluster_kernel(a4.float())
    assert not tk.uses_replicated_wgmma_kernel(a5.float(), w.float(), k_layers)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 130])
def test_rows_pick_the_route(m):
    """A bf16 plain-mode A of 1 to 16 rows takes the cluster kernel, past 16
    the wgmma kernel; a batched A always the wgmma kernel."""
    a, w = _bf16(m, 256), _bf16(256, 136)
    assert tk.uses_cluster_kernel(a) == (m <= build.SPLIT_MAX_ROWS)
    assert tk.uses_replicated_wgmma_kernel(a, w, 2) == (m > build.SPLIT_MAX_ROWS)
    assert tk.uses_replicated_wgmma_kernel(_bf16(3, m, 256), w, 2) and not tk.uses_cluster_kernel(_bf16(3, m, 256))


@pytest.mark.parametrize("k,n,k_layers,kbf,want", [
    (256, 136, 2, 1, True),  # slab 128: two whole steps
    (264, 136, 1, 1, True),  # one layer: its slab is all of K, TMA fills past it
    (264, 136, 2, 1, False),  # slab 132: the last stage would read the next layer's rows
    (200, 136, 2, 1, False),  # slab 100
    (256, 136, 2, 4, True),  # slab 4 x 32 = 128
    (203, 136, 1, 1, False),  # K not a multiple of 8: TMA cannot describe the rows
    (256, 133, 1, 1, False),  # N not a multiple of 8
    (512, 136, 8, 1, True),  # slab 64
    (512, 136, 16, 1, False),  # slab 32
    (448, 136, 4, 1, False),  # slab 112
])
def test_the_wgmma_route_takes_whole_slabs_and_rows_tma_can_describe(k, n, k_layers, kbf, want):
    assert tk.uses_replicated_wgmma_kernel(_bf16(2, 40, k), _bf16(k, n), k_layers, kbf) == want


def test_a_base_off_16_bytes_keeps_the_tile_kernel():
    """TMA needs 16-byte aligned bases: an A or B that starts one element
    into its storage is not taken by the wgmma route."""
    a, w = _bf16(2 * 40 * 256 + 8), _bf16(256 * 136 + 8)
    aligned_a, aligned_w = a[:2 * 40 * 256].view(2, 40, 256), w[:256 * 136].view(256, 136)
    off_a, off_w = a[1:2 * 40 * 256 + 1].view(2, 40, 256), w[1:256 * 136 + 1].view(256, 136)
    assert tk.uses_replicated_wgmma_kernel(aligned_a, aligned_w)
    assert not tk.uses_replicated_wgmma_kernel(off_a, aligned_w)
    assert not tk.uses_replicated_wgmma_kernel(aligned_a, off_w)


# ---------------------------------------------------------------------------
# the cluster kernel's split L'
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 16, 66, 108, 132, 264, 1000])
@pytest.mark.parametrize("k,n", [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560),
                                 (2560, 151936), (203, 133), (1000, 64), (0, 64), (7, 8)])
@pytest.mark.parametrize("k_layers,kbf", [(1, 1), (2, 1), (4, 2), (8, 1)])
def test_the_split_rule_holds_its_invariants_on_any_sm_count(sms, k, n, k_layers, kbf):
    """L' is a power of two, at most `MAX_CLUSTER_LAYERS`; every doubling it
    took left fewer than 1.5 CTAs an SM and a sub-slab of at least 256 rows;
    it stops at the first L' where one of those fails (or at the cap); and
    at k_layers 1 (kbf 1) it is `cluster_layers`, K1's L."""
    split = tk.replicated_cluster_split(k, n, k_layers, sms, kbf)
    nb = math.ceil(n / build.TILE[1])
    slab = tk.layer_slab(k, k_layers, kbf)
    assert 1 <= split <= build.MAX_CLUSTER_LAYERS and split & (split - 1) == 0
    if split > 1:
        half = split // 2
        assert 2 * nb * k_layers * half < 3 * sms and tk.layer_slab(slab, split) >= 256
    assert (split == build.MAX_CLUSTER_LAYERS or 2 * nb * k_layers * split >= 3 * sms
            or tk.layer_slab(slab, 2 * split) < 256)
    if k_layers == 1 and kbf == 1:
        assert split == tk.cluster_layers(k, n, sms)


def test_the_split_at_qwen3_shapes():
    """At k_layers 1 K1's L (q 4, k/v 8, o 8, the GLU's products 2, w_out 8,
    the head 1); at k_layers 8 one CTA a task at every shape."""
    got = {name: tk.replicated_cluster_split(k, n, 1, H100_SMS) for name, (k, n) in QWEN.items()}
    assert got == {"q": 4, "k,v": 8, "o": 8, "glu": 2, "w_out": 8, "head": 1}
    assert all(tk.replicated_cluster_split(k, n, 8, H100_SMS) == 1 for k, n in QWEN.values())


# ---------------------------------------------------------------------------
# the wgmma kernel's tasks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mb,nb,k_layers", [(1, 32, 1), (1, 8, 8), (1, 38, 2), (2, 3, 4), (3, 5, 1), (1, 1, 8)])
def test_the_replicated_table_at_128_row_blocks_is_jaxs(mb, nb, k_layers):
    """The device table (3, tiles) is the JAX package's
    `build_task_table(mb, nb, k_layers)` (gemm_spec's, layer-major, gilbert
    within a layer) byte for byte."""
    got = tk._device_layer_table.__wrapped__(mb, nb, k_layers, CPU).numpy()
    want = np.ascontiguousarray(jk.build_task_table(mb, nb, k_layers)[:3])
    assert got.dtype == want.dtype == np.int32 and got.tobytes() == want.tobytes()


# qwen3-4b's K5 (4 x 128 rows) on 132 SMs: (N, k_layers) -> (wide, mb, nb,
# CTAs, CTAs a worker)
LAUNCHES = {
    (4096, 1): (False, 1, 32, 128, 1),
    (1024, 1): (False, 1, 8, 32, 1),
    (2560, 1): (False, 1, 20, 80, 1),
    (9728, 1): (True, 1, 38, 132, 1),
    (4096, 8): (True, 1, 16, 132, 1),
    (1024, 8): (True, 1, 4, 128, 1),
    (151936, 1): (True, 1, 594, 132, 1),
}


@pytest.mark.parametrize("key", sorted(LAUNCHES))
def test_the_wgmma_launch_is_the_cost_rule_over_every_copy(key):
    n, k_layers = key
    cfg = tk.replicated_wgmma_launch(4, 128, n, k_layers, H100_SMS)
    assert tuple(cfg) == LAUNCHES[key]
    assert cfg == tk._wgmma_cost_rule(1, n, H100_SMS, False, 4 * k_layers, 1)
    # the plain mode is one batch element
    assert tk.replicated_wgmma_launch(0, 130, n, k_layers, H100_SMS) == tk._wgmma_cost_rule(
        2, n, H100_SMS, False, k_layers, 2)


def _rep_task(tab, t, tiles, tn, slab, k):
    """The kernel's replicated task mapping (csrc/sfc_gemm_wgmma.cuh:
    `task_tile`, `rep_task_slab`), written again: task t's batch element,
    C tile, layer and first K row and steps."""
    b = t // tiles
    j = t - b * tiles
    row0, col0, layer = int(tab[0, j]) * BM, int(tab[1, j]) * tn, int(tab[2, j])
    start = layer * slab
    depth = min(k - start, slab)
    steps = (depth + build.WGMMA_BK - 1) // build.WGMMA_BK if depth > 0 else 0
    return b, row0, col0, layer, start, steps


def test_the_kernels_replicated_task_mapping_is_written_as_mirrored():
    src = WGMMA_SOURCE.read_text()
    assert "b = t / p.tiles;" in src and "const int j = t - b * p.tiles;" in src
    assert "const int layer = __ldg(p.tab + 2 * p.tiles + (t - b * p.tiles));" in src
    assert "start = layer * slab;" in src and "const int depth = min(p.K - start, slab);" in src
    assert "steps = depth > 0 ? (depth + kBK - 1) / kBK : 0;" in src
    assert "const int k0 = (REP ? start : 0) + s * kBK;" in src
    assert "const size_t c_off = (static_cast<size_t>(b) * k_layers + layer) * p.M * p.N;" in src
    # the producer and the consumers both take the task's slab
    assert src.count("rep_task_slab(p, fl.slab, t, b, start, steps);") == 2
    assert "if (slab < 1 || (slab % wg::kBK != 0 && slab < K)) return kInvalid;" in CU_SOURCE.read_text()


@pytest.mark.parametrize("batch,m,k,n,k_layers,kbf", [
    (4, 128, 2560, 1024, 8, 1), (4, 128, 512, 4096, 1, 1), (3, 77, 256, 136, 2, 1), (1, 300, 264, 328, 1, 1),
    (2, 40, 512, 200, 4, 2), (2, 40, 1024, 136, 8, 4),
])
def test_the_replicated_tasks_cover_every_copys_tiles_once(batch, m, k, n, k_layers, kbf):
    """Walked by the launch's CTAs in their segments, the tasks cover every
    (batch element, copy, row, column) of the output once; each task's
    stages cover its layer's slab, clipped to K, and reach no row past it
    (a stage past the slab ends at K, where TMA fills zeros)."""
    slab = tk.layer_slab(k, k_layers, kbf)
    assert slab % build.WGMMA_BK == 0 or slab >= k
    cfg = tk.replicated_wgmma_launch(batch, m, n, k_layers, H100_SMS)
    tn = build.WGMMA_TILE[1] * (2 if cfg.wide else 1)
    tab = tk._device_layer_table.__wrapped__(cfg.mb, cfg.nb, k_layers, CPU).numpy()
    tiles = tab.shape[1]
    assert tiles == cfg.mb * cfg.nb * k_layers
    n_tasks = max(batch, 1) * tiles
    walked = []
    for w in range(cfg.ctas // cfg.group):
        lo, hi = tdec._block_ranges(n_tasks, cfg.ctas // cfg.group)[w]
        for c in range(cfg.group):
            walked += list(range(lo + c, hi, cfg.group))
    assert sorted(walked) == list(range(n_tasks))
    seen = np.zeros((max(batch, 1), k_layers, m, n), dtype=np.int64)
    for t in walked:
        b, row0, col0, layer, start, steps = _rep_task(tab, t, tiles, tn, slab, k)
        seen[b, layer, row0:row0 + BM, col0:col0 + tn] += 1
        rows = set(range(start, start + steps * build.WGMMA_BK))
        own = set(range(min(start, k), min(start + slab, k)))
        assert own <= rows and all(r >= k for r in rows - own)
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the plain version at every split against the JAX kernels
# ---------------------------------------------------------------------------


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _close(port, ref, dtype):
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(np.asarray(port.float(), np.float32), np.asarray(jnp.asarray(ref, jnp.float32)),
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("k_layers,kbf", [(1, 1), (2, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("mode", ["plain", "batched_shared", "batched_per_batch"])
def test_the_plain_version_at_every_split_matches_pallas(mode, k_layers, kbf, split, dtype):
    """The copies summed over `split` sub-slabs of each layer's slab (the
    cluster kernel's order) are the JAX kernels' copies: `sfc_gemm_pallas`
    for a plain A (4 rows, decode), `sfc_gemm_batched` for a batched one."""
    m, k, n = 4 if mode == "plain" else 8, 64, 16
    lead = () if mode == "plain" else (2,)
    a, b = _arrays(split, (*lead, m, k), (2, k, n) if mode == "batched_per_batch" else (k, n))
    kw = dict(bm=4, bn=8, k_layers=k_layers, k_block_factor=kbf)
    jfn = jk.sfc_gemm_pallas if mode == "plain" else jk.sfc_gemm_batched
    want = jfn(jnp.asarray(a, JDT[dtype]), jnp.asarray(b, JDT[dtype]), interpret=True, **kw)
    tdt = getattr(torch, dtype)
    got = tk.sfc_gemm_replicated_plain(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt), split=split, **kw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    _close(got, want, dtype)


@pytest.mark.parametrize("split", [2, 3, 8])
def test_the_plain_split_sums_the_sub_slabs_in_order(split):
    """With ``split`` the plain version sums f32 products of the sub-slabs
    [l * slab + r * sub, l * slab + (r + 1) * sub), clipped to the slab and
    to K (K 90, k_layers 2, kbf 4: slabs 48 and 42), in rank order (to f32
    rounding: a sub-slab boundary off by one row moves a copy by whole
    products)."""
    a, b = (torch.from_numpy(x) for x in _arrays(7, (5, 90), (90, 12)))
    got = tk.sfc_gemm_replicated_plain(a, b, bm=64, bn=64, k_layers=2, k_block_factor=4, split=split)
    slab = tk.layer_slab(90, 2, 4)
    sub = tk.layer_slab(slab, split)
    for layer in range(2):
        s_lo, s_hi = layer * slab, min((layer + 1) * slab, 90)
        want = torch.zeros(5, 12)
        for r in range(split):
            ks = slice(min(s_lo + r * sub, s_hi), min(s_lo + (r + 1) * sub, s_hi))
            want += a[:, ks] @ b[ks]
        torch.testing.assert_close(got[layer], want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="split"):
        tk.sfc_gemm_replicated_plain(a, b, bm=64, bn=64, split=0)


@pytest.mark.parametrize("shape", [(4, 512), (2, 40, 512)])
def test_cpu_tensors_still_run_the_plain_version(shape):
    """On the CPU the wrapper is the plain version (split 1) bitwise, for
    the cluster and the wgmma routes' operands alike, and counts nothing."""
    a, b = (torch.from_numpy(x).bfloat16() for x in _arrays(8, shape, (512, 136)))
    counts = (tk.sfc_gemm_replicated.launches, dict(tk.sfc_gemm_replicated.launches_by_kernel))
    got = tk.sfc_gemm_replicated(a, b, k_layers=2)
    want = tk.sfc_gemm_replicated_plain(a, b, bm=64, bn=64, k_layers=2)
    assert torch.equal(got, want)
    assert (tk.sfc_gemm_replicated.launches, dict(tk.sfc_gemm_replicated.launches_by_kernel)) == counts


def test_the_new_entries_are_in_the_bf16_replicated_part_only():
    """The cluster and wgmma entries are the bf16 replicated part's (no part
    is added), the f32 part holds neither, and K1's cluster kernel and K4's
    compile the one split-K main loop and reduction."""
    parts = dict(build._gemm_parts())
    for kind in ("cluster", "wgmma"):
        flag = f"-DSFC_REP_{kind.upper()}_ENTRY={build.rep_entry_name(kind, 'bf16')}"
        assert flag in parts["sfc_gemm_rep_bf16"]
        assert not any(f.startswith(f"-DSFC_REP_{kind.upper()}_ENTRY") for f in parts["sfc_gemm_rep_f32"])
        with pytest.raises(ValueError):
            build.rep_entry_name(kind, "f32")
    assert build.rep_entry_name("cluster", "bf16") == "sfc_gemm_replicated_cluster_bf16"
    assert build.rep_entry_name("wgmma", "bf16") == "sfc_gemm_replicated_wgmma_bf16"
    src = CU_SOURCE.read_text()
    assert src.count("__device__ __forceinline__ void split_mainloop(") == 1
    assert src.count("__device__ __forceinline__ bool cluster_sum(") == 1
    assert "#if SFC_DTYPE == 1 && (defined(SFC_CLUSTER_ENTRY) || defined(SFC_REP_CLUSTER_ENTRY))" in src
    assert src.count("split_mainloop<") == 2 and src.count("cluster_sum<") == 2
