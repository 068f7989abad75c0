"""The wgmma kernels' host side against the JAX package and as pure
functions of the shape: the blockwise split of the curve over workers
(`partition_curve`, ported), the kernel's on-device segment formula, the
task tables of their C-tile grids, the launch configuration (tile grid and
split of K) and the dispatch predicates.  The kernels themselves run only
on the card (``tests/test_torch_kernels.py``, marked ``cuda``)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import decomposition as jdec  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro_torch.core import decomposition as tdec  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402

H100_SMS = 132
WGMMA_SOURCE = Path(build.__file__).resolve().parent / "csrc" / "sfc_gemm_wgmma.cuh"


@pytest.mark.parametrize("mb,nb,workers", [
    (1, 1, 1), (4, 32, 128), (4, 8, 32), (4, 20, 33), (4, 152, 132), (4, 1187, 132),  # the main path's
    (4, 20, 16), (4, 76, 132), (3, 5, 7), (2, 3, 10), (1, 1, 4), (5, 7, 35), (7, 11, 6),  # ragged, workers > tasks
])
def test_partition_curve_is_the_jax_packages(mb, nb, workers):
    assert tdec.partition_curve(mb, nb, workers) == jdec.partition_curve(mb, nb, workers)


@pytest.mark.parametrize("n_items", [0, 1, 7, 32, 80, 131, 132, 133, 608, 4748])
@pytest.mark.parametrize("n_workers", [1, 3, 16, 33, 132, 200])
def test_block_ranges_are_the_jax_packages(n_items, n_workers):
    assert tdec._block_ranges(n_items, n_workers) == jdec._block_ranges(n_items, n_workers)


def _segment(n_tasks: int, n_workers: int, w: int):
    """The kernel's `segment` (csrc/sfc_gemm_wgmma.cuh), written again."""
    base, rem = n_tasks // n_workers, n_tasks % n_workers
    lo = w * base + min(w, rem)
    return lo, lo + base + (1 if w < rem else 0)


def _cta_tasks(n_tasks: int, ctas: int, group: int, cta: int):
    """The tasks of one CTA (csrc/sfc_gemm_wgmma.cuh, written again): its
    worker, CTAs [group (cta // group), ...), walks `segment` of the tasks,
    its CTAs taking them in turn."""
    lo, hi = _segment(n_tasks, ctas // group, cta // group)
    return list(range(lo + cta % group, hi, group))


def test_the_kernels_segment_formula_is_written_as_mirrored():
    src = WGMMA_SOURCE.read_text()
    assert "const int base = n_tasks / n_workers, rem = n_tasks % n_workers;" in src
    assert "lo = w * base + min(w, rem);" in src
    assert "hi = lo + base + (w < rem ? 1 : 0);" in src
    # the workers are groups of p.group CTAs of the launch, taking the tasks in turn
    assert "segment(p.n_tasks, gridDim.x / p.group, blockIdx.x / p.group, t_lo, t_hi);" in src
    assert "const int t_first = t_lo + blockIdx.x % p.group;" in src
    assert src.count("for (int t = t_first; t < t_hi; t += p.group) {") == 2  # the producer's and the consumers'


@pytest.mark.parametrize("n_tasks,n_workers", [(1, 1), (32, 32), (80, 33), (80, 16), (128, 128), (608, 132),
                                               (4748, 132), (304, 132), (7, 3), (5, 5)])
def test_the_device_segments_are_the_blockwise_split(n_tasks, n_workers):
    """Every worker's range from (n_tasks, workers, its index) alone is the
    JAX package's `_block_ranges`: contiguous, balanced, covering every task
    once in curve order."""
    ranges = [_segment(n_tasks, n_workers, w) for w in range(n_workers)]
    assert ranges == jdec._block_ranges(n_tasks, n_workers)
    assert [t for lo, hi in ranges for t in range(lo, hi)] == list(range(n_tasks))
    assert max(hi - lo for lo, hi in ranges) - min(hi - lo for lo, hi in ranges) <= 1


@pytest.mark.parametrize("n_tasks,ctas,group", [(2376, 132, 4), (304, 132, 2), (80, 80, 1), (9, 8, 4), (5, 4, 2)])
def test_a_workers_ctas_take_its_segment_in_turn(n_tasks, ctas, group):
    """Every task is one CTA's, the CTAs of a worker interleave its
    contiguous segment (consecutive tasks run at once on `group` CTAs), and
    no CTA holds more than one task over its share."""
    per_cta = [_cta_tasks(n_tasks, ctas, group, c) for c in range(ctas)]
    assert sorted(t for ts in per_cta for t in ts) == list(range(n_tasks))
    for w in range(ctas // group):
        lo, hi = jdec._block_ranges(n_tasks, ctas // group)[w]
        mine = per_cta[w * group:(w + 1) * group]
        assert sorted(t for ts in mine for t in ts) == list(range(lo, hi))
    assert max(map(len, per_cta)) <= -(-n_tasks // ctas) + 1


# qwen3-4b's 512 token rows (4 x 128 prefill, 2 x 256 training): (rows,
# output cols, GLU) -> the tile (wide?), the grid (mb, nb), the CTAs on 132
# SMs and the CTAs of a worker; the forward's q, k/v, o, GLU, w_out and LM
# head, then the NT dA of the same projections (its output cols are the
# forward's K)
LAUNCHES = {
    "q": ((512, 4096, False), (False, 4, 32, 128, 1)),
    "k,v": ((512, 1024, False), (False, 4, 8, 32, 1)),
    "o": ((512, 2560, False), (False, 4, 20, 80, 1)),
    "glu": ((512, 9728, True), (True, 4, 76, 132, 4)),
    "w_out": ((512, 2560, False), (False, 4, 20, 80, 1)),
    "head": ((512, 151936, False), (True, 4, 594, 132, 4)),
    "nt/q, k,v, glu, head": ((512, 2560, False), (False, 4, 20, 80, 1)),
    "nt/o": ((512, 4096, False), (False, 4, 32, 128, 1)),
    "nt/w_out": ((512, 9728, False), (True, 4, 38, 132, 4)),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_wgmma_launch_is_a_function_of_the_shape_and_the_card(name):
    """The tile, its grid, the CTAs and the CTAs of a worker at qwen3-4b's
    512-row products: the wide tile only where its tiles still fill the 132
    SMs, groups of 4 CTAs only where a CTA has more than one tile."""
    (rows, n, glu), want = LAUNCHES[name]
    cfg = tk.wgmma_launch(rows, n, H100_SMS, glu)
    assert tuple(cfg) == want
    assert (cfg.mb, cfg.nb) == tk.wgmma_grid(rows, n, glu, cfg.wide)


@pytest.mark.parametrize("sms", [1, 8, 78, 114, 132])
@pytest.mark.parametrize("rows,n,glu,batch", [(1, 8, False, 1), (17, 2560, False, 1), (512, 151936, False, 1),
                                              (200, 328, True, 1), (77, 328, False, 3), (4096, 4096, True, 1)])
def test_wgmma_launch_holds_its_invariants_on_any_card(sms, rows, n, glu, batch):
    """At most one CTA an SM and a task a CTA, whole worker groups; the
    grid covers the output; the same configuration every call."""
    cfg = tk.wgmma_launch(rows, n, sms, glu, batch)
    bm, bn = build.WGMMA_TILE
    cols = bn * (2 if cfg.wide else 1) // (2 if glu else 1)
    tasks = batch * cfg.mb * cfg.nb
    assert 1 <= cfg.ctas <= min(sms, tasks) and cfg.ctas % cfg.group == 0
    assert cfg.group == (min(4, cfg.mb, sms) if tasks > min(sms, tasks) else 1)
    assert (cfg.mb - 1) * bm < rows <= cfg.mb * bm and (cfg.nb - 1) * cols < n <= cfg.nb * cols
    assert tk.wgmma_launch(rows, n, sms, glu, batch) == cfg
    narrow = tk.wgmma_grid(rows, n, glu)
    if batch * narrow[0] * narrow[1] <= sms:  # the narrow tiles do not fill the card: never the wide one
        assert not cfg.wide


@pytest.mark.parametrize("grid", sorted({(w[1], w[2]) for _, w in LAUNCHES.values()}
                                        | {(4, 16), (4, 1), (4, 393), (2, 3)}))
def test_wgmma_task_tables_are_the_jax_packages(grid):
    """The wgmma kernels walk `compile_schedule(gemm_spec(mb, nb))` over
    their own tile grid (qwen3-4b's main-path grids; olmoe-1b-7b's 2048-wide
    projections, router and LM head; a ragged one): byte-identical to the
    JAX package's table."""
    j = jsched.compile_schedule(jsched.gemm_spec(*grid)).table
    t = tsched.compile_schedule(tsched.gemm_spec(*grid)).table
    assert t.dtype == j.dtype == np.int32 and t.tobytes() == j.tobytes()
    assert tk._device_table.__wrapped__(*grid, torch.device("cpu")).numpy().tobytes() == j[:2].tobytes()


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(math.prod(shape) + 8, dtype=dtype)
    return flat[1:1 + math.prod(shape)].view(shape)


def test_uses_wgmma_kernel_is_type_rows_and_alignment():
    bf = torch.bfloat16
    a3, a2 = torch.zeros(4, 128, 2560, dtype=bf), torch.zeros(512, 2560, dtype=bf)
    w, wg = torch.zeros(2560, 4096, dtype=bf), torch.zeros(2560, 4096, dtype=bf)
    assert tk.uses_wgmma_kernel(a3, w) and tk.uses_wgmma_kernel(a3, w, wg) and tk.uses_wgmma_kernel(a2, w)
    assert tk.uses_wgmma_kernel(torch.zeros(3, 77, 264, dtype=bf), torch.zeros(3, 264, 328, dtype=bf))
    assert tk.uses_wgmma_kernel(torch.zeros(17, 2560, dtype=bf), w)  # past the cluster kernel's rows
    assert tk.uses_wgmma_kernel(torch.zeros(2, 1, 2560, dtype=bf), w)  # batched: never the cluster kernel
    assert not tk.uses_wgmma_kernel(torch.zeros(16, 2560, dtype=bf), w)  # the cluster kernel's
    assert not tk.uses_wgmma_kernel(a3.float(), w.float())  # f32
    assert not tk.uses_wgmma_kernel(torch.zeros(3, 77, 203, dtype=bf), torch.zeros(203, 328, dtype=bf))  # K % 8
    assert not tk.uses_wgmma_kernel(a3, torch.zeros(2560, 4100, dtype=bf))  # N % 8
    assert not tk.uses_wgmma_kernel(_misaligned((4, 128, 2560)), w)
    assert not tk.uses_wgmma_kernel(a3, _misaligned((2560, 4096)))
    assert not tk.uses_wgmma_kernel(a3, w, _misaligned((2560, 4096)))
    assert not tk.uses_wgmma_kernel(torch.zeros(4, 128, 0, dtype=bf), torch.zeros(0, 4096, dtype=bf))  # no K


def test_uses_nt_wgmma_kernel_is_type_rows_and_alignment():
    bf = torch.bfloat16
    dc, w = torch.zeros(512, 9728, dtype=bf), torch.zeros(2560, 9728, dtype=bf)
    assert tk.uses_nt_wgmma_kernel(dc, w) and tk.uses_nt_wgmma_kernel(dc, w, dc.clone(), w.clone())
    assert tk.uses_nt_wgmma_kernel(torch.zeros(200, 264, dtype=bf), torch.zeros(203, 264, dtype=bf))  # odd cols
    assert not tk.uses_nt_wgmma_kernel(dc.float(), w.float())
    assert not tk.uses_nt_wgmma_kernel(torch.zeros(77, 203, dtype=bf), torch.zeros(133, 203, dtype=bf))
    assert not tk.uses_nt_wgmma_kernel(dc, w, dc.clone(), _misaligned((2560, 9728)))
    assert not tk.uses_nt_wgmma_kernel(torch.zeros(4, 0, dtype=bf), torch.zeros(8, 0, dtype=bf))


def test_cpu_tensors_the_predicates_take_still_run_the_plain_versions():
    """On the CPU the wrappers run the plain versions whatever the
    predicates say, and count nothing."""
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(2, 40, 64, generator=gen).to(bf)
    w = (torch.randn(64, 136, generator=gen) * 0.1).to(bf)
    assert tk.uses_wgmma_kernel(a, w) and tk.uses_nt_wgmma_kernel(a[0], w.T.contiguous())
    before = (tk.sfc_gemm_fused.launches, dict(tk.sfc_gemm_fused.launches_by_kernel), tk.sfc_gemm_nt.launches,
              dict(tk.sfc_gemm_nt.launches_by_kernel))
    out = tk.sfc_gemm_fused(a, w)
    da = tk.sfc_gemm_nt(a[0], w.T.contiguous())
    assert torch.equal(out, tk.sfc_gemm_fused_plain(a, w, bm=64, bn=64))
    assert torch.equal(da, tk.sfc_gemm_nt_plain(a[0], w.T.contiguous(), bm=64, bn=64))
    assert before == (tk.sfc_gemm_fused.launches, dict(tk.sfc_gemm_fused.launches_by_kernel),
                      tk.sfc_gemm_nt.launches, dict(tk.sfc_gemm_nt.launches_by_kernel))


def test_the_wide_tiles_ring_fits_one_cta_an_sm():
    """kStages stages of the wide tile (A 128 x 64, B 64 x 256) fit the 227 KB
    a CTA may use, and the kernel's launch bound is that one CTA an SM."""
    src = WGMMA_SOURCE.read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kStages"] * (const["kBM"] + 2 * const["kBN"]) * const["kBK"] * 2 + 1024 <= 232448
    assert "__launch_bounds__(wg::kThreads, 1)" in WGMMA_SOURCE.with_name("sfc_gemm_fused.cu").read_text()


def test_the_lane_slots_are_one_a_consumer_warp():
    """The forward wgmma kernels' ABFT lane writes one partial a consumer
    warp of a task, with no barrier: the wrappers size the partials by
    `build.WGMMA_LANE_SLOTS`, the header's kLaneSlots."""
    src = WGMMA_SOURCE.read_text()
    consumers = int(re.search(r"constexpr int kConsumers = (\d+);", src).group(1))
    assert "constexpr int kLaneSlots = kConsumers / 32;" in src
    assert build.WGMMA_LANE_SLOTS == consumers // 32 == 8
    assert "p.chk[static_cast<size_t>(t) * kLaneSlots + threadIdx.x / 32] = lane;" in src
