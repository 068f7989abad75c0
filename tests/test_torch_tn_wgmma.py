"""K8 and K10 on the wgmma kernels, their host side on the CPU: the launch
configuration of the TN wgmma kernels (`tn_wgmma_launch`) as a pure
function of the shape, the SM count, the dual form and the experts; the
dispatch predicate (`uses_tn_wgmma_kernel`); the stochastic-rounding bits
that the kernels' flush draws for each element of a 128 x 128 tile from
its 64 x 64 sub-tile, against the plain versions' (`_tile_bits`,
`_grouped_tile_bits`) and JAX's; the grouped kernels' tasks against the
JAX package's grouped TN table; and the plain TN and grouped-TN versions
at the kernels' 64 x 64 tile against the JAX package's kernels in
interpret mode on ragged shapes (f32, rtol 1e-4), expert sizes that are
not multiples of 64 and an empty expert included.  The kernels themselves
run only on the card (``tests/test_torch_kernels.py``, marked ``cuda``).
"""

import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.kernels import sfc_gemm as jk  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

H100_SMS = 132
CU_SOURCE = Path(build.__file__).resolve().parent / "csrc" / "sfc_gemm_fused.cu"
RTOL, ATOL = 1e-4, 1e-5

# qwen3-4b's dW outputs at the training step (K, N, dual), and olmoe-1b-7b's
# expert stacks (64 experts), in dW mode and in the norm / update modes
# (``update``): -> (wide stage, mb, nb, CTAs, CTAs a worker), the tile
TN_LAUNCHES = {
    "q": ((2560, 4096, False, 1, False), (False, 20, 32, 132, 4), "128x128"),
    "k,v": ((2560, 1024, False, 1, False), (False, 20, 8, 132, 4), "128x128"),
    "o": ((4096, 2560, False, 1, False), (False, 32, 20, 132, 4), "128x128"),
    "glu_dual": ((2560, 9728, True, 1, False), (True, 20, 76, 132, 4), "128x128"),
    "w_out": ((9728, 2560, False, 1, False), (False, 76, 20, 132, 4), "128x128"),
    "head": ((2560, 151936, False, 1, False), (False, 20, 1187, 132, 4), "128x128"),
    "olmoe_glu_dual": ((2048, 1024, True, 64, False), (True, 16, 8, 132, 4), "128x128"),
    "olmoe_w_out": ((1024, 2048, False, 64, False), (False, 8, 16, 132, 4), "128x128"),
    "one_tile": ((64, 64, False, 1, False), (False, 1, 1, 1, 1), "128x128"),
    "update/q": ((2560, 4096, False, 1, True), (False, 20, 32, 132, 4), "128x128"),
    "update/glu_dual": ((2560, 9728, True, 1, True), (False, 20, 152, 132, 4), "128x64"),
    "update/olmoe_glu_dual": ((2048, 1024, True, 64, True), (False, 16, 16, 132, 4), "128x64"),
    "update/olmoe_w_out": ((1024, 2048, False, 64, True), (False, 8, 16, 132, 4), "128x128"),
}


@pytest.mark.parametrize("name", sorted(TN_LAUNCHES))
def test_tn_wgmma_launch_at_the_main_paths_shapes(name):
    (rows, cols, dual, experts, update), want, tile = TN_LAUNCHES[name]
    cfg = tk.tn_wgmma_launch(rows, cols, H100_SMS, dual, experts, update)
    assert tuple(cfg) == want
    assert tk._tile_name(cfg, dual) == tile


@pytest.mark.parametrize("update", [False, True])
@pytest.mark.parametrize("sms", [1, 7, 78, 132])
@pytest.mark.parametrize("rows,cols,dual,experts", [(8, 8, False, 1), (264, 328, True, 1), (2560, 151936, False, 1),
                                                    (264, 328, True, 4), (2048, 1024, True, 64), (200, 8, False, 3)])
def test_tn_wgmma_launch_holds_its_invariants_on_any_card(sms, rows, cols, dual, experts, update):
    """128 x 128 tiles a set (the dual form's norm and update: 128 x 64)
    covering the output; at most one CTA an SM and a task a CTA, whole
    worker groups, a group only where a CTA has more than one task; the
    same answer every call."""
    cfg = tk.tn_wgmma_launch(rows, cols, sms, dual, experts, update)
    tasks = experts * cfg.mb * cfg.nb
    cps = 64 if dual and update else 128
    assert cfg.wide == (dual and not update)
    assert (cfg.mb - 1) * 128 < rows <= cfg.mb * 128 and (cfg.nb - 1) * cps < cols <= cfg.nb * cps
    assert 1 <= cfg.ctas <= min(sms, tasks) and cfg.ctas % cfg.group == 0 and cfg.ctas // cfg.group <= tasks
    assert cfg.group == (min(4, cfg.mb, sms) if tasks > min(sms, tasks) else 1)
    assert tk.tn_wgmma_launch(rows, cols, sms, dual, experts, update) == cfg


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose base lies 4 bytes past a 16-byte boundary."""
    elem = torch.tensor([], dtype=dtype).element_size()
    flat = torch.zeros(math.prod(shape) + 16, dtype=dtype)
    return flat[4 // elem:4 // elem + math.prod(shape)].view(shape)


def test_uses_tn_wgmma_kernel_is_type_rows_alignment_and_state():
    """bf16, at least one token row, K and N multiples of 8, aligned
    operands and (update mode) aligned W and state; the grouped mode's
    packed (T, K) / (T, N) operands select alike."""
    bf = torch.bfloat16
    x, dc = torch.zeros(512, 2560, dtype=bf), torch.zeros(512, 9728, dtype=bf)
    state = [torch.zeros(2560, 9728) for _ in range(3)] + [torch.zeros(2560, 9728, dtype=bf)]
    assert tk.uses_tn_wgmma_kernel(x, dc) and tk.uses_tn_wgmma_kernel(x, dc, dc.clone())
    assert tk.uses_tn_wgmma_kernel(x, dc, None, *state)
    assert tk.uses_tn_wgmma_kernel(torch.zeros(5, 64, dtype=bf), torch.zeros(5, 1000, dtype=bf))  # ragged rows
    assert tk.uses_tn_wgmma_kernel(torch.zeros(56, 264, dtype=bf), torch.zeros(56, 328, dtype=bf))  # K10's packed
    assert not tk.uses_tn_wgmma_kernel(x.float(), dc.float())  # f32: the tile kernels
    assert not tk.uses_tn_wgmma_kernel(torch.zeros(0, 2560, dtype=bf), torch.zeros(0, 9728, dtype=bf))  # no rows
    assert not tk.uses_tn_wgmma_kernel(torch.zeros(77, 203, dtype=bf), torch.zeros(77, 328, dtype=bf))  # K % 8
    assert not tk.uses_tn_wgmma_kernel(torch.zeros(77, 264, dtype=bf), torch.zeros(77, 133, dtype=bf))  # N % 8
    assert not tk.uses_tn_wgmma_kernel(_misaligned((512, 2560)), dc)
    assert not tk.uses_tn_wgmma_kernel(x, dc, _misaligned((512, 9728)))
    assert not tk.uses_tn_wgmma_kernel(x, dc, None, _misaligned((2560, 9728), torch.float32), *state[1:])
    assert not tk.uses_tn_wgmma_kernel(x, dc, None, *state[:3], _misaligned((2560, 9728)))


def test_cpu_tensors_still_run_the_plain_versions_and_count_nothing():
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    x, dc = torch.randn(40, 64, generator=gen).to(bf), torch.randn(40, 136, generator=gen).to(bf)
    assert tk.uses_tn_wgmma_kernel(x, dc)
    before = (dict(tk.sfc_gemm_tn.launches_by_kernel), dict(tk.sfc_gemm_grouped_tn.launches_by_kernel))
    assert torch.equal(tk.sfc_gemm_tn(x, dc), tk.sfc_gemm_tn_plain(x, dc, bm=64, bn=64))
    gs = (7, 0, 33)
    assert torch.equal(tk.sfc_gemm_grouped_tn(x, dc, group_sizes=gs),
                       tk.sfc_gemm_grouped_tn_plain(x, dc, group_sizes=gs, bm=64, bn=64))
    assert before == (dict(tk.sfc_gemm_tn.launches_by_kernel), dict(tk.sfc_gemm_grouped_tn.launches_by_kernel))


def _fragment_elements(row0, col0, sets, cps):
    """(set, row, col) of every accumulator of a TN wgmma task with ``cps``
    C columns a set, as the kernel's 256 consumer threads hold them
    (csrc/sfc_gemm_fused.cu, `TnFlush`): warpgroup wgi, warp w, lane l,
    pair q of a set."""
    wgi, warp, lane, s, q, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(sets),
                                           np.arange(cps // 4), np.arange(2), indexing="ij")
    gr = row0 + wgi * 64 + warp * 16 + lane // 4 + 8 * (q & 1)
    gc = col0 + 2 * (lane % 4) + 8 * (q >> 1) + e
    return [x.reshape(-1) for x in (s, gr, gc)]


def _update_elements(row0, col0, sets, cps):
    """(set, row, col, im, in) of every weight a TN wgmma task's update
    flush writes, in the order of its pass over the staged tile (thread t,
    chunk k: row t // (cps / 4) + k rs, rs = 256 // (cps / 4), 4 columns
    at 4 (t % (cps / 4))); the sub-tile of the element's seed from the
    chunk index and the thread's column alone, as the kernel computes it."""
    c4s = cps // 4
    rs = 256 // c4s
    s, t, k, e = np.meshgrid(np.arange(sets), np.arange(256), np.arange(128 * c4s // 256), np.arange(4),
                             indexing="ij")
    row, c4 = t // c4s + k * rs, 4 * (t % c4s)
    gr, gc = row0 + row, col0 + c4 + e
    im, in_ = (row0 >> 6) + ((k * rs) >> 6), (col0 + c4) >> 6
    return [x.reshape(-1) for x in (s, gr, gc, im, in_)]


# (sets, C columns a set): single, the dual form's dW, its norm / update
FLUSH_FORMS = [(1, 128), (2, 128), (2, 64)]


@pytest.mark.parametrize("sets,cps", FLUSH_FORMS)
def test_the_fragments_and_the_flush_pass_cover_a_tile_once(sets, cps):
    """The accumulator fragments (the norm's and the lane's sums) and the
    update's pass over the staged tile each cover every element of a 128 x
    ``cps`` tile a set exactly once; the pass's seed sub-tile is the
    element's own."""
    for row0, col0 in ((0, 0), (128, 256), (384, 1152)):
        for elements in (_fragment_elements(row0, col0, sets, cps), _update_elements(row0, col0, sets, cps)[:3]):
            s, gr, gc = elements
            assert len(set(zip(s.tolist(), gr.tolist(), gc.tolist()))) == len(s) == sets * 128 * cps
            assert gr.min() == row0 and gr.max() == row0 + 127 and gc.min() == col0 and gc.max() == col0 + cps - 1
        _, gr, gc, im, in_ = _update_elements(row0, col0, sets, cps)
        assert np.array_equal(im, gr >> 6) and np.array_equal(in_, gc >> 6)


def _kernel_bits(hyper, salt, s, gr, gc, im, in_, expert=None):
    """The bits the kernel's flush draws: its sub-tile's seed (`tile_seed`,
    or `grouped_tile_seed` with the lane 2e + set) hashed with the
    element's (r, c) in the sub-tile (`element_bits`)."""
    im, in_, s = (torch.from_numpy(x.astype(np.int64)) for x in (im, in_, s))
    if expert is None:
        seed = torch.where(s == 0, tk._tile_seed(hyper, salt, im, in_), tk._tile_seed(hyper, salt, im, in_, 1))
    else:
        seed = tk._tile_seed(hyper, salt, im, in_, 2 * expert + s)
    r = torch.from_numpy((gr & 63).astype(np.int64))
    c = torch.from_numpy((gc & 63).astype(np.int64))
    return tk._hash_u32(seed ^ tk._mul32(r, 0x9E3779B1) ^ tk._mul32(c, 0x85EBCA77))


def _hyper(step):
    return tadamw.pack_adamw_hyper(tadamw.AdamWConfig(lr=1e-2), torch.tensor(step, dtype=torch.int32),
                                   torch.tensor(0.5))


@pytest.mark.parametrize("sets,cps", [(1, 128), (2, 64)])
@pytest.mark.parametrize("expert", [None, 0, 5])
def test_the_flushs_bits_of_a_128_row_tile_are_the_64_by_64_tile_bits(sets, cps, expert):
    """Every element of 128 x ``cps`` update tiles over a ragged (264, 328)
    weight: the bits from its 64 x 64 sub-tile (im, in, r, c) equal the
    plain version's `_tile_bits` / `_grouped_tile_bits` at 64 x 64, so a
    bf16 W stays bitwise the rounding the plain version and the JAX package
    draw."""
    k, n, salt = 264, 328, (3 << 16) + 5
    dual = sets == 2
    for step in (7, -3):
        hyper = _hyper(step)
        for row0, col0 in ((0, 0), (128, cps), (256, 4 * cps)):
            s, gr, gc, im, in_ = _update_elements(row0, col0, sets, cps)
            inside = (gr < k) & (gc < n)
            s, gr, gc, im, in_ = (x[inside] for x in (s, gr, gc, im, in_))
            got = _kernel_bits(hyper, salt, s, gr, gc, im, in_, expert)
            for set_ in range(2 if dual else 1):
                if expert is None:
                    want = tk._tile_bits(k, n, 64, 64, hyper, salt, *((1,) if set_ else ()))
                else:
                    want = tk._grouped_tile_bits(expert + 1, k, n, 64, 64, hyper, salt, set_)[expert]
                sel = s == set_
                assert torch.equal(got[torch.from_numpy(sel)], want[gr[sel], gc[sel]])


def test_the_flushs_seed_of_a_sub_tile_is_jaxs():
    """The seed the flush takes for sub-tile (im, in) of set 1 (K8) and of
    expert 3's set 0 (K10) against JAX's ``_tile_seed``, and the element
    bits against its ``tile_random_bits`` over that 64 x 64 tile."""
    salt = 17
    hyper = _hyper(11)
    jh = jadamw.pack_adamw_hyper(jadamw.AdamWConfig(lr=1e-2), jnp.int32(11), jnp.float32(0.5))
    jh = jh.at[jadamw.HYP_SALT].set(jadamw.seed_to_lane(jnp.int32(salt)))
    s, gr, gc, im, in_ = _update_elements(128, 256, 2, 64)
    got = _kernel_bits(hyper, salt, s, gr, gc, im, in_).numpy()
    got_e = _kernel_bits(hyper, salt, s, gr, gc, im, in_, expert=3).numpy()
    for set_, lane, bits_of in ((1, 1, got), (0, 6, got_e)):
        for sub_im, sub_in in ((2, 4), (3, 4)):
            seed = jk._tile_seed(jh, jnp.int32(sub_im), jnp.int32(sub_in), jnp.int32(lane))
            want = np.asarray(jk.tile_random_bits((64, 64), seed, hw_rng=False)).astype(np.int64)
            sel = (s == set_) & (im == sub_im) & (in_ == sub_in)
            assert np.array_equal(bits_of[sel], want[gr[sel] & 63, gc[sel] & 63])


def test_the_kernels_flush_walks_its_tiles_as_mirrored():
    """The kernel's source writes the layouts the tests above mirror."""
    src = CU_SOURCE.read_text()
    assert "const int lr0 = wgi * 64 + (tw / 32) * 16 + lane_id / 4;" in src
    assert "const int lc0 = 2 * (lane_id % 4);" in src
    assert "const int gr = row0 + lr0 + 8 * (q & 1), gc = col0 + lc0 + 8 * (q >> 1);" in src
    assert "constexpr int CPS = 4 * Q;" in src and "constexpr int C4 = CPS / 4;" in src
    # thread t's chunk k: row t // C4 + k (256 // C4), 4 columns at 4 (t % C4)
    assert "constexpr int RS = wg::kConsumers / C4;" in src
    assert "const int c4 = 4 * (threadIdx.x % C4), rt = threadIdx.x / C4;" in src
    assert "const int kk = b * kBatch + k, row = rt + kk * RS;" in src
    assert "const unsigned im = (row0 >> 6) + i, in = (col0 + c4) >> 6;" in src
    assert "GROUPED ? grouped_tile_seed(step_bits, a.salt, im, in, 2u * e + set)" in src
    assert ": tile_seed(step_bits, a.salt, im, in, set);" in src
    assert "const unsigned s0 = seed[(kk * RS) >> 6];" in src  # row >> 6, as rt < RS and RS divides 64
    assert "const int c = (col0 + c4) & 63;" in src and "const int r = (row0 + row) & 63;" in src
    assert all(f"element_bits(s0, r, c{d})" in src for d in ("", " + 1", " + 2", " + 3"))


@pytest.mark.parametrize("experts,kb,nb", [(64, 16, 8), (4, 3, 3), (1, 1, 5)])
def test_the_grouped_tasks_are_the_jax_packages_grouped_tn_table(experts, kb, nb):
    """K10 on the wgmma kernel walks task t as expert t // tiles at tile t %
    tiles of `gemm_spec(kb, nb)`'s table: the (ik, in, expert) rows of the
    JAX package's `grouped_tn_spec` table, in its order."""
    tab = tk._device_table.__wrapped__(kb, nb, torch.device("cpu")).numpy()
    tiles = kb * nb
    t = np.arange(experts * tiles)
    mine = np.stack([tab[0][t % tiles], tab[1][t % tiles], t // tiles])
    want = jsched.compile_schedule(jsched.grouped_tn_spec((1,) * experts, kb, nb)).table[:3]
    assert np.array_equal(mine, want)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [None if s is None else rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("m,k,n", [(200, 72, 136), (64, 128, 64), (5, 8, 200)])
def test_plain_tn_at_the_kernels_tile_matches_jax(m, k, n, dual):
    """K8's plain version at 64 x 64 (the kernels' SR sub-tile and the tile
    kernel's tile) against JAX ``sfc_gemm_tn`` in interpret mode, K and N
    padded with zeros on the JAX side only: f32, rtol 1e-4."""
    a, b, b2 = _arrays(m + k + n, (m, k), (m, n), (m, n) if dual else None)
    kp, np_ = -(-k // 64) * 64, -(-n // 64) * 64

    def pad(x, cols):
        return None if x is None else jnp.pad(jnp.asarray(x), ((0, 0), (0, cols - x.shape[1])))

    want = jk.sfc_gemm_tn(pad(a, kp), pad(b, np_), pad(b2, np_), bm=64, bn=64, interpret=True)
    got = tk.sfc_gemm_tn_plain(*(None if x is None else torch.from_numpy(x) for x in (a, b, b2)), bm=64, bn=64)
    for g, w in zip(got if dual else [got], want if dual else [want]):
        _close(g, np.asarray(w)[:k, :n])


def _pad_expert_rows(x, gs, unit):
    """The JAX kernels' packing: each expert's rows padded to a ``unit``
    multiple (an empty expert takes none)."""
    slabs, off = [], 0
    for g in gs:
        if g:
            slabs.append(jnp.zeros((-(-g // unit) * unit, x.shape[1]), jnp.float32).at[:g].set(x[off:off + g]))
        off += g
    return jnp.concatenate(slabs), tuple(-(-g // unit) for g in gs)


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("gs", [(80, 0, 45, 130), (5, 0, 19, 32), (0, 64, 1)])
def test_plain_grouped_tn_at_the_kernels_tile_matches_jax(gs, dual):
    """K10's plain version at 64 x 64 against JAX ``sfc_gemm_grouped_tn``
    in interpret mode, on expert sizes that are not multiples of 64 with an
    empty expert: f32, rtol 1e-4, the empty expert's stack exactly zero."""
    k, n = 72, 136
    t = sum(gs)
    a, b, b2 = _arrays(t + 3, (t, k), (t, n), (t, n) if dual else None)
    row_block = tk.grouped_tn_row_block(gs)
    kp, np_ = 128, 192
    a_p, row_blocks = _pad_expert_rows(jnp.pad(jnp.asarray(a), ((0, 0), (0, kp - k))), gs, row_block)
    b_p = _pad_expert_rows(jnp.pad(jnp.asarray(b), ((0, 0), (0, np_ - n))), gs, row_block)[0]
    b2_p = _pad_expert_rows(jnp.pad(jnp.asarray(b2), ((0, 0), (0, np_ - n))), gs, row_block)[0] if dual else None
    want = jk.sfc_gemm_grouped_tn(a_p, b_p, b2_p, row_blocks=row_blocks, row_block=row_block, bm=64, bn=64,
                                  interpret=True)
    got = tk.sfc_gemm_grouped_tn_plain(*(None if x is None else torch.from_numpy(x) for x in (a, b, b2)),
                                       group_sizes=gs, bm=64, bn=64)
    for g, w in zip(got if dual else [got], want if dual else [want]):
        _close(g, np.asarray(w)[:, :k, :n])
        for e, size in enumerate(gs):
            if size == 0:
                assert not bool(g[e].any())
