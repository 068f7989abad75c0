"""The tuner on the card (marked ``cuda``: they skip on the CPU; run them
there with ``python -m pytest -q --noconftest -m cuda
tests/test_torch_tune_card.py``): a tuned launch reaching each kernel's
rule through a cache entry (K1's cluster split L, K2's tile and worker
group at the rows the launch runs, a shared weight's batch folded in, K7's
tile and group, K8's group in dW mode, the replicated form's K layers,
K11's W, K13's C through autograd's backward thread, K14's S), each
result against its plain version over the same split (bf16 within one
output rounding, 2^-7 |p| + 1e-3 max|p|); and a candidate that fails to
launch raising out of `tune_gemm`, caching nothing."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import attention_backend as tab  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import tuner as ttuner  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _agree(got, want, dtype):
    err = (got.float() - want.float()).abs()
    p = want.float().abs()
    bound = (1e-4 * p + 1e-5 * p.max()) if dtype == torch.float32 else (2.0**-7 * p + 1e-3 * p.max())
    return bool(torch.isfinite(got.float()).all()) and bool((err <= bound).all())


def _launched(counter, fn):
    before = dict(counter)
    out = fn()
    torch.cuda.synchronize()
    added = {k: v - before.get(k, 0) for k, v in counter.items() if v != before.get(k, 0)}
    return out, added


def _entry(launch, k_layers=1):
    return tcache.Knobs(128, 128, k_layers, 1, "measured", 1e-5, launch=launch)


def _spy(monkeypatch, module, name):
    """Record what ``module.name`` returns (the launch a wrapper chose)."""
    real, seen = getattr(module, name), []

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.cuda
def test_a_tuned_launch_reaches_every_gemm_rule_on_the_card(tmp_path, monkeypatch):
    _card()
    from repro_torch.kernels import sfc_gemm as tk

    cache = tcache.KnobCache(str(tmp_path / "k.json"))
    monkeypatch.setattr(ttuner, "_DEFAULT_CACHE", cache)
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda").to(bf)  # noqa: E731
    a4, a512, w = r(4, 2560), r(512, 2560), r(2560, 4096)
    wg, tn = _spy(monkeypatch, tk, "wgmma_launch"), _spy(monkeypatch, tk, "tn_wgmma_launch")
    # K1 at M <= 16: the cluster kernel's K layers
    cache.put(4, 4096, 2560, bf, "gpu", _entry({"layers": 2}))
    out, added = _launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: tops.sfc_matmul(a4, w))
    assert added == {("sfc_gemm_cluster_kernel", 2): 1}
    assert _agree(out, tk.sfc_gemm_fused_plain(a4, w, k_layers=2, bm=4096, bn=4096), bf)
    # K2: the tile and the worker group, keyed by the rows the launch runs:
    # a batch of 4 x 128 rows over a shared weight resolves the 512-row entry
    cache.put(512, 4096, 2560, bf, "gpu", _entry({"wide": 1, "group": 2}))
    for a in (a512, a512.reshape(4, 128, 2560)):
        out, added = _launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: tops.sfc_matmul(a, w))
        assert added == {("sfc_gemm_wgmma_kernel", "128x256"): 1}
        assert (wg[-1].wide, wg[-1].group) == (True, 2)
        assert _agree(out.reshape(512, 4096), tk.sfc_gemm_fused_plain(a512, w, bm=4096, bn=4096), bf)
    # with no entry for its rows a call keeps the rule: 128 rows, narrow tile
    out, added = _launched(tk.sfc_gemm_fused.launches_by_kernel, lambda: tops.sfc_matmul(a512[:128], w))
    assert added == {("sfc_gemm_wgmma_kernel", "128x128"): 1} and not wg[-1].wide
    # K7 and K8: their tile and group
    dc = r(512, 4096)
    cache.put(512, 2560, 4096, bf, "gpu", _entry({"wide": 0, "group": 2}), "nt")
    out, added = _launched(tk.sfc_gemm_nt.launches_by_kernel, lambda: tops.sfc_matmul_nt(dc, w))
    assert added == {("nt_wgmma_kernel", "128x128"): 1} and wg[-1].group == 2
    assert _agree(out, tk.sfc_gemm_nt_plain(dc, w, bm=4096, bn=4096), bf)
    cache.put(2560, 4096, 512, bf, "gpu", _entry({"group": 1}), "tn")
    out, added = _launched(tk.sfc_gemm_tn.launches_by_kernel, lambda: tops.sfc_matmul_tn(a512, dc))
    assert added == {("tn_wgmma_kernel", "128x128"): 1} and tn[-1].group == 1
    assert _agree(out, tk.sfc_gemm_tn_plain(a512, dc, bm=4096, bn=4096), bf)
    # the replicated form's K layers from the entry: K5 with two copies, then K6
    cache.put(512, 4096, 2560, bf, "gpu", _entry(None, k_layers=2))
    out, added = _launched(tk.sfc_gemm_replicated.launches_by_shape, lambda: tops.sfc_matmul(a512, w, fuse=False))
    assert added == {(0, 512, 2560, 4096, 2): 1}
    assert tk.add_reduce.launches_by_shape[(0, 2, 512, 4096)] >= 1
    # against the plain versions of the same split, each of the two copies
    # rounded to bf16 before the sum: two roundings more than the fused form
    # has, so twice its bound
    want = tops.sfc_matmul(a512.cpu(), w.cpu(), fuse=False, k_layers=2).float()
    err, p = (out.cpu().float() - want).abs(), want.abs()
    assert bool((err <= 2.0**-6 * p + 2e-3 * p.max()).all())


@pytest.mark.cuda
def test_a_tuned_launch_reaches_every_attention_rule_on_the_card(tmp_path, monkeypatch):
    _card()
    from repro_torch.kernels import sfc_attention as tsa

    cache = tcache.KnobCache(str(tmp_path / "k.json"))
    monkeypatch.setattr(ttuner, "_DEFAULT_CACHE", cache)
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(4)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda").to(bf)  # noqa: E731
    q, k, v = r(2, 128, 8, 128), r(2, 128, 2, 128), r(2, 128, 2, 128)
    for w in tsa.fwd_warpgroup_sizes(8, 2):
        cache.put(128, 128, 128, bf, "gpu", _entry({"warpgroups": w}), "attn_fwd")
        out, added = _launched(tsa.sfc_flash_fwd.launches_by_kernel, lambda: tab.flash_attention(q, k, v))
        assert added == {("flash_fwd_wgmma_kernel", w): 1}
    # K13's C: autograd runs the backward on a thread of its own
    for c in tsa.dkv_cluster_sizes(8, 2):
        cache.put(128, 128, 128, bf, "gpu", _entry({"cluster": c}), "attn_bwd")
        qq = q.detach().requires_grad_(True)
        _, added = _launched(tsa.sfc_flash_bwd_dkv.launches_by_kernel,
                             lambda: tab.flash_attention(qq, k, v).float().sum().backward())
        assert added == {("flash_bwd_dkv_wgmma_kernel", c): 1}
    kc, vc = r(4, 145, 8, 128), r(4, 145, 8, 128)
    qd = r(4, 1, 32, 128)
    valid = torch.full((4,), 100, dtype=torch.int32, device="cuda")
    for s in tsa.decode_split_sizes(145):
        cache.put(32, 145, 128, bf, "gpu", _entry({"splits": s}), "attn_decode")
        out, added = _launched(tsa.sfc_decode_attention.launches_by_splits,
                               lambda: tab.decode_attention(qd, kc, vc, valid))
        assert added == {s: 1}
        want = tsa.sfc_decode_attention_plain(qd, kc, vc, valid, k_chunk=tsa.build.DECODE_CHUNK, splits=s)
        assert _agree(out, want, bf)


@pytest.mark.cuda
def test_a_candidate_that_fails_to_launch_raises_on_the_card(tmp_path, monkeypatch):
    _card()
    cache = tcache.KnobCache(str(tmp_path / "k.json"))
    real = ttuner.candidate_knobs

    def with_a_bad_one(*args, **kw):
        cands = real(*args, **kw)
        return cands + [dataclasses.replace(cands[0], launch={"layers": 3})]  # no such split

    monkeypatch.setattr(ttuner, "candidate_knobs", with_a_bad_one)
    with pytest.raises(ValueError, match="power of two"):
        ttuner.tune_gemm(4, 4096, 2560, torch.bfloat16, cache=cache, strategy="exhaustive", device="cuda")
    assert cache.get(4, 4096, 2560, torch.bfloat16, "gpu") is None
    monkeypatch.setattr(ttuner, "candidate_knobs", real)
    won = ttuner.tune_gemm(4, 4096, 2560, torch.bfloat16, cache=cache, strategy="exhaustive", device="cuda")
    assert won.source == "measured" and won.time_s > 0
