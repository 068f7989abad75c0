"""Time the split kernels on one card by their split: the decode attention
(K14) at the 4096-row check shape of `chip_smoke.py` (4 sequences, 32 / 8
heads of 128, bf16) for S = 1, 2, 4, 8 segments and five patterns of live
lengths; the cluster GEMM (K1 at M <= 16) at qwen3-4b's plain-mode decode
shapes (`chip_smoke.main_path_gemms`) for L = 1, 2, 4, 8 K layers; and the
wgmma dK/dV kernel (K13) at qwen3-4b's and olmoe-1b-7b's training steps (2
x 256 tokens) and one 2048-token sequence for every cluster C of CTAs (a
divisor of the GQA group, at most 8), beside the S, L and C that the
wrappers choose.

    python3 scripts/split_sweep.py [k14] [k1] [k13]   # default: all three

Each kernel is launched through its C entry with the split forced, timed
as `chip_smoke.py` times it (CUDA events around a captured graph of 40 or
more calls, inputs rotated past the 50 MB L2).  Prints one JSON line per
shape.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

LIVE = ((1, 1000, 2048, 4096), (4096,) * 4, (512,) * 4, (32,) * 4, (0,) * 4)
SPLITS = (1, 2, 4, 8)


def main(argv=None) -> int:
    parts = set(sys.argv[1:] if argv is None else argv) or {"k14", "k1", "k13"}
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk

    dev, dt = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(4)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    if "k13" in parts:
        sweep_k13(torch, cs, tsa, gen, sms)
    if "k14" in parts:
        sweep_k14(torch, cs, build, tsa, gen, sms, stream)
    if "k1" in parts:
        sweep_k1(torch, cs, build, tk, gen, sms, stream)
    return 0


def sweep_k13(torch, cs, tsa, gen, sms):
    """K13 on the wgmma kernel by its cluster of C CTAs, each taking
    groups / C of the q heads (`sfc_attention.bwd_wgmma_grid` chooses C)."""
    from repro_torch.configs import get_config

    dev, dt = torch.device("cuda"), torch.bfloat16
    qwen, olmoe = get_config("qwen3_4b"), get_config("olmoe_1b_7b")
    for name, cfg, b, s in (("qwen3-4b train", qwen, 2, 256), ("olmoe-1b-7b train", olmoe, 2, 256),
                            ("qwen3-4b 1 x 2048", qwen, 1, 2048)):
        h, hkv, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim_
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev).to(dt)
                       for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))
        o, lse = tsa.sfc_flash_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1)
        nk = math.ceil(s / 64)
        tab_q, rows = tsa._device_band(nk, nk, True, 0, dev, 64, 64, True)
        outs = (torch.empty_like(k), torch.empty_like(v))
        groups = h // hkv
        row = {"kernel": "K13", "shape": name, "b": b, "s": s, "h": h, "hkv": hkv, "d": d,
               "chosen_C": tsa.bwd_wgmma_grid("dkv", b, s, s, h, hkv, sms)[1]}
        for c in range(1, min(groups, 8) + 1):
            if groups % c:
                continue

            def call(i, c=c):
                tsa._launch_bwd("dkv", q, k, v, do, lse, delta, outs, tab_q, rows, causal=True, seq_q=s, seq_k=s,
                                q_offset=0, wgmma=True, cluster=c)

            row[f"C{c}_ms"] = cs.time_ms(call, reps=40, graph=True)
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, outs


def sweep_k14(torch, cs, build, tsa, gen, sms, stream):
    dev, dt = torch.device("cuda"), torch.bfloat16
    # K14: S segments of a 4096-row cache
    b, t, h, hkv, d, copies = 4, 4096, 32, 8, 128, 8
    dec = getattr(build.load_attention_library(), build.attn_entry_name("decode", "bf16", d))
    ins = [tuple(torch.randn(s, generator=gen, device=dev).to(dt) for s in ((b, 1, h, d), (b, t, hkv, d),
                                                                            (b, t, hkv, d))) for _ in range(copies)]
    out = torch.empty((b, 1, h, d), dtype=dt, device=dev)
    for live in LIVE:
        valid = torch.tensor(live, dtype=torch.int32, device=dev)
        row = {"kernel": "K14", "valid": list(live), "chosen_S": tsa.decode_splits(b, hkv, t, sms)}
        for splits in SPLITS:
            seg = tsa.decode_segment_rows(t, splits)

            def call(i, splits=splits, seg=seg):
                q, k, v = ins[i % copies]
                rc = dec(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(), b, h, hkv, t,
                         *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(d), splits, seg, stream())
                if rc:
                    raise RuntimeError(f"decode launch failed with CUDA error {rc}")

            row[f"S{splits}_ms"] = cs.time_ms(call, reps=40, graph=True)
        print(json.dumps(row), flush=True)
    del ins


def sweep_k1(torch, cs, build, tk, gen, sms, stream):
    from repro_torch.configs import get_config

    dev, dt = torch.device("cuda"), torch.bfloat16
    # K1 at decode: L K layers a cluster
    cfg = get_config("qwen3_4b")
    lib = build.load_library()
    for gm in cs.main_path_gemms(cfg):
        if gm.batch:
            continue
        a = torch.randn((gm.m, gm.k), generator=gen, device=dev).to(dt)
        copies = max(1, math.ceil(4 * cs.L2_BYTES / (gm.k * gm.n * 2 * (2 if gm.glu else 1))))
        ws = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)]
        gs = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)] \
            if gm.glu else None
        fn = getattr(lib, build.cluster_entry_name(gm.glu, cfg.act if gm.glu else None))
        nb = math.ceil(gm.n / build.TILE[1])
        tab = tk._device_table(1, nb, dev)
        out = torch.empty((gm.m, gm.n), dtype=dt, device=dev)
        row = {"kernel": "K1", "gemm": gm.name, "chosen_L": tk.cluster_layers(gm.k, gm.n, sms)}
        for layers in (1, 2, 4, 8):
            slab = tk.layer_slab(gm.k, layers)

            def call(i, layers=layers, slab=slab):
                rc = fn(a.data_ptr(), ws[i % copies].data_ptr(), gs[i % copies].data_ptr() if gs else None, None,
                        None, None, out.data_ptr(), None, tab.data_ptr(), nb, gm.m, gm.n, gm.k, layers, slab, 0, 1.0,
                        int(tk._rows_vec(gm.k, a) and slab % 8 == 0), int(tk._rows_vec(gm.n, ws[0])), stream())
                if rc:
                    raise RuntimeError(f"cluster GEMM launch failed with CUDA error {rc}")

            row[f"L{layers}_ms"] = cs.time_ms(call, reps=max(40, copies), graph=True)
        print(json.dumps(row), flush=True)
        del ws, gs


if __name__ == "__main__":
    raise SystemExit(main())
