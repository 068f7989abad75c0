"""Time the two split kernels of the decode step by their split on one card:
the decode attention (K14) at the 4096-row check shape of `chip_smoke.py`
(4 sequences, 32 / 8 heads of 128, bf16) for S = 1, 2, 4, 8 segments and
five patterns of live lengths, and the cluster GEMM (K1 at M <= 16) at
qwen3-4b's plain-mode decode shapes (`chip_smoke.main_path_gemms`) for
L = 1, 2, 4, 8 K layers, beside the S and L that the wrappers choose.

    python3 scripts/split_sweep.py

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


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk

    dev, dt = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(4)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
