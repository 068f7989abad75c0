"""Time the wgmma GEMM kernels by their launch configuration on one card:
the forward (K2, `sfc_gemm_wgmma_kernel`) at qwen3-4b's 512-row prefill
and training shapes and the NT dA (K7, `nt_wgmma_kernel`) at its training
shapes (`chip_smoke.main_path_gemms`, `chip_smoke.train_backward_gemms`),
with the narrow (128 x 128) and the wide (128 x 256) C tile and 1, 2 or 4
CTAs a worker (the worker walks one contiguous segment of the tasks, its
CTAs taking them in turn), on up to one CTA an SM, beside the
configuration `sfc_gemm.wgmma_launch` chooses and torch.matmul of the same
product; and the grouped modes (K3, `sfc_gemm_grouped_wgmma_kernel`; K9,
`grouped_nt_wgmma_kernel`) at olmoe-1b-7b's expert shapes
(`chip_smoke.moe_grouped_gemms`) with either tile and 1 CTA a worker (an
expert there has one 128-row block), beside `sfc_gemm.grouped_wgmma_launch`'s
choice and one torch.bmm.

    python3 scripts/wgmma_sweep.py [--only K2,K7,K3,K9]

Each kernel is launched through its C entry with the configuration
forced, timed as `chip_smoke.py` times it (CUDA events around a captured
graph of 20 or more calls, inputs rotated past the 50 MB L2).  Prints one
JSON line per shape.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

GROUPS = (1, 2, 4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="K2,K7,K3,K9", help="comma-separated kernels to sweep")
    only = set(ap.parse_args(argv).only.split(","))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import sfc_gemm as tk

    dev, dt = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lib = build.load_library()
    cfg = get_config("qwen3_4b")

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    def sweep(row, rows, n, glu, call):
        """Time call(i, wide, tab, tiles, ctas, group) with either tile and
        1, 2 or 4 CTAs a worker."""
        cfg = tk.wgmma_launch(rows, n, sms, glu)
        row["chosen"] = f"{'wide' if cfg.wide else 'narrow'}_g{cfg.group}"
        for wide in (False, True):
            mb, nb = tk.wgmma_grid(rows, n, glu, wide)
            tab = tk._device_table(mb, nb, dev)
            row[f"{'wide' if wide else 'narrow'}_tiles"] = mb * nb
            for group in GROUPS:
                ctas = min(mb * nb * group, sms) // group * group
                row[f"{'wide' if wide else 'narrow'}_g{group}_ms"] = cs.time_ms(
                    lambda i, wide=wide, tab=tab, tiles=mb * nb, ctas=ctas, group=group: call(i, wide, tab, tiles,
                                                                                             ctas, group),
                    reps=row["reps"], graph=True)

    gemms = [g for g in cs.main_path_gemms(cfg) if g.mode == "prefill" or g.name == "train/head"] \
        if "K2" in only else []
    for gm in gemms:
        rows = gm.rows
        a = r(rows, gm.k)
        copies = max(1, math.ceil(4 * cs.L2_BYTES / (gm.k * gm.n * 2 * (2 if gm.glu else 1))))
        ws = [r(gm.k, gm.n, scale=0.02) for _ in range(copies)]
        gs = [r(gm.k, gm.n, scale=0.02) for _ in range(copies)] if gm.glu else None
        out = torch.empty((rows, gm.n), dtype=dt, device=dev)
        fn = getattr(lib, build.wgmma_entry_name(gm.glu, cfg.act if gm.glu else None))

        def call(i, wide, tab, tiles, ctas, group):
            rc = fn(a.data_ptr(), ws[i % copies].data_ptr(), gs[i % copies].data_ptr() if gs else None, None, None,
                    None, out.data_ptr(), None, tab.data_ptr(), tiles, 1, 0, rows, gm.n, gm.k, int(wide), ctas, group,
                    0, 1.0, None, 0, stream())
            if rc:
                raise RuntimeError(f"wgmma launch failed with CUDA error {rc}")

        row = {"kernel": "K2", "gemm": gm.name, "rows": rows, "k": gm.k, "n": gm.n, "glu": gm.glu,
               "reps": max(20, copies)}
        cats = [torch.cat([g, w], 1) for g, w in zip(gs, ws)] if gm.glu else ws
        row["torch_matmul_ms"] = cs.time_ms(lambda i: torch.matmul(a, cats[i % copies]), reps=row["reps"],
                                            graph=True)
        sweep(row, rows, gm.n, gm.glu, call)
        print(json.dumps(row), flush=True)
        del ws, gs, cats

    nt = getattr(lib, build.bwd_entry_name("nt_wgmma", "bf16"))
    for gm in cs.train_backward_gemms(cfg):
        if gm.kind != "nt" or "K7" not in only:
            continue
        copies = max(1, math.ceil(4 * cs.L2_BYTES / gm.bytes(2)))
        pairs = 2 if gm.dual else 1
        ins = [tuple(r(*s, scale=sc) for _ in range(pairs) for s, sc in (((gm.m, gm.n), 1.0), ((gm.k, gm.n), 0.02)))
               for _ in range(copies)]
        out = torch.empty((gm.m, gm.k), dtype=dt, device=dev)

        def call(i, wide, tab, tiles, ctas, group):
            x = ins[i % copies]
            rc = nt(x[0].data_ptr(), x[1].data_ptr(), x[2].data_ptr() if gm.dual else None,
                    x[3].data_ptr() if gm.dual else None, out.data_ptr(), tab.data_ptr(), tiles, gm.m, gm.k, gm.n,
                    int(wide), ctas, group, None, 0, stream())
            if rc:
                raise RuntimeError(f"wgmma NT launch failed with CUDA error {rc}")

        row = {"kernel": "K7", "gemm": gm.name, "rows": gm.m, "k": gm.k, "n": gm.n, "dual": gm.dual,
               "reps": max(20, copies)}
        if gm.dual:
            lib_ins = [(torch.cat([x[0], x[2]], 1), torch.cat([x[1], x[3]], 1).T) for x in ins]
        else:
            lib_ins = [(x[0], x[1].T) for x in ins]
        row["torch_matmul_ms"] = cs.time_ms(lambda i: torch.matmul(*lib_ins[i % copies]), reps=row["reps"],
                                            graph=True)
        sweep(row, gm.m, gm.k, False, call)
        print(json.dumps(row), flush=True)
        del ins, lib_ins

    # the grouped modes at olmoe's expert shapes: every launch streams
    # every expert's weights (0.27-0.55 GB), far past the L2
    bm = build.WGMMA_TILE[0]
    for gm in cs.moe_grouped_gemms(get_config("olmoe_1b_7b")):
        label = {"fwd": "K3", "nt": "K9"}.get(gm.kind)
        if label not in only:
            continue
        args, kw, lib_ops = cs._grouped_operands(torch, gm, dt, gen)
        sizes = (gm.rows,) * gm.experts
        glu = gm.glu and gm.kind == "fwd"
        n_out = gm.n if gm.kind == "fwd" else gm.k
        grp = tk._device_groups(sizes, bm, dev)
        if gm.kind == "fwd":
            out = torch.empty((gm.t, gm.n), dtype=dt, device=dev)
            gate = torch.empty_like(out) if gm.preact else None
            fn = getattr(lib, build.wgmma_entry_name(glu, None if gm.preact or not glu else "silu"))

            def launch(wide, tab, ctas, group):
                return fn(args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr() if glu else None, None, None,
                          None, out.data_ptr(), None if gate is None else gate.data_ptr(), tab.data_ptr(),
                          tab.shape[1], 1, 0, gm.t, gm.n, gm.k, int(wide), ctas, group, 0, 1.0, grp.data_ptr(),
                          gm.experts, stream())
        else:
            out = torch.empty((gm.t, gm.k), dtype=dt, device=dev)
            # the wrapper's operands: dC (T, N) and the (E, K, N) weights as stored
            ws = [x.contiguous() for x in args[1::2]]

            def launch(wide, tab, ctas, group):
                return nt(args[0].data_ptr(), ws[0].data_ptr(), args[2].data_ptr() if gm.glu else None,
                          ws[1].data_ptr() if gm.glu else None, out.data_ptr(), tab.data_ptr(), tab.shape[1],
                          gm.t, gm.k, gm.n, int(wide), ctas, group, grp.data_ptr(), gm.experts, stream())

        row = {"kernel": label, "gemm": gm.name, "experts": gm.experts, "rows_per_expert": gm.rows, "k": gm.k,
               "n": gm.n, "glu": gm.glu, "reps": 20}
        chosen = tk.grouped_wgmma_launch(sizes, n_out, sms, glu)
        row["chosen"] = f"{'wide' if chosen.wide else 'narrow'}_g{chosen.group}"
        row["torch_bmm_ms"] = cs.time_ms(lambda i: torch.bmm(*lib_ops), reps=20, graph=True)
        for wide in (False, True):
            nb = tk.wgmma_grid(1, n_out, glu, wide)[1]
            tab = tk._device_grouped_table(sizes, bm, nb, dev)
            ctas = min(tab.shape[1], sms)
            name = "wide" if wide else "narrow"
            row[f"{name}_tiles"] = tab.shape[1]

            def call(i, wide=wide, tab=tab, ctas=ctas):
                rc = launch(wide, tab, ctas, 1)
                if rc:
                    raise RuntimeError(f"grouped wgmma launch failed with CUDA error {rc}")

            row[f"{name}_g1_ms"] = cs.time_ms(call, reps=20, graph=True)
        print(json.dumps(row), flush=True)
        del args, lib_ops, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
