"""Compare the kernels of source trees on one card: the times of K1/K2
(`sfc_gemm_fused`; at M <= 16 the cluster kernel in a tree that has it),
K7 (`sfc_gemm_nt`) and K8's dW mode (`sfc_gemm_tn`) at qwen3-4b's
main-path shapes (`chip_smoke.py`'s `main_path_gemms` and
`train_backward_gemms`, bf16), of K8's update and norm modes there
(`train_update_gemms`), of the decode attention K14 at the serve's cache
and the 4096-row check (`attention_cases`), of the grouped K3, K9 and K10
at olmoe-1b-7b's (`moe_grouped_gemms`) and of K10's update and norm modes
(`moe_update_gemms`) in the trees that have them, and the registers and
spills that ptxas reports for every instantiation of the GEMM and
attention libraries' CUDA kernels.

    python3 scripts/dense_kernel_ab.py --tree . --tree build/parent --order 1,0,0,1

Each pass runs in a process of its own with the tree's `src/` and
`chip_smoke.py` first on its path, so each tree builds its kernels into
its own `build/` and is timed by its own code; `--order` lists the trees'
indices, one pass each (parent, change, change, parent reads a drift of
the card between passes).  Times: CUDA events around a captured graph of
20+ calls with the weights (K14: the caches) rotated past the 50 MB L2, as
`chip_smoke.py` times them; each pass also records which GEMM kernel (and
its configuration: the cluster kernel's K layers, the wgmma kernels' C
tile) each K1/K2 and K7 row launched, where its tree counts that.
Prints one JSON line per pass and, last, a summary: each row's times by
tree, each tree's mean over the `--base` tree's (default 1), the ptxas
counts of every kernel the trees share by name, side by side, those of
each tree's other kernels, and which shared kernels compiled to different
machine code (a digest of each kernel's SASS instructions, from
`cuobjdump -sass` of each tree's libraries; addresses, encodings and line
information left out).
Needs a CUDA device, nvcc and cuobjdump.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FUNCTION = re.compile(r"Function : (\S+)")
_SASS = re.compile(r"/\*[0-9a-f]+\*/\s+(.+?)\s*;")
_LIBRARIES = ("sfc_gemm_fused", "sfc_attention")
_HYPER_STEP, _HYPER_SCALE, _SALT = 7, 0.37, (3 << 16) + 5


def _demangle(names):
    """The kernels' names without the per-file hash of their anonymous
    namespace, so that two trees' names compare: demangled by c++filt, or
    the mangled name with the hash cut out."""
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True, check=True)
        return dict(zip(names, res.stdout.splitlines()))
    except (OSError, subprocess.CalledProcessError):
        return {n: re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", n) for n in names}


def _latest(tree: Path, pattern: str) -> list:
    """The newest file of each library under the tree's build/ that
    matches ``pattern`` (``{lib}`` stands for the library's name)."""
    found = []
    for lib in _LIBRARIES:
        files = sorted((tree / "build").glob(pattern.format(lib=lib)), key=lambda p: p.stat().st_mtime)
        found += files[-1:]
    if not found:
        raise FileNotFoundError(f"no {pattern.format(lib='*')} under {tree / 'build'}")
    return found


def ptxas_counts(tree: Path) -> dict:
    """{kernel name: [registers, spill store bytes, spill load bytes]}
    from the nvcc.log of the tree's GEMM and attention library builds."""
    out, name, spill = {}, None, None
    for log in _latest(tree, "{lib}-*/nvcc.log"):
        for line in log.read_text().splitlines():
            if m := _ENTRY.search(line):
                name, spill = m.group(1), None
            elif name and (m := _SPILL.search(line)):
                spill = [int(m.group(1)), int(m.group(2))]
            elif name and (m := _REGS.search(line)):
                out[name] = [int(m.group(1)), *(spill or [0, 0])]
                name = None
    names = _demangle(list(out))
    return {names[n]: v for n, v in out.items()}


def _sass_digests(lines) -> dict:
    """{mangled kernel name: sha1 of its SASS instructions} from the lines
    of `cuobjdump -sass`; addresses, encodings and line information do not
    enter the digest."""
    out, name, digest = {}, None, None
    for line in lines:
        if m := _FUNCTION.search(line):
            if name:
                out[name] = digest.hexdigest()
            name, digest = m.group(1), hashlib.sha1()
        elif name and (m := _SASS.search(line)):
            digest.update(m.group(1).encode() + b"\n")
    if name:
        out[name] = digest.hexdigest()
    return out


def sass_digests(tree: Path) -> dict:
    """{kernel name: `_sass_digests` digest} of the tree's GEMM and
    attention libraries, read as `cuobjdump -sass` streams them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in _latest(tree, "{lib}-*/lib{lib}.so"):
        with subprocess.Popen([tool, "-sass", str(lib)], stdout=subprocess.PIPE, text=True) as proc:
            out.update(_sass_digests(proc.stdout))
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {lib} with exit code {proc.returncode}")
    names = _demangle(list(out))
    return {names[n]: v for n, v in out.items()}


def worker(tree: Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import sfc_attention as tsa
    from repro_torch.kernels import sfc_gemm as tk

    build.load_all()
    cfg = get_config("qwen3_4b")
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, kernels = {}, {}
    for gm in cs.main_path_gemms(cfg):
        lead = (gm.batch,) if gm.batch else ()
        a = torch.randn((*lead, gm.m, gm.k), generator=gen, device=dev).to(dt)
        copies = max(1, math.ceil(4 * cs.L2_BYTES / (gm.k * gm.n * 2 * (2 if gm.glu else 1))))
        ws = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)]
        gs = [(torch.randn((gm.k, gm.n), generator=gen, device=dev) * 0.02).to(dt) for _ in range(copies)] \
            if gm.glu else None
        kw = dict(preact=True) if gm.preact else dict(activation=cfg.act if gm.glu else None)
        rows[f"K1/K2 {gm.name}"] = cs.time_ms(
            lambda i: tk.sfc_gemm_fused(a, ws[i % copies], gs[i % copies] if gs else None, **kw),
            reps=max(20, copies), graph=True)
        # after the timing, so that both trees allocate alike before it
        by_kernel = getattr(tk.sfc_gemm_fused, "launches_by_kernel", None)
        if by_kernel is not None:
            _, kernels[f"K1/K2 {gm.name}"] = cs.launched(
                by_kernel, lambda: tk.sfc_gemm_fused(a, ws[0], gs[0] if gs else None, **kw))
        del a, ws, gs
    for c in cs.attention_cases(cfg):
        if c.kernel != "sfc_decode_attention":
            continue
        copies = max(1, math.ceil(4 * cs.L2_BYTES / c.bytes(2)))
        ins = [tuple(torch.randn(s, generator=gen, device=dev).to(dt) for s in
                     ((c.b, 1, c.h, c.d), (c.b, c.t, c.hkv, c.d), (c.b, c.t, c.hkv, c.d))) for _ in range(copies)]
        valid = torch.tensor(c.valid, dtype=torch.int32, device=dev)
        rows[f"K14 {c.name}"] = cs.time_ms(lambda i: tsa.sfc_decode_attention(*ins[i % copies], valid),
                                           reps=max(20, copies), graph=True)
        del ins
    for gm in cs.train_backward_gemms(cfg):
        m, k, n = gm.m, gm.k, gm.n
        copies = max(1, math.ceil(4 * cs.L2_BYTES / gm.bytes(2)))
        r = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale).to(dt)  # noqa: E731
        if gm.kind == "nt":
            fn = tk.sfc_gemm_nt
            ins = [(r(m, n), r(k, n, scale=0.02)) + ((r(m, n), r(k, n, scale=0.02)) if gm.dual else ())
                   for _ in range(copies)]
        else:
            fn = tk.sfc_gemm_tn
            ins = [(r(m, k), r(m, n)) + ((r(m, n),) if gm.dual else ()) for _ in range(copies)]
        rows[f"{'K7' if gm.kind == 'nt' else 'K8'} {gm.name}"] = cs.time_ms(
            lambda i: fn(*ins[i % copies]), reps=max(20, copies), graph=True)
        by_kernel = getattr(fn, "launches_by_kernel", None)
        if by_kernel is not None:
            _, kernels[f"K7 {gm.name}"] = cs.launched(by_kernel, lambda: fn(*ins[0]))
        del ins
    if hasattr(cs, "train_update_gemms"):
        rows.update(_update_rows(torch, cs, tk, cs.train_update_gemms(cfg), gen, "K8"))
    if hasattr(cs, "moe_grouped_gemms"):
        fns = {"fwd": ("K3", tk.sfc_gemm_grouped), "nt": ("K9", tk.sfc_gemm_grouped_nt),
               "tn": ("K10", tk.sfc_gemm_grouped_tn)}
        for gm in cs.moe_grouped_gemms(get_config("olmoe_1b_7b")):
            label, fn = fns[gm.kind]
            # each launch streams every expert's weights, far past the L2
            args, kw, _ = cs._grouped_operands(torch, gm, dt, gen)
            gs = dict(group_sizes=(gm.rows,) * gm.experts)
            rows[f"{label} {gm.name}"] = cs.time_ms(lambda i: fn(*args, **gs, **kw), reps=20, graph=True)
            del args
            torch.cuda.empty_cache()
    if hasattr(cs, "moe_update_gemms"):
        rows.update(_update_rows(torch, cs, tk, cs.moe_update_gemms(get_config("olmoe_1b_7b")), gen, "K10"))
    return {"tree": str(tree), "ms": rows, "k1_kernels": kernels, "ptxas": ptxas_counts(tree)}


def _update_rows(torch, cs, tk, gemms, gen, label):
    """Times of the update mode (bf16, stochastic rounding) and the norm
    mode of K8 (`sfc_gemm_tn`) or K10 (`sfc_gemm_grouped_tn`) at each of
    ``gemms``; one copy of the inputs (the trees compare alike)."""
    from repro_torch.optim import adamw as opt

    dev, dt = torch.device("cuda"), torch.bfloat16
    hyper = opt.pack_adamw_hyper(opt.AdamWConfig(lr=1e-2), torch.tensor(_HYPER_STEP, dtype=torch.int32, device=dev),
                                 torch.tensor(_HYPER_SCALE, device=dev))
    grouped = label == "K10"
    fn = tk.sfc_gemm_grouped_tn if grouped else tk.sfc_gemm_tn
    out = {}
    for gm in gemms:
        t = gm.t if grouped else gm.m
        stack = (gm.experts, gm.k, gm.n) if grouped else (gm.k, gm.n)
        kw = dict(group_sizes=(gm.rows,) * gm.experts) if grouped else {}
        r = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev) * scale)  # noqa: E731
        x, dcs = r(t, gm.k).to(dt), [r(t, gm.n).to(dt) for _ in range(gm.sets)]
        sets = [(r(*stack, scale=0.02), r(*stack, scale=0.5), r(*stack) ** 2 + 1.0) for _ in range(gm.sets)]
        ws = [st[0].to(dt) for st in sets]
        state = [*sets[0], *(sets[1] if gm.sets == 2 else (None,) * 3)]
        upd = dict(w=ws[0], w2=ws[1] if gm.sets == 2 else None, salt=_SALT, stochastic_round=True, **kw)
        dc2 = dcs[1] if gm.sets == 2 else None
        out[f"{label} update {gm.name}"] = cs.time_ms(lambda i: fn(x, dcs[0], dc2, *state, hyper, **upd), reps=20,
                                                      graph=True)
        out[f"{label} norm {gm.name}"] = cs.time_ms(lambda i: fn(x, dcs[0], dc2, norm=True, **kw), reps=20,
                                                    graph=True)
        del x, dcs, sets, ws, state, upd
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="a source tree (repeat)")
    ap.add_argument("--order", default=None, help="comma-separated tree indices, one pass each")
    ap.add_argument("--base", type=int, default=1, help="the tree the others' times are divided by")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trees = [Path(t).resolve() for t in args.tree]
    if args.worker:
        print(json.dumps(worker(trees[0])), flush=True)
        return 0
    order = [int(i) for i in args.order.split(",")] if args.order else list(range(len(trees)))
    passes = []
    for i in order:
        res = subprocess.run([sys.executable, __file__, "--worker", "--tree", str(trees[i])],
                             capture_output=True, text=True, env={**os.environ, "PYTHONPATH": ""})
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"pass over {trees[i]} failed with exit code {res.returncode}")
        passes.append((i, json.loads(res.stdout.strip().splitlines()[-1])))
        print(json.dumps({"pass": len(passes), "tree_index": i, **passes[-1][1]}), flush=True)
    by_tree = {i: [p for j, p in passes if j == i] for i in sorted(set(order))}
    ms = {}
    for row in dict.fromkeys(r for _, p in passes for r in p["ms"]):
        ms[row] = {str(i): [p["ms"][row] for p in ps] for i, ps in by_tree.items() if row in ps[0]["ms"]}
        if str(args.base) in ms[row]:
            base = statistics.mean(ms[row][str(args.base)])
            ms[row]["over_base"] = {i: statistics.mean(v) / base for i, v in ms[row].items() if i != str(args.base)}
    shared = sorted(set.intersection(*(set(ps[0]["ptxas"]) for ps in by_tree.values())))
    ptxas = {n: {str(i): ps[0]["ptxas"][n] for i, ps in by_tree.items()} for n in shared}
    changed = {n: v for n, v in ptxas.items() if len({tuple(c) for c in v.values()}) > 1}
    sass = [sass_digests(trees[i]) for i in sorted(by_tree)]
    sass_differ = sorted(n for n in shared if len({d.get(n) for d in sass}) > 1)
    only = {}  # kernels of one tree alone (a new kernel's first counts)
    for i, ps in by_tree.items():
        own = sorted(set(ps[0]["ptxas"]) - set(shared))
        only[str(i)] = {n: ps[0]["ptxas"][n] for n in own}
    print(json.dumps({"trees": [str(t) for t in trees], "order": order, "base": args.base, "ms": ms,
                      "k1_kernels": {str(i): ps[0].get("k1_kernels", {}) for i, ps in by_tree.items()},
                      "ptxas_registers_spill_st_spill_ld": ptxas, "ptxas_changed": changed,
                      "kernels_compared": len(shared), "ptxas_only_in_tree": only,
                      "sass_identical": len(shared) - len(sass_differ), "sass_differ": sass_differ}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
