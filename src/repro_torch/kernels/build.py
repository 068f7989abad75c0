"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes) under ``build/`` at the repository root,
keyed by a digest of the source, every ``csrc/`` header it includes, and
the flags, and loaded with ``ctypes``.  Two libraries:

* ``sfc_gemm_fused.cu``, compiled once per (input type, GLU, activation)
  part, each part with its epilogue flags as template parameters, plus two
  backward parts per input type (``-DSFC_BWD=1``: the NT and TN kernels;
  ``-DSFC_BWD=2``: the TN kernel with its update / norm flush); the
  forward, NT, TN and TN-update entries also take the grouped (MoE
  expert) mode of K3, K9 and K10 (dW, update and norm) through a
  per-expert row array and launch it as kernels of their own in the same
  parts, so it adds no part; one replicated part per input type
  (``-DSFC_REP=1``: the split-K partial products K4/K5 and the layer sum
  K6), which leaves every other part's code as it was; and the ABFT
  checksum lanes (``-DSFC_ABFT=1``), a twin of each forward part (K1/K2 and
  K3 with the lane) and, per input type, a TN part (K8 dW) and a TN-update
  part (K8's update and norm modes), each behind entries of its own, so the
  parts without the lane keep their code; the bf16 replicated part also
  holds K4 at M <= ``SPLIT_MAX_ROWS`` on a cluster kernel and K5 (and K4
  past those rows) on the wgmma main loop (``rep_entry_name("cluster" /
  "wgmma", "bf16")``); the bf16 forward parts and their
  lane twins also hold the cluster kernel (K1 at M <= ``SPLIT_MAX_ROWS``)
  and the wgmma kernel (K2, and K1 past those rows, on TMA and wgmma; with
  the per-expert row array its grouped mode, K3), each behind entries of
  its own (`cluster_entry_name`, `wgmma_entry_name`), and the bf16
  backward part the wgmma NT kernel (K7, and grouped K9, ``bwd_entry_name(
  "nt_wgmma", "bf16")``) and the wgmma TN kernels (K8 and K10 dW,
  ``"tn_wgmma"``), the bf16 TN-update part their norm and update modes
  (``"tn_update_wgmma"``), and the bf16 TN lane parts K8's twins of both
  (``abft=True``); the bf16 part of (no GLU, no activation) and its lane
  twin also hold K1/K2's f32-output mode, on the tile kernel and on the
  wgmma kernel, behind entries of their own (`f32out_entry_name`); the
  wgmma main loop is ``csrc/sfc_gemm_wgmma.cuh``'s;
* ``sfc_attention.cu``, compiled once per (input type, half), each part
  holding, for the head dims in ``ATTN_HEAD_DIMS``, the flash-forward and
  decode kernels (half 0) or the flash backward's dQ and dK/dV kernels
  (half 1); the bf16 forward part also holds the wgmma flash forward
  (K11 and K15, ``flash_fwd_wgmma_kernel``, entry ``attn_entry_name(
  "fwd_wgmma", "bf16", D)``), the bf16 backward part the backward's wgmma
  kernels (K12
  ``flash_bwd_dq_wgmma_kernel``, K13 ``flash_bwd_dkv_wgmma_kernel``) behind
  entries of their own (``attn_entry_name("dq_wgmma" / "dkv_wgmma",
  "bf16", D)``) and ``sfc_tensor_map_encode_ns``, which times the host's
  tensor-map encoding; the Hopper primitives both libraries' wgmma kernels
  use are in ``csrc/hopper.cuh``.

A library's parts are compiled by parallel ``nvcc`` processes and linked
into one ``.so``; `load_all` starts the parts of every library that is not
built yet at the same time.  Each part's compiler output (``-Xptxas -v``:
registers, shared memory, spills) is kept in ``nvcc.log`` beside the
library.  Nothing here runs at import: the CPU tests import this module on
machines with no ``nvcc``.

Failures have types of their own, which the fallback ladder
(`robust.ladder.classify_failure`) reads: `KernelBuildError` for a build
that failed (the installation is broken, so no rung may hide it) and
`KernelLaunchError`, carrying the ``cudaError_t`` code, for a launch the
runtime refused.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "KernelBuildError",
    "KernelLaunchError",
    "TILE",
    "ATTN_TILE",
    "ATTN_DKV_TILE",
    "ATTN_HEAD_DIMS",
    "MAX_DECODE_GROUPS",
    "DECODE_CHUNK",
    "MAX_DECODE_SPLITS",
    "MAX_BWD_CLUSTER",
    "MAX_FWD_WARPGROUPS",
    "FWD_WGMMA_STAGES",
    "SPLIT_MAX_ROWS",
    "MAX_CLUSTER_LAYERS",
    "WGMMA_TILE",
    "WGMMA_BK",
    "WGMMA_LANE_SLOTS",
    "ACTIVATION_CODES",
    "DTYPE_NAMES",
    "entry_name",
    "cluster_entry_name",
    "wgmma_entry_name",
    "f32out_entry_name",
    "bwd_entry_name",
    "rep_entry_name",
    "attn_entry_name",
    "source_digest",
    "load_library",
    "load_attention_library",
    "load_all",
]



class KernelBuildError(RuntimeError):
    """nvcc is missing, or a part failed to compile or link."""


class KernelLaunchError(RuntimeError):
    """A kernel launch that returned a CUDA error; ``code`` is the
    ``cudaError_t`` value."""

    def __init__(self, what: str, code: int):
        self.code = int(code)
        super().__init__(f"{what} launch failed with CUDA error {self.code}")


# (bm, bn) of the C tile one CTA computes: kBM / kBN in csrc/sfc_gemm_fused.cu
TILE: Tuple[int, int] = (64, 64)
# (q rows, k rows) of one flash-forward tile: kBQ / kBK in csrc/sfc_attention.cu
ATTN_TILE: Tuple[int, int] = (64, 64)
# (q rows, k rows) of one dK/dV tile per input type: dkv_bq() / kBK in
# csrc/sfc_attention.cu (the f32 tile takes 32 q rows to fit shared memory);
# the dQ kernel uses ATTN_TILE
ATTN_DKV_TILE: Dict[str, Tuple[int, int]] = {"bf16": (64, 64), "f32": (32, 64)}
# head dims the attention kernels are compiled for (SFC_*_ENTRY in the source)
ATTN_HEAD_DIMS: Tuple[int, ...] = (64, 128)
# GQA rows one decode CTA holds: kMaxGroups in csrc/sfc_attention.cu
MAX_DECODE_GROUPS = 16
# cache rows the decode kernel's segments are a multiple of: kDecChunk in
# csrc/sfc_attention.cu
DECODE_CHUNK = 64
# segments (cluster CTAs) of the decode kernel: kMaxSplits in csrc/sfc_attention.cu
MAX_DECODE_SPLITS = 8
# CTAs a cluster of the wgmma dK/dV kernel, each a part of the GQA group (a
# portable cluster): bw::kMaxCluster in csrc/sfc_attention.cu
MAX_BWD_CLUSTER = 8
# consumer warpgroups (q heads of one kv head) a CTA of the wgmma flash
# forward, and its ring's (k, v) stages: fw::kMaxWarpgroups and
# fw::kFwdStages in csrc/sfc_attention.cu
MAX_FWD_WARPGROUPS = 2
FWD_WGMMA_STAGES = 4
# A rows the cluster GEMM kernel takes (kSplitRows) and CTAs (K layers) a
# cluster (kMaxLayers), in csrc/sfc_gemm_fused.cu
SPLIT_MAX_ROWS = 16
MAX_CLUSTER_LAYERS = 8
# (rows, cols) of the wgmma kernels' narrow C tile (the wide one is twice
# as wide; the GLU's are half as wide: B's columns beside the same ones of
# B_gate) and the K of a stage: kBM / kBN and kBK in csrc/sfc_gemm_wgmma.cuh
WGMMA_TILE: Tuple[int, int] = (128, 128)
WGMMA_BK = 64
# the forward wgmma kernels' ABFT partials a task, one a consumer warp:
# kLaneSlots in csrc/sfc_gemm_wgmma.cuh
WGMMA_LANE_SLOTS = 8

ACTIVATION_CODES: Dict[Optional[str], int] = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
DTYPE_NAMES = {"float32": "f32", "bfloat16": "bf16"}
_DTYPE_CODES = {"f32": 0, "bf16": 1}

_CSRC = Path(__file__).resolve().parent / "csrc"
_ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def entry_name(dtype_name: str, glu: bool, activation: Optional[str], abft: bool = False) -> str:
    """C symbol of the fused-GEMM part for one (input type, GLU, activation),
    or of its twin with the ABFT checksum lane."""
    lane = "abft_" if abft else ""
    return f"sfc_gemm_fused_{lane}{dtype_name}_glu{int(glu)}_act{ACTIVATION_CODES[activation]}"


def cluster_entry_name(glu: bool, activation: Optional[str], abft: bool = False) -> str:
    """C symbol of the cluster kernel's entry (K1 at M <= SPLIT_MAX_ROWS,
    split-K across a cluster) in the bf16 part of one (GLU, activation), or
    in its ABFT twin."""
    lane = "abft_" if abft else ""
    return f"sfc_gemm_cluster_{lane}bf16_glu{int(glu)}_act{ACTIVATION_CODES[activation]}"


def wgmma_entry_name(glu: bool, activation: Optional[str], abft: bool = False) -> str:
    """C symbol of the wgmma kernel's entry (K2, and K1 past
    ``SPLIT_MAX_ROWS`` rows) in the bf16 part of one (GLU, activation), or
    in its ABFT twin."""
    lane = "abft_" if abft else ""
    return f"sfc_gemm_wgmma_{lane}bf16_glu{int(glu)}_act{ACTIVATION_CODES[activation]}"


def f32out_entry_name(kind: str, abft: bool = False) -> str:
    """C symbol of K1/K2's f32-output mode (bf16 inputs, no GLU, no
    epilogue): ``kind`` "tile" (the 64 x 64 tile kernel) or "wgmma", in the
    bf16 part of (no GLU, no activation), or in its ABFT twin."""
    if kind not in ("tile", "wgmma"):
        raise ValueError(f"unknown f32-output kind {kind!r}")
    lane = "abft_" if abft else ""
    return f"sfc_gemm_{'fused' if kind == 'tile' else 'wgmma'}_f32out_{lane}bf16"


def bwd_entry_name(kind: str, dtype_name: str, abft: bool = False) -> str:
    """C symbol of a backward GEMM entry: ``kind`` is "nt" (dA), "nt_wgmma"
    (dA on the wgmma kernel, bf16 only), "tn" (dW), "tn_update" (the TN
    kernel's update and norm modes), or "tn_wgmma" / "tn_update_wgmma"
    (the same on the wgmma kernels, bf16 only); ``abft``: the entry with
    the checksum lane (the TN kinds only)."""
    if kind not in ("nt", "nt_wgmma", "tn", "tn_update", "tn_wgmma", "tn_update_wgmma") or (
            abft and kind.startswith("nt")) or (kind.endswith("_wgmma") and dtype_name != "bf16"):
        raise ValueError(f"unknown backward GEMM kind {kind!r} for {dtype_name}"
                         f"{' with the ABFT lane' if abft else ''}")
    return f"sfc_gemm_{kind}_{'abft_' if abft else ''}{dtype_name}"


def rep_entry_name(kind: str, dtype_name: str) -> str:
    """C symbol of a replicated-form entry: ``kind`` is "gemm" (K4/K5, the
    partial copies, on the 64 x 64 tile kernel), "cluster" (K4 at M <=
    ``SPLIT_MAX_ROWS`` on the cluster kernel, bf16 only), "wgmma" (K5, and
    K4 past those rows, on the wgmma kernel, bf16 only) or "add_reduce"
    (K6, their sum)."""
    if kind not in ("gemm", "cluster", "wgmma", "add_reduce") or (
            kind in ("cluster", "wgmma") and dtype_name != "bf16"):
        raise ValueError(f"unknown replicated-form kind {kind!r} for {dtype_name}")
    if kind == "add_reduce":
        return f"sfc_add_reduce_{dtype_name}"
    return f"sfc_gemm_replicated_{'' if kind == 'gemm' else kind + '_'}{dtype_name}"


def attn_entry_name(kind: str, dtype_name: str, head_dim: int) -> str:
    """C symbol of an attention entry: ``kind`` is "fwd", "decode", "dq",
    "dkv", or "fwd_wgmma" / "dq_wgmma" / "dkv_wgmma" (the wgmma kernels,
    bf16 only)."""
    if kind not in ("fwd", "decode", "dq", "dkv", "fwd_wgmma", "dq_wgmma", "dkv_wgmma") or (
            kind.endswith("_wgmma") and dtype_name != "bf16"):
        raise ValueError(f"unknown attention entry kind {kind!r} for {dtype_name}")
    return f"sfc_attn_{kind}_{dtype_name}_d{head_dim}"


def _gemm_parts():
    for dt in _DTYPE_CODES:
        for glu in (False, True):
            for act in ACTIVATION_CODES:
                for abft in (False, True):
                    yield entry_name(dt, glu, act, abft), (
                        f"-DSFC_DTYPE={_DTYPE_CODES[dt]}",
                        f"-DSFC_GLU={int(glu)}",
                        f"-DSFC_ACT={ACTIVATION_CODES[act]}",
                        f"-DSFC_ENTRY={entry_name(dt, glu, act, abft)}",
                        *(("-DSFC_ABFT=1",) if abft else ()),
                        *((f"-DSFC_CLUSTER_ENTRY={cluster_entry_name(glu, act, abft)}",
                           f"-DSFC_WGMMA_ENTRY={wgmma_entry_name(glu, act, abft)}") if dt == "bf16" else ()),
                        *((f"-DSFC_F32_ENTRY={f32out_entry_name('tile', abft)}",
                           f"-DSFC_WGMMA_F32_ENTRY={f32out_entry_name('wgmma', abft)}")
                          if dt == "bf16" and not glu and act is None else ()),
                    )
        yield f"sfc_gemm_bwd_{dt}", (
            f"-DSFC_DTYPE={_DTYPE_CODES[dt]}",
            "-DSFC_BWD=1",
            f"-DSFC_NT_ENTRY={bwd_entry_name('nt', dt)}",
            f"-DSFC_TN_ENTRY={bwd_entry_name('tn', dt)}",
            *((f"-DSFC_NT_WGMMA_ENTRY={bwd_entry_name('nt_wgmma', dt)}",
               f"-DSFC_TN_WGMMA_ENTRY={bwd_entry_name('tn_wgmma', dt)}") if dt == "bf16" else ()),
        )
        yield f"sfc_gemm_tn_update_{dt}", (
            f"-DSFC_DTYPE={_DTYPE_CODES[dt]}",
            "-DSFC_BWD=2",
            f"-DSFC_TNU_ENTRY={bwd_entry_name('tn_update', dt)}",
            *((f"-DSFC_TNU_WGMMA_ENTRY={bwd_entry_name('tn_update_wgmma', dt)}",) if dt == "bf16" else ()),
        )
        yield f"sfc_gemm_tn_abft_{dt}", (
            f"-DSFC_DTYPE={_DTYPE_CODES[dt]}",
            "-DSFC_BWD=1",
            "-DSFC_ABFT=1",
            f"-DSFC_TN_ABFT_ENTRY={bwd_entry_name('tn', dt, abft=True)}",
            *((f"-DSFC_TN_WGMMA_ENTRY={bwd_entry_name('tn_wgmma', dt, abft=True)}",) if dt == "bf16" else ()),
        )
        yield f"sfc_gemm_tn_update_abft_{dt}", (
            f"-DSFC_DTYPE={_DTYPE_CODES[dt]}",
            "-DSFC_BWD=2",
            "-DSFC_ABFT=1",
            f"-DSFC_TNU_ABFT_ENTRY={bwd_entry_name('tn_update', dt, abft=True)}",
            *((f"-DSFC_TNU_WGMMA_ENTRY={bwd_entry_name('tn_update_wgmma', dt, abft=True)}",)
              if dt == "bf16" else ()),
        )
        yield f"sfc_gemm_rep_{dt}", (
            f"-DSFC_DTYPE={_DTYPE_CODES[dt]}",
            "-DSFC_REP=1",
            f"-DSFC_REP_ENTRY={rep_entry_name('gemm', dt)}",
            f"-DSFC_ADD_REDUCE_ENTRY={rep_entry_name('add_reduce', dt)}",
            *((f"-DSFC_REP_CLUSTER_ENTRY={rep_entry_name('cluster', dt)}",
               f"-DSFC_REP_WGMMA_ENTRY={rep_entry_name('wgmma', dt)}") if dt == "bf16" else ()),
        )


def _attention_parts():
    for dt, code in _DTYPE_CODES.items():
        for half, name in ((0, f"sfc_attention_{dt}"), (1, f"sfc_attention_bwd_{dt}")):
            yield name, (f"-DSFC_ATTN_DTYPE={code}", f"-DSFC_ATTN_TAG={dt}", f"-DSFC_ATTN_PART={half}")


def _bind_gemm(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in _DTYPE_CODES:
        for glu in (False, True):
            for act in ACTIVATION_CODES:
                for abft in (False, True):
                    fn = getattr(lib, entry_name(dt, glu, act, abft))
                    fn.argtypes = [
                        ptr, ptr, ptr, ptr, ptr, ptr,  # a, b, b_gate, bias, gate_bias, residual
                        ptr, ptr,  # out, out_gate (preact mode)
                        ptr, i32, i32,  # task table, n_tasks, batch
                        i32, i32, i32,  # M, N, K
                        ctypes.c_longlong, ctypes.c_longlong,  # A / B batch strides (elements)
                        i32, ctypes.c_float,  # has_scale, out_scale
                        i32, i32,  # vec_a, vec_b
                        ptr, i32,  # grouped mode (K3): per-expert (3, E) rows, E; null, 0 otherwise
                        *((ptr,) if abft else ()),  # the lane's (batch * n_tasks) f32 partials
                        ptr,  # cudaStream_t
                    ]
                    fn.restype = i32
                    if dt != "bf16":
                        continue
                    fn = getattr(lib, cluster_entry_name(glu, act, abft))
                    fn.argtypes = [
                        ptr, ptr, ptr, ptr, ptr, ptr,  # a, b, b_gate, bias, gate_bias, residual
                        ptr, ptr,  # out, out_gate (preact mode)
                        ptr, i32,  # task table (2, n_tasks), n_tasks
                        i32, i32, i32,  # M, N, K
                        i32, i32,  # layers (CTAs a cluster), slab (K rows a layer)
                        i32, ctypes.c_float,  # has_scale, out_scale
                        i32, i32,  # vec_a, vec_b
                        *((ptr,) if abft else ()),  # the lane's (n_tasks) f32 partials
                        ptr,  # cudaStream_t
                    ]
                    fn.restype = i32
                    fn = getattr(lib, wgmma_entry_name(glu, act, abft))
                    fn.argtypes = [
                        ptr, ptr, ptr, ptr, ptr, ptr,  # a, b, b_gate, bias, gate_bias, residual
                        ptr, ptr,  # out, out_gate (preact mode)
                        ptr, i32, i32, i32,  # task table (2, tiles), tiles, batch, b_batched
                        i32, i32, i32,  # M (rows a batch element), N, K
                        i32, i32, i32,  # wide (the 128 x 256 tile), CTAs, CTAs a worker
                        i32, ctypes.c_float,  # has_scale, out_scale
                        ptr, i32,  # grouped mode (K3): per-expert (3, E) rows, E; null, 0 otherwise
                        *((ptr,) if abft else ()),  # the lane's (batch * tiles) f32 partials
                        ptr,  # cudaStream_t
                    ]
                    fn.restype = i32
        if dt == "bf16":
            for abft in (False, True):
                fn = getattr(lib, f32out_entry_name("tile", abft))
                fn.argtypes = [
                    ptr, ptr, ptr,  # a, b, out (f32)
                    ptr, i32, i32,  # task table, n_tasks, batch
                    i32, i32, i32,  # M, N, K
                    ctypes.c_longlong, ctypes.c_longlong,  # A / B batch strides (elements)
                    i32, i32,  # vec_a, vec_b
                    *((ptr,) if abft else ()),  # the lane's (batch * n_tasks) f32 partials
                    ptr,  # cudaStream_t
                ]
                fn.restype = i32
                fn = getattr(lib, f32out_entry_name("wgmma", abft))
                fn.argtypes = [
                    ptr, ptr, ptr,  # a, b, out (f32)
                    ptr, i32, i32, i32,  # task table (2, tiles), tiles, batch, b_batched
                    i32, i32, i32,  # M (rows a batch element), N, K
                    i32, i32, i32,  # wide (the 128 x 256 tile), CTAs, CTAs a worker
                    *((ptr,) if abft else ()),  # the lane's (batch * tiles) f32 partials
                    ptr,  # cudaStream_t
                ]
                fn.restype = i32
            fn = getattr(lib, bwd_entry_name("nt_wgmma", dt))
            fn.argtypes = [
                ptr, ptr, ptr, ptr, ptr,  # a, b, a2, b2, out
                ptr, i32,  # task table (2, tiles; grouped (3, tiles)), tiles
                i32, i32, i32,  # R, C, D (output rows, output cols, contraction)
                i32, i32, i32,  # wide (the 128 x 256 tile), CTAs, CTAs a worker
                ptr, i32,  # grouped mode (K9): per-expert (3, E) rows, E; null, 0 otherwise
                ptr,  # cudaStream_t
            ]
            fn.restype = i32
            for abft in (False, True):
                fn = getattr(lib, bwd_entry_name("tn_wgmma", dt, abft))
                fn.argtypes = [
                    ptr, ptr, ptr, ptr, ptr,  # a, b, b2, out, out2
                    ptr, i32, i32,  # task table (2, tiles), tiles, experts (1 but in the grouped mode)
                    i32, i32, i32,  # R, C, D
                    i32, i32,  # CTAs, CTAs a worker
                    ptr,  # grouped mode (K10): per-expert (3, E) rows; null otherwise
                    ptr,  # the lane's (n_sets, experts * tiles) f32 partials (the lane's entry), else null
                    ptr,  # cudaStream_t
                ]
                fn.restype = i32
                fn = getattr(lib, bwd_entry_name("tn_update_wgmma", dt, abft))
                fn.argtypes = [
                    ptr, ptr, ptr, i32,  # a, b, b2, n_sets
                    ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # w, w2, master, mu, nu, master2, mu2, nu2
                    ptr, i32, i32,  # hyper (null: norm mode), salt, stochastic_round
                    ptr,  # partials (n_sets, experts * tiles) f32
                    ptr, i32, i32,  # task table (2, tiles), tiles, experts
                    i32, i32, i32,  # R, C, D
                    i32, i32,  # CTAs, CTAs a worker
                    ptr,  # grouped mode (K10): per-expert (3, E) rows; null otherwise
                    ptr,  # the lane's partials (the lane's entry), else null
                    ptr,  # cudaStream_t
                ]
                fn.restype = i32
        for kind in ("nt", "tn"):
            fn = getattr(lib, bwd_entry_name(kind, dt))
            fn.argtypes = [
                ptr, ptr, ptr, ptr, ptr,  # nt: a, b, a2, b2, out; tn: a, b, b2, out, out2
                ptr, i32,  # task table, n_tasks
                i32, i32, i32,  # R, C, D (output rows, output cols, contraction)
                i32, i32,  # vec_a, vec_b
                ptr, i32,  # grouped mode (K9 / K10): per-expert (3, E) rows, E; null, 0 otherwise
                ptr,  # cudaStream_t
            ]
            fn.restype = i32
        fn = getattr(lib, bwd_entry_name("tn", dt, abft=True))
        fn.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # a, b, b2, out, out2
            ptr, i32,  # task table, n_tasks
            i32, i32, i32,  # R, C, D
            i32, i32,  # vec_a, vec_b
            ptr,  # the lane's (n_sets, n_tasks) f32 partials
            ptr,  # cudaStream_t
        ]
        fn.restype = i32
        fn = getattr(lib, rep_entry_name("gemm", dt))
        fn.argtypes = [
            ptr, ptr, ptr, i32,  # a, b, out, out_f32
            ptr, i32, i32,  # task table (3, n_tasks), n_tasks, batch
            i32, i32, i32,  # M, N, K
            ctypes.c_longlong, ctypes.c_longlong,  # A / B batch strides (elements)
            i32, i32,  # k_layers, k_slab
            i32, i32,  # vec_a, vec_b
            ptr,  # cudaStream_t
        ]
        fn.restype = i32
        if dt == "bf16":
            fn = getattr(lib, rep_entry_name("cluster", dt))
            fn.argtypes = [
                ptr, ptr, ptr, i32,  # a, b, out, out_f32
                ptr, i32,  # task table (3, n_tasks), n_tasks
                i32, i32, i32,  # M, N, K
                i32, i32, i32,  # slab (K rows a layer), split (CTAs a cluster), sub (K rows a CTA)
                i32, i32,  # vec_a, vec_b
                ptr,  # cudaStream_t
            ]
            fn.restype = i32
            fn = getattr(lib, rep_entry_name("wgmma", dt))
            fn.argtypes = [
                ptr, ptr, ptr, i32,  # a, b, out, out_f32
                ptr, i32, i32, i32,  # task table (3, tiles), tiles, batch, b_batched
                i32, i32, i32,  # M (rows a batch element), N, K
                i32, i32,  # k_layers, slab
                i32, i32, i32,  # wide (the 128 x 256 tile), CTAs, CTAs a worker
                ptr,  # cudaStream_t
            ]
            fn.restype = i32
        fn = getattr(lib, rep_entry_name("add_reduce", dt))
        fn.argtypes = [
            ptr, ptr, i32, i32, ctypes.c_longlong, i32,  # copies, out, L, batch, M*N, vec
            i32, i32, i32,  # threads a CTA, vectors a thread, CTAs a batch element
            ptr,  # cudaStream_t
        ]
        fn.restype = i32
        fn = getattr(lib, bwd_entry_name("tn_update", dt))
        fn.argtypes = [
            ptr, ptr, ptr, i32,  # a, b, b2, n_sets
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # w, w2, master, mu, nu, master2, mu2, nu2
            ptr, i32, i32,  # hyper (null: norm mode), salt, stochastic_round
            ptr,  # partials (n_sets, n_tasks) f32
            ptr, i32,  # task table, n_tasks
            i32, i32, i32,  # R, C, D
            i32, i32,  # vec_a, vec_b
            ptr, i32,  # grouped mode (K10): per-expert (3, E) rows, E; null, 0 otherwise
            ptr,  # cudaStream_t
        ]
        fn.restype = i32
        lane = getattr(lib, bwd_entry_name("tn_update", dt, abft=True))
        # the same arguments without the grouped mode, plus the lane's partials
        lane.argtypes = fn.argtypes[:-3] + [ptr, ptr]
        lane.restype = i32


def _bind_attention(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for dt in _DTYPE_CODES:
        for d in ATTN_HEAD_DIMS:
            fwd = getattr(lib, attn_entry_name("fwd", dt, d))
            fwd.argtypes = [
                ptr, ptr, ptr, ptr, ptr,  # q, k, v, o, lse (may be null)
                ptr, ptr,  # k tile per task, row starts
                i32, i32, i32, i32,  # nq, batch, H, groups
                i32, i32, i32, i32,  # S, T, seq_q, seq_k
                i32, i32,  # q_offset, causal
                i64, i64, i64, i64, i64, i64, i64, i64, i64,  # q, k, v strides (batch, seq, head)
                ctypes.c_float,  # scale
                ptr,  # cudaStream_t
            ]
            fwd.restype = i32
            if dt == "bf16":
                fwd_wg = getattr(lib, attn_entry_name("fwd_wgmma", dt, d))
                # the forward's arguments, then W (warpgroups a CTA)
                fwd_wg.argtypes = fwd.argtypes[:-1] + [i32, ptr]
                fwd_wg.restype = i32
            dec = getattr(lib, attn_entry_name("decode", dt, d))
            dec.argtypes = [
                ptr, ptr, ptr, ptr, ptr,  # q, k, v, valid_len, o
                i32, i32, i32, i32,  # batch, H, Hkv, T
                i64, i64, i64, i64, i64, i64,  # k, v strides (batch, seq, head)
                ctypes.c_float,  # scale
                i32, i32,  # splits (CTAs a cluster), seg (cache rows a segment)
                ptr,  # cudaStream_t
            ]
            dec.restype = i32
            for kind in ("dq", "dkv", "dq_wgmma", "dkv_wgmma"):
                if kind.endswith("_wgmma") and dt != "bf16":
                    continue
                bwd = getattr(lib, attn_entry_name(kind, dt, d))
                bwd.argtypes = [
                    ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, dO, lse, delta
                    *((ptr,) if kind.startswith("dq") else (ptr, ptr)),  # dq, or dk and dv
                    ptr, ptr, i32,  # other tile per task, row starts, rows
                    i32, i32, i32,  # batch, H, groups
                    i32, i32, i32, i32,  # S, T, seq_q, seq_k
                    i32, i32,  # q_offset, causal
                    ptr,  # 12 strides (q, k, v, dO; batch, seq, head), int64 on the host
                    ctypes.c_float,  # scale
                    *((i32,) if kind == "dkv_wgmma" else ()),  # CTAs a cluster, a divisor of the group
                    ptr,  # cudaStream_t
                ]
                bwd.restype = i32
    enc = lib.sfc_tensor_map_encode_ns
    enc.argtypes = [ptr, i32, i32]  # a 16-byte aligned device pointer, rank (3 or 4), repetitions
    enc.restype = ctypes.c_double


@dataclasses.dataclass(frozen=True)
class _Library:
    name: str
    source: str  # file under csrc/
    parts: Callable[[], Iterable[Tuple[str, Tuple[str, ...]]]]  # (object name, -D flags)
    bind: Callable[[ctypes.CDLL], None]


_GEMM = _Library("sfc_gemm_fused", "sfc_gemm_fused.cu", _gemm_parts, _bind_gemm)
_ATTENTION = _Library("sfc_attention", "sfc_attention.cu", _attention_parts, _bind_attention)


def _build_root() -> Path:
    # src/repro_torch/kernels/build.py -> the repository root
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _sources(src: Path) -> List[Path]:
    """``src`` and every file it includes with ``#include "..."`` that lies
    beside it, recursively, in a fixed order."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            inc = (path.parent / name).resolve()
            if inc.exists():
                todo.append(inc)
    return seen


def source_digest(src: Path, flags: Iterable[str] = ()) -> str:
    """12-hex digest of a source, the local headers it includes, and flags."""
    digest = hashlib.sha1()
    for path in _sources(src):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:12]


def _lib_path(lib: _Library) -> Path:
    flags = _ARCH_FLAGS + _FLAGS + tuple(f for _, fl in lib.parts() for f in fl)
    digest = source_digest(_CSRC / lib.source, flags)
    return _build_root() / f"{lib.name}-{digest}" / f"lib{lib.name}.so"


def _start(nvcc: str, lib: _Library, out_lib: Path):
    """Start one nvcc process per part of ``lib`` in a scratch directory
    beside ``out_lib``; returns what `_finish` needs."""
    out_lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=out_lib.parent)
    procs = []
    for name, flags in lib.parts():
        obj = Path(tmp.name) / f"{name}.o"
        cmd = [nvcc, *_ARCH_FLAGS, *_FLAGS, *flags, "-c", str(_CSRC / lib.source), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    return nvcc, out_lib, tmp, procs


def _finish(job) -> None:
    """Wait for the parts, link them, keep the compiler log, and move the
    library into place atomically (another process may build the same
    digest)."""
    nvcc, out_lib, tmp, procs = job
    with tmp:
        logs, failed = [], []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            text = f"$ {' '.join(cmd)}\n{out.decode(errors='replace')}"
            logs.append(text)
            if proc.returncode != 0:
                failed.append(text)
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp.name) / out_lib.name
        link = [nvcc, *_ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n$ {' '.join(link)}\n{res.stdout.decode(errors='replace')}")
        (out_lib.parent / "nvcc.log").write_text("\n".join(logs))
        os.replace(tmp_lib, out_lib)


def _ensure_built(libs: Iterable[_Library]) -> None:
    missing = [(lib, path) for lib in libs if not (path := _lib_path(lib)).exists()]
    if not missing:
        return
    nvcc = _nvcc()
    jobs = [_start(nvcc, lib, path) for lib, path in missing]
    for job in jobs:
        _finish(job)


@functools.lru_cache(maxsize=None)
def _load(lib: _Library) -> ctypes.CDLL:
    _ensure_built([lib])
    handle = ctypes.CDLL(str(_lib_path(lib)))
    lib.bind(handle)
    return handle


def load_library() -> ctypes.CDLL:
    """The fused-GEMM library, built on first use into ``build/``."""
    return _load(_GEMM)


def load_attention_library() -> ctypes.CDLL:
    """The attention library (flash forward, decode and the flash
    backward), built on first use."""
    return _load(_ATTENTION)


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build every library that is not built yet, all parts at once, and
    load them all: ``{"sfc_gemm_fused": ..., "sfc_attention": ...}``."""
    libs = (_GEMM, _ATTENTION)
    _ensure_built(libs)
    return {lib.name: _load(lib) for lib in libs}

