"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes) under ``build/`` at the repository root,
keyed by a digest of the source and flags, and loaded with ``ctypes``.

``sfc_gemm_fused.cu`` is compiled once per (input type, GLU, activation)
part, all parts at the same time, each part with its epilogue flags as
template parameters; the objects are then linked into one library.
Nothing here runs at import: the CPU tests import this module on machines
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = [
    "TILE",
    "ACTIVATION_CODES",
    "DTYPE_NAMES",
    "entry_name",
    "load_library",
]

# (bm, bn) of the C tile one CTA computes: kBM / kBN in csrc/sfc_gemm_fused.cu
TILE: Tuple[int, int] = (64, 64)

ACTIVATION_CODES: Dict[Optional[str], int] = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
DTYPE_NAMES = {"float32": "f32", "bfloat16": "bf16"}
_DTYPE_CODES = {"f32": 0, "bf16": 1}

_CSRC = Path(__file__).resolve().parent / "csrc"
_ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")


def entry_name(dtype_name: str, glu: bool, activation: Optional[str]) -> str:
    """C symbol of the fused-GEMM part for one (input type, GLU, activation)."""
    return f"sfc_gemm_fused_{dtype_name}_glu{int(glu)}_act{ACTIVATION_CODES[activation]}"


def _parts():
    for dt in _DTYPE_CODES:
        for glu in (False, True):
            for act in ACTIVATION_CODES:
                yield dt, glu, act


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
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _part_flags(dt: str, glu: bool, act: Optional[str]) -> Tuple[str, ...]:
    return (
        f"-DSFC_DTYPE={_DTYPE_CODES[dt]}",
        f"-DSFC_GLU={int(glu)}",
        f"-DSFC_ACT={ACTIVATION_CODES[act]}",
        f"-DSFC_ENTRY={entry_name(dt, glu, act)}",
    )


def _compile(nvcc: str, src: Path, out_lib: Path) -> None:
    """Compile every part at once, link them, and move the library into
    place atomically (another process may be building the same digest)."""
    out_lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_lib.parent) as tmp:
        procs = []
        for dt, glu, act in _parts():
            obj = Path(tmp) / f"{entry_name(dt, glu, act)}.o"
            cmd = [nvcc, *_ARCH_FLAGS, *_FLAGS, *_part_flags(dt, glu, act), "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for cmd, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{log.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out_lib.name
        link = [nvcc, *_ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n{res.stdout.decode(errors='replace')}")
        os.replace(tmp_lib, out_lib)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt, glu, act in _parts():
        fn = getattr(lib, entry_name(dt, glu, act))
        fn.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # a, b, b_gate, bias, gate_bias, residual, out
            ptr, i32, i32,  # task table, n_tasks, batch
            i32, i32, i32,  # M, N, K
            ctypes.c_longlong, ctypes.c_longlong,  # A / B batch strides (elements)
            i32, ctypes.c_float,  # has_scale, out_scale
            i32, i32,  # vec_a, vec_b
            ptr,  # cudaStream_t
        ]
        fn.restype = i32


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The fused-GEMM library, built on first use into ``build/``."""
    src = _CSRC / "sfc_gemm_fused.cu"
    nvcc = _nvcc()
    digest = hashlib.sha1()
    digest.update(src.read_bytes())
    digest.update(" ".join(_ARCH_FLAGS + _FLAGS).encode())
    lib_path = _build_root() / f"sfc_gemm_fused-{digest.hexdigest()[:12]}" / "libsfc_gemm_fused.so"
    if not lib_path.exists():
        _compile(nvcc, src, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _bind(lib)
    return lib
