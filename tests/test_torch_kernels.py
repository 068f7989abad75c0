"""The port's CUDA kernel on the card, against its plain PyTorch version, and
the build's bookkeeping on the CPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch (the repository's conftest needs JAX; skip it):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

On a machine without a card the tests marked ``cuda`` skip.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import sfc_gemm as tk  # noqa: E402

CU_SOURCE = Path(build.__file__).resolve().parent / "csrc" / "sfc_gemm_fused.cu"


def test_python_tile_matches_the_compiled_tile():
    src = CU_SOURCE.read_text()
    bm = int(re.search(r"constexpr int kBM = (\d+);", src).group(1))
    bn = int(re.search(r"constexpr int kBN = (\d+);", src).group(1))
    assert build.TILE == (bm, bn) == tk.kernel_tile()


def test_every_part_has_its_own_entry_point():
    names = {build.entry_name(dt, glu, act) for dt in ("f32", "bf16") for glu in (False, True)
             for act in build.ACTIVATION_CODES}
    assert len(names) == 16
    assert build.entry_name("bf16", True, "silu") == "sfc_gemm_fused_bf16_glu1_act1"


def test_wrapper_rejects_other_devices_and_counts_nothing_on_cpu():
    a, b = torch.ones(4, 8), torch.ones(8, 8)
    before = tk.sfc_gemm_fused.launches
    out = tk.sfc_gemm_fused(a, b, activation="relu")
    assert torch.equal(out, torch.full((4, 8), 8.0))
    assert tk.sfc_gemm_fused.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.sfc_gemm_fused(a.to("meta"), b.to("meta"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(dtype, seed=10):
    rng = np.random.default_rng(seed)
    shapes = [(3, 77, 203), (203, 133), (203, 133), (133,), (1, 133), (3, 77, 133)]
    scales = [1.0, 0.1, 0.1, 1.0, 1.0, 1.0]
    return [torch.from_numpy((rng.standard_normal(s) * c).astype(np.float32)).to("cuda", dtype)
            for s, c in zip(shapes, scales)]


def _agree(got, want, dtype):
    err = (got.float() - want.float()).abs()
    p = want.float().abs()
    # f32: rtol 1e-4 (+1e-5 of the largest value for sums that cancel);
    # bf16: one output rounding, 2^-7 |p| + 1e-3 max|p|
    bound = (1e-4 * p + 1e-5 * p.max()) if dtype == torch.float32 else (2.0**-7 * p + 1e-3 * p.max())
    return bool(torch.isfinite(got.float()).all()) and bool((err <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "case",
    ["batched_glu_every_flag", "plain_relu_bias_residual", "batched_silu", "per_batch_weights", "glu_no_act"],
)
def test_kernel_matches_plain_version_on_card(dtype, case):
    _card()
    dt = getattr(torch, dtype)
    a, b, bg, bias, gbias, res = _inputs(dt)
    args, kw = {
        "batched_glu_every_flag": ((a, b, bg, bias, gbias, res), dict(activation="gelu", out_scale=0.7)),
        "plain_relu_bias_residual": ((a[0], b, None, bias, None, res[0]), dict(activation="relu")),
        "batched_silu": ((a, b), dict(activation="silu")),
        "per_batch_weights": ((a, b[None].repeat(3, 1, 1).contiguous()), dict(out_scale=2.0)),
        "glu_no_act": ((a[1], b, bg), dict()),
    }[case]
    before = tk.sfc_gemm_fused.launches
    got = tk.sfc_gemm_fused(*args, **kw)
    torch.cuda.synchronize()
    assert tk.sfc_gemm_fused.launches == before + 1
    want = tk.sfc_gemm_fused_plain(*args, bm=64, bn=64, **kw)
    assert got.dtype == dt and got.shape == want.shape
    assert _agree(got, want, dt)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    _card()
    a, b = torch.ones(4, 8, device="cuda"), torch.ones(8, 8, device="cuda")
    with pytest.raises(TypeError):
        tk.sfc_gemm_fused(a.half(), b.half())
    with pytest.raises(TypeError):
        tk.sfc_gemm_fused(a, b, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="compiled for"):
        tk.sfc_gemm_fused(a, b, bm=32, bn=32)
    with pytest.raises(ValueError, match="contiguous"):
        tk.sfc_gemm_fused(a, torch.ones(8, 8, device="cuda").T)
    with pytest.raises(ValueError, match="is on"):
        tk.sfc_gemm_fused(a, b.cpu())
