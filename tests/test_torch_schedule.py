"""The port's schedule substrate against the JAX package's: gilbert tables,
compiled task tables and spec keys must be byte-identical."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import schedule as jsched  # noqa: E402
from repro.core import sfc as jsfc  # noqa: E402
from repro_torch.core import namespaces as tns  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import sfc as tsfc  # noqa: E402


def _same(spec_fn_name, *args, **kwargs):
    j = jsched.compile_schedule(getattr(jsched, spec_fn_name)(*args, **kwargs))
    t = tsched.compile_schedule(getattr(tsched, spec_fn_name)(*args, **kwargs))
    assert t.table.dtype == j.table.dtype == np.int32
    assert t.table.shape == j.table.shape
    assert t.table.tobytes() == j.table.tobytes()
    assert t.key == j.key
    assert t.columns == j.columns
    assert not t.table.flags.writeable


@pytest.mark.parametrize(
    "width,height", [(1, 1), (1, 7), (7, 1), (4, 4), (5, 3), (3, 5), (16, 9), (2, 2374)]
)
def test_gilbert_tables_byte_identical(width, height):
    assert tsfc.sfc_coord_table(width, height).tobytes() == jsfc.sfc_coord_table(width, height).tobytes()
    assert tsfc.sfc_inverse_table(width, height).tobytes() == jsfc.sfc_inverse_table(width, height).tobytes()
    m = tsfc.create_sfc_map(width, height)
    assert m.patch_bbox(0, m.size) == jsfc.create_sfc_map(width, height).patch_bbox(0, m.size)


@pytest.mark.parametrize(
    "mb,nb,k_layers",
    [(1, 1, 1), (4, 4, 1), (8, 4, 2), (5, 7, 3), (16, 16, 4), (3, 1, 2), (2, 64, 1), (1, 2374, 1)],
)
def test_gemm_schedule_byte_identical(mb, nb, k_layers):
    _same("gemm_spec", mb, nb, k_layers)


@pytest.mark.parametrize(
    "row_blocks,nb",
    [((2, 3), 4), ((0, 5, 0, 1), 3), ((4,), 1), ((0, 0), 2), ((1, 2, 3, 4, 5), 8)],
)
def test_grouped_schedule_byte_identical(row_blocks, nb):
    _same("grouped_gemm_spec", row_blocks, nb)


@pytest.mark.parametrize(
    "row_blocks,kb,nb",
    [((2, 3), 4, 4), ((1,), 2, 8), ((0, 4, 2), 3, 5), ((5, 5, 5), 1, 1)],
)
def test_grouped_tn_schedule_byte_identical(row_blocks, kb, nb):
    _same("grouped_tn_spec", row_blocks, kb, nb)


@pytest.mark.parametrize(
    "n_major,n_minor,band",
    [(4, 6, None), (1, 1, None), (5, 5, (1, 2, 3, 4, 5)), (4, 8, (0, 3, 0, 8)), (3, 4, (0, 0, 0))],
)
def test_band_schedule_byte_identical(n_major, n_minor, band):
    _same("band_spec", n_major, n_minor, band)


@pytest.mark.parametrize("q_offset", [0, 16, 40])
@pytest.mark.parametrize("causal,transpose", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("nq,nk,qc,kc", [(4, 4, 16, 16), (8, 4, 16, 32), (3, 5, 32, 16)])
def test_attention_schedule_byte_identical(nq, nk, qc, kc, causal, transpose, q_offset):
    _same("attention_spec", nq, nk, causal=causal, q_chunk=qc, k_chunk=kc,
          transpose=transpose, q_offset=q_offset)


def test_spec_validation_matches():
    bad = [
        dict(order="zigzag", major=2, minor=2),
        dict(order="serpentine", major=2, minor=2, layers=2),
        dict(order="grouped", major=2, minor=2),
        dict(order="serpentine", major=3, minor=2, band=(1,)),
        dict(order="gilbert", major=2, minor=2, masked_sentinel=True),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            jsched.ScheduleSpec(**kw)
        with pytest.raises(ValueError):
            tsched.ScheduleSpec(**kw)
    with pytest.raises(ValueError):
        tsched.attention_spec(2, 2, causal=True, q_chunk=8, k_chunk=8, q_offset=-1)


def test_namespaces_match_reference():
    from repro.core import namespaces as jns

    assert tns.ALL_NAMESPACES == jns.ALL_NAMESPACES
    assert tns.schedule_namespace(tns.NS_GEMM, "abc") == jns.schedule_namespace(jns.NS_GEMM, "abc")
    assert tns.base_namespace("glu@123") == "glu"
    assert tns.BACKENDS == ("torch", "sfc_cuda", "replicated", "sfc_reference")
    # one backend for each rung of the JAX package's ladder
    rungs = dict(torch=jns.RUNG_XLA, sfc_cuda=jns.RUNG_SFC_PALLAS, replicated=jns.RUNG_REPLICATED,
                 sfc_reference=jns.RUNG_SFC_REFERENCE)
    assert set(rungs) == set(tns.BACKENDS) and set(rungs.values()) == set(jns.DEFAULT_LADDER)
    assert tns.BACKEND_REPLICATED == jns.RUNG_REPLICATED
