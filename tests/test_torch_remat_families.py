"""Remat against the JAX package for the families beside the decoders, on
the CPU: the encoder-decoder (seamless-m4t-medium: each encoder and each
decoder layer a unit), the hybrid (zamba2-1.2b: each group of Mamba2 layers
with the shared block a unit) and the xLSTM (xlstm-1.3b: each group of
mLSTM blocks and its sLSTM block a unit).  The checks and their tolerances
are tests/test_torch_remat.py's: under "full", "dots" and "dots_no_batch"
the loss and every gradient bitwise the port's "none"'s and within rtol
1e-4 of JAX's ``value_and_grad`` of ``loss(remat=policy)``, per backend
pair; the elements each unit keeps against JAX's per-unit residuals.
Also the SSD's masked decay, whose gradient is finite in the port where
JAX's is NaN.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from test_torch_remat import PAIRS, POLICIES, check_bitwise_none_and_jax, check_saved_elements  # noqa: E402

ARCHS = ("seamless_m4t_medium", "zamba2_1_2b", "xlstm_1_3b")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_grads_are_bitwise_none_and_match_jax(arch, pair, policy):
    check_bitwise_none_and_jax(arch, pair, policy)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("arch", ARCHS)
def test_saved_elements_per_unit_match_jax_residuals(arch, pair, policy):
    check_saved_elements(arch, pair, policy)


def test_ssd_masked_decay_keeps_gradients_finite_where_jax_has_nan():
    """The SSD's intra-chunk weights above the diagonal are exp(-inf) = 0
    in the port, where JAX's ``where(mask, exp(decay), 0)`` takes exp of
    the masked decay first: with a decay that overflows exp there (steep
    log decays over a chunk, as zamba2's 256-step chunks at full width
    reach) the outputs agree, JAX's gradients are NaN and the port's
    finite, and the port's equal JAX's at an input where neither
    overflows."""
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x, bm, cm = (rng.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    for steep, finite_in_jax in ((-30.0, False), (-0.5, True)):
        la = (steep * rng.random((b, s, h))).astype(np.float32)

        def jloss(x_, bm_, cm_, la_):
            return jnp.sum(jssm.ssd_chunked(x_, bm_, cm_, la_, chunk=8) ** 2)

        jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(x, bm, cm, la)
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, bm, cm, la)]
        val = torch.sum(tssm.ssd_chunked(*ts, chunk=8) ** 2)
        val.backward()
        np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-4)
        assert all(bool(torch.isfinite(t.grad).all()) for t in ts)
        assert all(bool(np.isfinite(np.asarray(g)).all()) for g in jgrads) == finite_in_jax
        if finite_in_jax:
            for t, g in zip(ts, jgrads):
                g = np.asarray(g)
                np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-5 * float(np.abs(g).max()))
