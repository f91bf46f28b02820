"""ESM Jacobian mode (gradient_at='esm', Benhimane & Malis 2004).

An extension beyond the reference (which always uses the target
gradient, CPhotoconsistencyOdometryAnalytic.h:346-347): the Jacobian chains
the MEAN of the warped target gradient and the source gradient, giving
second-order convergence from first derivatives only. Photometric backends
only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.ops import pyramid as pyr
from phovo_tpu.ops.residuals import normal_equations, photometric_residual_jacobian
from phovo_tpu.utils.config import PhovoConfig

STATE = jnp.array([0.02, -0.01, 0.015, 0.01, -0.008, 0.012], jnp.float32)


def _esm_case(small_pair, intr, sampling):
    I0, D0, I1, _, _ = small_pair
    I0, D0, I1 = map(jnp.asarray, (I0, D0, I1))
    gx1 = pyr.scharr(I1, "x", 0.0625)
    gy1 = pyr.scharr(I1, "y", 0.0625)
    gx0 = pyr.scharr(I0, "x", 0.0625)
    gy0 = pyr.scharr(I0, "y", 0.0625)
    r, J, v = photometric_residual_jacobian(
        I0, D0, I1, gx1, gy1, STATE, intr,
        min_depth=0.3, max_depth=5.0, sampling=sampling, gradient_at="esm",
        source_grad_x=gx0, source_grad_y=gy0,
    )
    return (I0, D0, I1, gx1, gy1, gx0, gy0), normal_equations(r, J, v)


def test_esm_is_mean_of_warped_and_source_chain(intr, small_pair):
    """The ESM Jacobian equals the mean of the warped-gradient and a
    source-gradient-sampled-at-source chain (residuals identical)."""
    I0, D0, I1, _, _ = small_pair
    I0, D0, I1 = map(jnp.asarray, (I0, D0, I1))
    gx1 = pyr.scharr(I1, "x", 0.0625)
    gy1 = pyr.scharr(I1, "y", 0.0625)
    gx0 = pyr.scharr(I0, "x", 0.0625)
    gy0 = pyr.scharr(I0, "y", 0.0625)
    kw = dict(min_depth=0.3, max_depth=5.0, sampling="bilinear")
    r_e, J_e, v_e = photometric_residual_jacobian(
        I0, D0, I1, gx1, gy1, STATE, intr, gradient_at="esm",
        source_grad_x=gx0, source_grad_y=gy0, **kw,
    )
    r_w, J_w, v_w = photometric_residual_jacobian(
        I0, D0, I1, gx1, gy1, STATE, intr, gradient_at="warped", **kw,
    )
    # 'source' mode reads the provided gradient images at the source pixel
    r_s, J_s, v_s = photometric_residual_jacobian(
        I0, D0, I1, gx0, gy0, STATE, intr, gradient_at="source", **kw,
    )
    np.testing.assert_array_equal(np.asarray(v_e), np.asarray(v_w))
    np.testing.assert_allclose(np.asarray(r_e), np.asarray(r_w), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(J_e), 0.5 * (np.asarray(J_w) + np.asarray(J_s)),
        atol=1e-6,
    )


def _cfg(**kw):
    base = dict(
        num_levels=3, blur_filter_sizes=(0, 0, 0),
        gradient_scales=(0.0625,) * 3, max_iterations=(4, 6, 10),
        lambda_steps=(1.0,) * 3, min_gradient_norms=(1e-10,) * 3,
        sampling="bilinear",
    )
    base.update(kw)
    return PhovoConfig(**base)


def test_esm_alignment_converges(intr, small_pair):
    """End-to-end align_analytic with gradient_at='esm' recovers the pose at
    least as well as the default warped-gradient GN on the same budget."""
    from phovo_tpu.models.analytic import align_analytic

    I0, D0, I1, D1, gt = small_pair
    I0, D0, I1, D1 = map(jnp.asarray, (I0, D0, I1, D1))
    z = jnp.zeros(6, jnp.float32)
    res_esm = align_analytic(I0, D0, I1, D1, intr, z, _cfg(gradient_at="esm"))
    res_gn = align_analytic(I0, D0, I1, D1, intr, z, _cfg())
    err_esm = float(jnp.abs(res_esm.state - gt).max())
    err_gn = float(jnp.abs(res_gn.state - gt).max())
    assert np.isfinite(err_esm)
    # same basin; ESM must not be worse than 1.5x the GN error
    assert err_esm <= max(1.5 * err_gn, 2e-3), (err_esm, err_gn)


def test_esm_validation():
    """Config validation accepts 'esm'; bi-objective rejects it; the XLA
    kernel demands source gradients."""
    _cfg(gradient_at="esm").validate()
    with pytest.raises(ValueError, match="gradient_at"):
        _cfg(gradient_at="mean").validate()

    from phovo_tpu.models.biobjective import align_biobjective

    z = jnp.zeros((8, 8), jnp.float32)
    with pytest.raises(ValueError, match="photometric-only"):
        align_biobjective(
            z, z + 1.0, z, z + 1.0, None, jnp.zeros(6),
            _cfg(gradient_at="esm"),
        )
    with pytest.raises(ValueError, match="esm"):
        photometric_residual_jacobian(
            z, z + 1.0, z, z, z, jnp.zeros(6),
            __import__("phovo_tpu.ops.camera", fromlist=["Intrinsics"])
            .Intrinsics(8.0, 8.0, 3.5, 3.5),
            gradient_at="esm",
        )
