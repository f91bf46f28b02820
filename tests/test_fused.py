"""Packed-gather linearization vs the reference-shaped XLA pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.ops import fused as F
from phovo_tpu.ops.residuals import normal_equations, photometric_residual_jacobian

STATE = jnp.array([0.02, -0.01, 0.015, 0.01, -0.008, 0.012], jnp.float32)


def _case(small_pair, intr, sampling):
    I0, D0, I1, _, _ = small_pair
    I0, D0, I1 = map(jnp.asarray, (I0, D0, I1))
    gx = I1 * 0.3 + 0.05
    gy = I1 * -0.2 + 0.02
    r, J, v = photometric_residual_jacobian(
        I0, D0, I1, gx, gy, STATE, intr,
        min_depth=0.3, max_depth=5.0, sampling=sampling, gradient_at="warped",
    )
    return (I0, D0, I1, gx, gy), normal_equations(r, J, v)


def _assert_close(ne_test, ne_ref):
    scale = float(jnp.abs(ne_ref.JtJ).max())
    np.testing.assert_allclose(
        np.asarray(ne_test.JtJ), np.asarray(ne_ref.JtJ), atol=2e-5 * scale
    )
    gscale = max(1.0, float(jnp.abs(ne_ref.Jtr).max()))
    np.testing.assert_allclose(
        np.asarray(ne_test.Jtr), np.asarray(ne_ref.Jtr), atol=2e-5 * gscale
    )
    np.testing.assert_allclose(
        float(ne_test.cost), float(ne_ref.cost), rtol=1e-4, atol=1e-6
    )
    assert abs(float(ne_test.num_valid) - float(ne_ref.num_valid)) < 0.5


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_packed_gather_matches_reference_path(intr, small_pair, sampling):
    (I0, D0, I1, gx, gy), ne_ref = _case(small_pair, intr, sampling)
    packed = F.pack_target(I1, gx, gy)
    ne = F.packed_normal_equations(I0, D0, packed, STATE, intr, 0.3, 5.0, sampling)
    _assert_close(ne, ne_ref)



def test_align_with_fused_matches_unfused(intr, small_pair):
    """A whole alignment through the packed gather (gradient_at='warped')
    matches the same schedule driven by the reference residual path
    (separate gathers, ops/residuals.py) level by level."""
    from phovo_tpu.models.analytic import align_analytic
    from phovo_tpu.ops import pyramid as pyr
    from phovo_tpu.solvers.gauss_newton import gauss_newton_level
    from phovo_tpu.utils.config import PhovoConfig

    cfg = PhovoConfig(
        num_levels=2,
        blur_filter_sizes=(0, 0),
        gradient_scales=(0.0625, 0.0625),
        max_iterations=(8, 10),
        lambda_steps=(1.0, 1.0),
        min_gradient_norms=(1e-10, 1e-10),
        sampling="bilinear",
    )
    I0, D0, I1, D1, gt = small_pair
    I0, D0, I1 = map(jnp.asarray, (I0, D0, I1))
    s_packed = align_analytic(
        I0, D0, I1, jnp.asarray(D1), intr, jnp.zeros(6), cfg
    ).state
    int0 = pyr.build_pyramid(I0, 2, (0, 0))
    dep0 = pyr.build_pyramid(D0, 2, None)
    int1 = pyr.build_pyramid(I1, 2, (0, 0))
    gx1, gy1 = pyr.build_gradient_pyramid(int1, (0.0625, 0.0625))
    state = jnp.zeros(6)
    for lv in (1, 0):
        def linearize(s, lv=lv):
            r, J, v = photometric_residual_jacobian(
                int0[lv], dep0[lv], int1[lv], gx1[lv], gy1[lv], s,
                intr.at_level(lv), sampling="bilinear",
            )
            return normal_equations(r, J, v)

        state = gauss_newton_level(
            linearize, state, cfg.max_iterations[lv], 1e-10, 1.0
        ).state
    np.testing.assert_allclose(np.asarray(s_packed), np.asarray(state), atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_packed), gt, atol=5e-3)

def test_solve6_matches_linalg():
    import jax

    from phovo_tpu.solvers.gauss_newton import solve6

    rng = np.random.default_rng(0)
    for _ in range(5):
        M = rng.standard_normal((6, 6))
        A = jnp.asarray((M @ M.T + 6 * np.eye(6)).astype(np.float32))
        b = jnp.asarray(rng.standard_normal(6).astype(np.float32))
        x = solve6(A, b)
        np.testing.assert_allclose(
            np.asarray(A @ x), np.asarray(b), rtol=2e-3, atol=2e-3
        )

