"""Inverse-compositional backend: convergence, skipped levels, and
agreement with the analytic (forward) backend."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from phovo_tpu.models.analytic import align_analytic
from phovo_tpu.models.ic import PhotoconsistencyOdometryIC, align_ic
from phovo_tpu.utils.config import PhovoConfig

CFG = PhovoConfig(
    num_levels=3,
    blur_filter_sizes=(0, 0, 0),
    gradient_scales=(0.03125, 0.03125, 0.03125),  # true Scharr normalization
    max_iterations=(10, 15, 20),
    lambda_steps=(1.0, 1.0, 1.0),
    min_gradient_norms=(1e-10, 1e-10, 1e-10),
    sampling="bilinear",
)


def test_ic_alignment_recovers_pose(intr, small_pair):
    I0, D0, I1, D1, gt = small_pair
    res = align_ic(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6), CFG,
    )
    state = np.asarray(res.state)
    assert np.linalg.norm(state[:3] - gt[:3]) < 2e-3, (state, gt)
    assert np.linalg.norm(state[3:] - gt[3:]) < 2e-3, (state, gt)
    assert int(res.iterations.sum()) > 0


def test_ic_agrees_with_analytic(intr, small_pair):
    """IC and forward GN share the photometric objective; their optima must
    agree to tolerance on a well-conditioned synthetic pair."""
    I0, D0, I1, D1, gt = small_pair
    args = (
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6),
    )
    res_ic = align_ic(*args, CFG)
    cfg_fw = dataclasses.replace(CFG, gradient_scales=(0.0625,) * 3)
    res_fw = align_analytic(*args, cfg_fw)
    np.testing.assert_allclose(
        np.asarray(res_ic.state), np.asarray(res_fw.state), atol=2e-3
    )


def test_ic_skipped_levels_pass_state_through(intr, small_pair):
    I0, D0, I1, D1, gt = small_pair
    cfg = dataclasses.replace(CFG, max_iterations=(0, 0, 0))
    init = jnp.asarray([0.01, -0.02, 0.005, 0.003, -0.001, 0.002], jnp.float32)
    res = align_ic(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, init, cfg,
    )
    np.testing.assert_allclose(np.asarray(res.state), np.asarray(init), atol=1e-5)
    assert int(res.iterations.sum()) == 0


def test_ic_object_api(intr, small_pair):
    I0, D0, I1, D1, gt = small_pair
    vo = PhotoconsistencyOdometryIC(CFG)
    vo.set_intrinsic_matrix(np.asarray(intr.matrix()))
    vo.set_source_frame((I0 * 255).astype(np.uint8), D0)
    vo.set_target_frame((I1 * 255).astype(np.uint8), D1)
    vo.set_initial_state_vector(np.zeros(6))
    res = vo.optimize()
    err = np.abs(np.asarray(res.state) - gt).max()
    assert err < 5e-3, (np.asarray(res.state), gt)


def test_ic_rejects_robust_loss(intr, small_pair):
    """IC's precomputed factorization cannot honor IRLS reweighting; the
    backend must fail loudly rather than silently ignore robust_loss."""
    import pytest as _pytest

    from phovo_tpu.models.ic import align_ic
    from phovo_tpu.utils.config import PhovoConfig

    I0, D0, I1, D1, _ = small_pair
    cfg = PhovoConfig(
        num_levels=1, blur_filter_sizes=(0,), gradient_scales=(0.03125,),
        max_iterations=(3,), lambda_steps=(1.0,), min_gradient_norms=(0.0,),
        robust_loss="huber",
    )
    with _pytest.raises(ValueError, match="robust_loss"):
        align_ic(I0, D0, I1, D1, intr, jnp.zeros(6, jnp.float32), cfg)
