"""Robust loss functions (ops/robust.py) and their IRLS wiring through the
aligners and bundle-adjustment back-ends.

The reference cost is purely quadratic (no weighting anywhere in
ComputeResidualsAndJacobians); the oracle here is behavioral: with a
corrupted (occluded) image patch, the robust aligner must recover the
ground-truth pose much better than the quadratic one, and with clean data
robust and quadratic must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.models.analytic import PhotoconsistencyOdometryAnalytic
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.robust import LOSSES, robust_weight, sqrt_weight
from phovo_tpu.parallel.bundle_adjustment import make_synthetic_ba, optimize_bundle
from phovo_tpu.ops.camera import TUM_DEFAULT
from phovo_tpu.utils.config import PhovoConfig, config_from_dict
from phovo_tpu.utils.synthetic import make_pair

INTR = Intrinsics(
    np.float32(128.0), np.float32(128.0), np.float32(63.5), np.float32(47.5)
)
SHAPE = (96, 128)


def _cfg(robust_loss="none", robust_delta=0.1):
    return PhovoConfig(
        num_levels=2,
        blur_filter_sizes=(0, 0),
        gradient_scales=(0.0625, 0.0625),
        max_iterations=(10, 15),
        lambda_steps=(1.0, 1.0),
        min_gradient_norms=(1e-10, 1e-10),
        sampling="bilinear",
        robust_loss=robust_loss,
        robust_delta=robust_delta,
    )


# -- weight functions ---------------------------------------------------------


def test_weight_formulas():
    r = jnp.asarray([-0.5, -0.05, 0.0, 0.05, 0.5])
    d = 0.1
    np.testing.assert_allclose(
        np.asarray(robust_weight(r, "huber", d)),
        [0.2, 1.0, 1.0, 1.0, 0.2],
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(robust_weight(r, "cauchy", d)),
        1.0 / (1.0 + (np.asarray(r) / d) ** 2),
        rtol=1e-6,
    )
    tw = np.asarray(robust_weight(r, "tukey", d))
    assert tw[0] == 0.0 and tw[-1] == 0.0  # beyond delta: cut off
    assert tw[2] == 1.0
    np.testing.assert_allclose(
        np.asarray(robust_weight(r, "none", d)), np.ones(5)
    )
    with pytest.raises(ValueError):
        robust_weight(r, "l1", d)
    np.testing.assert_allclose(
        np.asarray(sqrt_weight(r, "huber", d)) ** 2,
        np.asarray(robust_weight(r, "huber", d)),
        rtol=1e-6,
    )


def test_config_validates_loss_name():
    with pytest.raises(ValueError):
        _cfg(robust_loss="nonsense").validate()
    cfg = config_from_dict(
        {"num_levels": 1, "max_iterations": [5], "robust_loss": "huber",
         "robust_delta": "1e-1"}
    )
    assert cfg.robust_loss == "huber" and cfg.robust_delta == 0.1


# -- aligner behavior ---------------------------------------------------------


def _corrupted_pair(occ_frac=0.22, seed=0):
    """Ground-truth pair with a bright synthetic occluder pasted into the
    target (violates photoconsistency exactly like a moving object)."""
    I0, D0, I1, D1, gt = make_pair(INTR, shape=SHAPE)
    H, W = SHAPE
    hh, ww = int(H * occ_frac), int(W * occ_frac * 2)
    I1 = I1.copy()
    # smooth bright patch (a real occluder has boundary gradients, not
    # per-pixel noise gradients that would dominate the Jacobian everywhere)
    I1[10 : 10 + hh, 20 : 20 + ww] = 0.95
    return I0, D0, I1, D1, gt


def _align(I0, D0, I1, D1, cfg):
    vo = PhotoconsistencyOdometryAnalytic(cfg)
    vo.set_intrinsic_matrix(np.asarray(INTR.matrix()))
    vo.set_source_frame((I0 * 255).astype(np.uint8), D0)
    vo.set_target_frame((I1 * 255).astype(np.uint8), D1)
    vo.set_initial_state_vector(np.zeros(6))
    return np.asarray(vo.optimize().state)


# Expected suppression follows robust-estimation theory: Huber's linear
# tail only CAPS outlier influence (a 10% gross occluder still biases the
# fit), while the redescending kernels (cauchy, tukey) drive its weight
# toward zero and nearly reject it; the residual bias comes from the
# occluder's boundary ring (inlier-sized residuals, corrupted gradients).
@pytest.mark.parametrize(
    "loss,delta,bound", [("huber", 0.02, 0.4), ("cauchy", 0.02, 0.06),
                         ("tukey", 0.1, 0.06)]
)
def test_robust_aligner_resists_occlusion(loss, delta, bound):
    I0, D0, I1, D1, gt = _corrupted_pair()
    err_plain = np.abs(_align(I0, D0, I1, D1, _cfg()) - gt).max()
    assert err_plain > 0.2  # the quadratic cost diverges on this pair
    err_robust = np.abs(
        _align(I0, D0, I1, D1, _cfg(loss, delta)) - gt
    ).max()
    assert err_robust < err_plain / 3, (loss, err_plain, err_robust)
    assert err_robust < bound, (loss, err_robust)


def test_robust_matches_plain_on_clean_data():
    """With no outliers and small residuals at convergence, Huber (delta
    well above the inlier noise) must land on the same pose."""
    I0, D0, I1, D1, gt = make_pair(INTR, shape=SHAPE)
    s_plain = _align(I0, D0, I1, D1, _cfg())
    s_rob = _align(I0, D0, I1, D1, _cfg("huber", 0.3))
    np.testing.assert_allclose(s_rob, s_plain, atol=2e-4)


# -- bundle adjustment --------------------------------------------------------


def test_robust_ba_resists_outlier_observations():
    problem, gt_states, _ = make_synthetic_ba(
        n_poses=5, n_points=40, state_noise=0.02, point_noise=0.03, seed=8
    )
    # corrupt 8% of observations with gross pixel errors (bad associations)
    rng = np.random.default_rng(1)
    K = problem.obs_uv.shape[0]
    bad = rng.choice(K, K // 12, replace=False)
    uv = np.array(problem.obs_uv)
    uv[bad] += rng.uniform(30.0, 80.0, (len(bad), 2))
    corrupted = problem._replace(obs_uv=jnp.asarray(uv))

    s_plain, _, _ = optimize_bundle(corrupted, TUM_DEFAULT, iterations=10)
    s_rob, _, _ = optimize_bundle(
        corrupted, TUM_DEFAULT, iterations=10, robust_delta=3.0
    )
    err_plain = np.abs(np.asarray(s_plain) - np.asarray(gt_states)).max()
    err_rob = np.abs(np.asarray(s_rob) - np.asarray(gt_states)).max()
    assert err_rob < err_plain / 3, (err_plain, err_rob)
    assert err_rob < 5e-3, err_rob


# -- t-distribution (DVO) adaptive scale --------------------------------------


def test_tdist_weight_formula_and_scale_update():
    from phovo_tpu.ops.robust import (
        TDIST_DOF, TDIST_MIN_SCALE, tdist_scale_update,
    )

    r = jnp.asarray([-0.5, -0.05, 0.0, 0.05, 0.5])
    sigma = 0.1
    np.testing.assert_allclose(
        np.asarray(robust_weight(r, "tdist", sigma)),
        (TDIST_DOF + 1.0) / (TDIST_DOF + (np.asarray(r) / sigma) ** 2),
        rtol=1e-6,
    )
    # fixed point: sigma^2 <- weighted cost / n, floored at TDIST_MIN_SCALE
    assert float(
        tdist_scale_update(jnp.float32(4.0), jnp.float32(100.0))
    ) == pytest.approx(0.2)
    assert float(
        tdist_scale_update(jnp.float32(0.0), jnp.float32(100.0))
    ) == pytest.approx(TDIST_MIN_SCALE)


def test_tdist_aligner_resists_occlusion():
    """The adaptive Student-t weighting must reject the occluder without any
    hand-tuned delta: the scale estimate shrinks to the inlier noise level
    as the alignment converges, redescending the occluder's weight.

    Bounds: at a moderate occluder tdist matches the tuned kernels; at the
    gross 22% occluder the nu=5 tail is inherently softer than a
    sharp-tuned cauchy (delta hand-picked at 0.02), so the bound is looser
    — the converged-fixed-point DVO estimator itself lands at ~0.10 there
    (one-step carried scale plus first-level burn-in reproduces it)."""
    I0, D0, I1, D1, gt = _corrupted_pair(occ_frac=0.12)
    err_t = np.abs(_align(I0, D0, I1, D1, _cfg("tdist", 0.1)) - gt).max()
    assert err_t < 0.06, err_t

    I0, D0, I1, D1, gt = _corrupted_pair()  # 22% gross occluder
    err_plain = np.abs(_align(I0, D0, I1, D1, _cfg()) - gt).max()
    assert err_plain > 0.2
    err_t = np.abs(_align(I0, D0, I1, D1, _cfg("tdist", 0.1)) - gt).max()
    assert err_t < err_plain / 4, (err_plain, err_t)
    assert err_t < 0.15, err_t


def test_tdist_matches_plain_on_clean_data():
    I0, D0, I1, D1, gt = make_pair(INTR, shape=SHAPE)
    s_plain = _align(I0, D0, I1, D1, _cfg())
    s_t = _align(I0, D0, I1, D1, _cfg("tdist", 0.1))
    np.testing.assert_allclose(s_t, s_plain, atol=5e-4)


def test_tdist_rejected_by_nonphotometric_backends():
    from phovo_tpu.models.autodiff import PhotoconsistencyOdometryAutodiff
    from phovo_tpu.models.biobjective import PhotoconsistencyOdometryBiObjective

    I0, D0, I1, D1, _ = make_pair(INTR, shape=SHAPE)
    for cls in (PhotoconsistencyOdometryAutodiff, PhotoconsistencyOdometryBiObjective):
        vo = cls(_cfg("tdist", 0.1))
        vo.set_intrinsic_matrix(np.asarray(INTR.matrix()))
        vo.set_source_frame((I0 * 255).astype(np.uint8), D0)
        vo.set_target_frame((I1 * 255).astype(np.uint8), D1)
        vo.set_initial_state_vector(np.zeros(6))
        with pytest.raises(ValueError, match="tdist"):
            vo.optimize()
