"""Autodiff backend: jacfwd (Jet-equivalent) vs production linearizer mode."""

import jax.numpy as jnp
import numpy as np

from phovo_tpu.models.autodiff import align_autodiff
from phovo_tpu.utils.config import PhovoConfig

CFG = PhovoConfig(
    num_levels=2,
    blur_filter_sizes=(0, 0),
    gradient_scales=(0.0625, 0.0625),
    max_iterations=(25, 25),
    function_tolerances=(1e-9, 1e-9),
    gradient_tolerances=(1e-12, 1e-12),
    parameter_tolerances=(1e-10, 1e-10),
    initial_trust_region_radii=(1e4, 1e4),
    max_trust_region_radii=(1e8, 1e8),
    min_trust_region_radii=(1e-32, 1e-32),
    min_relative_decreases=(1e-3, 1e-3),
    sampling="bilinear",
)


def test_jacfwd_and_linearizer_modes_agree(intr, small_pair):
    """Both Jacobian models must recover the same pose (they differ only in
    the gradient model: exact interpolant derivative vs bilinear-sampled
    Scharr gradients — the reference's SampleWithDerivative scheme)."""
    I0, D0, I1, D1, gt = small_pair
    args = (
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6),
    )
    s_lin = align_autodiff(*args, CFG, "linearizer").state
    s_jac = align_autodiff(*args, CFG, "jacfwd").state
    np.testing.assert_allclose(np.asarray(s_lin), gt, atol=5e-3)
    np.testing.assert_allclose(np.asarray(s_jac), gt, atol=5e-3)
    np.testing.assert_allclose(np.asarray(s_lin), np.asarray(s_jac), atol=5e-3)


def test_jacfwd_mode_reports_num_valid(intr, small_pair):
    """jacfwd mode must report real valid-pixel counts (regression: it
    hardcoded 0, which the keyframe overlap gate read as zero overlap and
    promoted a keyframe every frame)."""
    import dataclasses

    import numpy as np

    from phovo_tpu.models.autodiff import align_autodiff
    from phovo_tpu.utils.config import PhovoConfig

    I0, D0, I1, D1, _ = small_pair
    cfg = PhovoConfig(
        num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2,
        max_iterations=(2, 2), lambda_steps=(1.0, 1.0),
        min_gradient_norms=(1e-10,) * 2, sampling="bilinear",
    )
    import jax.numpy as jnp

    res = align_autodiff(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6, jnp.float32), cfg, "jacfwd",
    )
    nv = np.asarray(res.num_valid)
    npix = I0.size
    assert nv[0] > 0.5 * npix  # most of the frame is valid on this pair
    assert nv[1] > 0.5 * npix / 4


def test_levelmajor_handles_esm_config(intr, small_pair):
    """Regression (ADVICE r4): a ceres-backend sequence with
    gradient_at='esm' runs the batched trust-region chain and matches the
    per-pair scan — align_autodiff ignores gradient_at (the reference Ceres
    functor always samples the warped target gradients,
    sample.h:104-123)."""
    import dataclasses

    import jax

    from phovo_tpu.models.analytic import prep_frame_analytic
    from phovo_tpu.models.autodiff import (
        align_prepped_tr,
        align_sequence_autodiff,
    )
    from phovo_tpu.models.base import align_chain

    I0, D0, I1, D1, _ = small_pair
    cfg = dataclasses.replace(CFG, gradient_at="esm", max_iterations=(4, 6))
    Is = jnp.asarray(np.stack([I0, I1, I0, I1]))
    Ds = jnp.asarray(np.stack([D0, D1, D0, D1]))
    lm = jax.block_until_ready(align_sequence_autodiff(Is, Ds, intr, cfg))
    scan = jax.block_until_ready(
        align_chain(
            prep_frame_analytic, align_prepped_tr, Is, Ds, intr, cfg,
            warm_start=False, batched=False,
        )
    )
    np.testing.assert_allclose(
        np.asarray(lm.state), np.asarray(scan.state), atol=3e-3
    )
