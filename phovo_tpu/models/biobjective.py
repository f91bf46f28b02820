"""Bi-objective (intensity + depth) Gauss-Newton backend.

Re-design of phovo::Analytic::CPhotoconsistencyOdometryBiObjective
(CPhotoconsistencyOdometryBiObjective.h:57-698): joint photometric and depth
residuals with separated rigid/projection Jacobians. The depth channel is
weighted by gain = mean(I1)/mean(D1) (…BiObjective.h:299) recomputed per
level from the (fixed) target pyramids.

Each linearization is the vectorized XLA pipeline of
ops/residuals.py biobjective_residual_jacobian.

Deliberate divergences (see ops/residuals.py module docstring):
  - corrected 2N residual stacking: the reference interleaves intensity rows
    at index i and depth rows at index 2i, overlapping for even i so depth
    rows overwrite half the intensity rows (…BiObjective.h:420-442); here the
    two channels are disjoint;
  - the depth residual pairs D1(warped) with the transformed source depth,
    consistent with its own Jacobian's -Rt_z term.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from phovo_tpu.models.base import (
    AlignmentResult,
    PhotoconsistencyOdometryBase,
    align_chain,
    chunk_device_prep,
    device_unit_intensity,
    stack_levels,
)
from phovo_tpu.ops import pyramid as pyr
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.residuals import biobjective_residual_jacobian, normal_equations
from phovo_tpu.solvers.gauss_newton import gauss_newton_level
from phovo_tpu.utils.config import PhovoConfig


def _check_config(config: PhovoConfig) -> None:
    if config.gradient_at == "esm":
        raise ValueError(
            "gradient_at='esm' is photometric-only; the bi-objective "
            "backend supports 'warped' and 'source'"
        )
    if config.robust_loss == "tdist":
        raise ValueError(
            "robust_loss='tdist' is photometric-only (the intensity and "
            "depth channels would need separate adaptive scales); use "
            "huber/cauchy/tukey for the bi-objective backend"
        )


def prep_frame_biobjective(
    intensity: jax.Array,  # (H, W) float32 0..1
    depth: jax.Array,  # (H, W) float32 meters
    intr: Intrinsics,
    config: PhovoConfig,
) -> dict:
    """Per-frame products for every ACTIVE level: (I, D, gx, gy, dgx, dgy,
    gain) — the intensity and depth pyramids, their Scharr gradients and
    the depth gain mean(I)/mean(D) (…BiObjective.h:299). The gain of a
    pair comes from its TARGET frame. Depth gradients are taken on depth
    normalized by 1/max_depth (…BiObjective.h:227-228)."""
    del intr
    L = config.num_levels
    blur = tuple(config.blur_filter_sizes)
    scales = tuple(config.gradient_scales)
    int_p = pyr.build_pyramid(intensity, L, blur, blur_type=config.blur_type)
    dep_p = pyr.build_pyramid(depth, L, None)
    gx, gy = pyr.build_gradient_pyramid(int_p, scales)
    dgx, dgy = pyr.build_gradient_pyramid(
        [d * (1.0 / config.max_depth) for d in dep_p], scales
    )
    return {
        level: (
            int_p[level], dep_p[level], gx[level], gy[level], dgx[level],
            dgy[level], jnp.mean(int_p[level]) / jnp.mean(dep_p[level]),
        )
        for level in range(L)
        if config.max_iterations[level] > 0
    }


def align_prepped_biobjective(
    src: dict,
    tgt: dict,
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
) -> AlignmentResult:
    """Coarse-to-fine bi-objective Gauss-Newton of one pair from the
    source's and the target's prep_frame_biobjective products."""
    _check_config(config)
    L = config.num_levels
    state = jnp.asarray(init_state, jnp.float32)
    diags = [None] * L
    for level in range(L - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            zero = jnp.float32(0.0)
            diags[level] = (state, 0, zero, zero, zero)
            continue
        i0, d0 = src[level][:2]
        i1, d1, gx1, gy1, dgx1, dgy1, gain = tgt[level]

        def linearize(s, _i0=i0, _d0=d0, _t=(i1, d1, gx1, gy1, dgx1, dgy1),
                      _gain=gain, _intr=intr.at_level(level)):
            r, J, valid = biobjective_residual_jacobian(
                _i0, _d0, *_t, s, _intr,
                min_depth=config.min_depth, max_depth=config.max_depth,
                sampling=config.sampling, gradient_at=config.gradient_at,
                depth_gain=_gain,
            )
            return normal_equations(
                r, J, valid, config.robust_loss, config.robust_delta
            )

        res = gauss_newton_level(
            linearize,
            state,
            max_iterations=config.max_iterations[level],
            min_gradient_norm=config.min_gradient_norms[level],
            lambda_step=config.lambda_steps[level],
        )
        state = res.state
        diags[level] = res
    return stack_levels(diags)


@functools.partial(jax.jit, static_argnames=("config",))
def align_biobjective(
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_intensity: jax.Array,
    target_depth: jax.Array,
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
) -> AlignmentResult:
    _check_config(config)
    # u8 inputs convert on device (reference SetSourceFrame's 1/255):
    # host-side conversion would quadruple the host->device transfer
    src = prep_frame_biobjective(
        device_unit_intensity(source_intensity), source_depth, intr, config
    )
    tgt = prep_frame_biobjective(
        device_unit_intensity(target_intensity), target_depth, intr, config
    )
    return align_prepped_biobjective(src, tgt, intr, init_state, config)


@functools.partial(jax.jit, static_argnames=("config", "warm_start"))
def align_sequence_biobjective(
    intensities: jax.Array,  # (B, H, W) consecutive frames
    depths: jax.Array,
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
) -> AlignmentResult:
    """Buffered-segment bi-objective alignment (the intensity+depth
    backend's analog of analytic.align_sequence). Unlike the photometric
    backends this one consumes the target depth. Zero-init chains solve
    all pairs as one batch."""
    _check_config(config)
    return align_chain(
        prep_frame_biobjective, align_prepped_biobjective, intensities,
        depths, intr, config, warm_start, not warm_start,
    )


@functools.partial(
    jax.jit, static_argnames=("config", "warm_start", "depth_scale"),
)
def align_sequence_chunk_biobjective(
    carry_intensity: jax.Array,
    carry_depth: jax.Array,
    intensities: jax.Array,
    depths: jax.Array,
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
    depth_scale: float | None = None,
) -> tuple[AlignmentResult, jax.Array, jax.Array]:
    """Streaming chunked variant for phovo-vo --chunk --backend biobjective
    (device-resident carry, storage-dtype ingestion; see
    analytic.align_sequence_chunk)."""
    I, D = chunk_device_prep(
        carry_intensity, carry_depth, intensities, depths, depth_scale
    )
    results = align_sequence_biobjective(I, D, intr, config, warm_start)
    return results, I[-1], D[-1]


class PhotoconsistencyOdometryBiObjective(PhotoconsistencyOdometryBase):
    """Object API over `align_biobjective` (reference class:
    CPhotoconsistencyOdometryBiObjective, …BiObjective.h:57)."""

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_biobjective(si, sd, ti, td, intr, init_state, self.config)
