"""Analytic Gauss-Newton backend.

Re-design of phovo::Analytic::CPhotoconsistencyOdometryAnalytic
(CPhotoconsistencyOdometryAnalytic.h:57-608): coarse-to-fine photometric
alignment with closed-form Jacobians and lambda-damped Gauss-Newton.

The entire Optimize() — intensity/depth pyramids, Scharr gradients, every
pyramid level, every GN iteration — compiles to ONE XLA program per
(config, image shape): Python drives the static level loop at trace time,
lax.while_loop drives iterations on-device, and each linearization is the
packed-gather pipeline (ops/fused.py). No host round-trips inside an
alignment.

The work splits in two: `prep_frame_analytic` builds one frame's per-level
products once, and `align_prepped` solves one pair from two frames'
products. A frame chain preps every frame once and solves all its pairs as
one batch (models/base.py align_chain).
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
from phovo_tpu.ops.fused import pack_target, packed_normal_equations
from phovo_tpu.ops.residuals import normal_equations, photometric_residual_jacobian
from phovo_tpu.solvers.gauss_newton import gauss_newton_level
from phovo_tpu.utils.config import PhovoConfig


def prep_frame_analytic(
    intensity: jax.Array,  # (H, W) float32 0..1
    depth: jax.Array | None,  # (H, W) float32 meters; None for targets only
    intr: Intrinsics,
    config: PhovoConfig,
) -> dict:
    """Per-frame products for every ACTIVE pyramid level:
    level -> (intensity (h, w), depth (h, w) or None, packed (h, w, 4)),
    where packed = [I, gx, gy, 0] is the frame's Scharr-gradient stack for
    the single packed gather (ops/fused.py pack_target).

    A frame serves as a pair's source (intensity, depth and, for
    gradient_at='esm', its own gradients) and as a pair's target (packed);
    a frame chain preps each frame once. Frames that are only ever
    targets (keyframe tracking, SetTargetFrame ignores depth —
    …Analytic.h:480-491) pass depth=None."""
    del intr
    L = config.num_levels
    blur = tuple(config.blur_filter_sizes)
    int_p = pyr.build_pyramid(intensity, L, blur, blur_type=config.blur_type)
    dep_p = (
        pyr.build_pyramid(depth, L, None) if depth is not None else [None] * L
    )
    gx, gy = pyr.build_gradient_pyramid(int_p, tuple(config.gradient_scales))
    return {
        level: (int_p[level], dep_p[level], pack_target(int_p[level], gx[level], gy[level]))
        for level in range(L)
        if config.max_iterations[level] > 0
    }


def _level_linearizer(src, tgt, intr_l: Intrinsics, config: PhovoConfig):
    """linearize(state[, sigma]) -> NormalEquations for one level, from the
    source's and the target's prep_frame_analytic products at that level.
    sigma (robust_loss='tdist') replaces robust_delta as the traced scale."""
    i0, d0, p0 = src
    p1 = tgt[2]
    if config.gradient_at == "warped":

        def linearize(s, *sigma):
            return packed_normal_equations(
                i0, d0, p1, s, intr_l,
                config.min_depth, config.max_depth, config.sampling,
                config.robust_loss,
                sigma[0] if sigma else config.robust_delta,
            )

        return linearize
    esm = config.gradient_at == "esm"

    def linearize(s, *sigma):
        r, J, valid = photometric_residual_jacobian(
            i0, d0, p1[..., 0], p1[..., 1], p1[..., 2], s, intr_l,
            min_depth=config.min_depth, max_depth=config.max_depth,
            sampling=config.sampling, gradient_at=config.gradient_at,
            source_grad_x=p0[..., 1] if esm else None,
            source_grad_y=p0[..., 2] if esm else None,
        )
        return normal_equations(
            r, J, valid, config.robust_loss,
            sigma[0] if sigma else config.robust_delta,
        )

    return linearize


def align_prepped(
    src: dict,
    tgt: dict,
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
) -> AlignmentResult:
    """Coarse-to-fine Gauss-Newton of one pair from the source's and the
    target's prep_frame_analytic products."""
    L = config.num_levels
    state = jnp.asarray(init_state, jnp.float32)
    # robust_loss='tdist': the solver carries the adaptive residual scale and
    # passes it as the (traced) robust_delta of each linearization; the scale
    # flows coarse -> fine across levels (residuals are intensity
    # differences at every level, so the estimate transfers), with
    # scale-only burn-in passes at the first active level where only the
    # config seed is available (ops/robust.py TDIST_BURNIN).
    tdist = config.robust_loss == "tdist"
    if tdist:
        from phovo_tpu.ops.robust import TDIST_BURNIN, tdist_scale_update

        sigma = jnp.float32(config.robust_delta)
        first_active = True
    diags = [None] * L
    for level in range(L - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            zero = jnp.float32(0.0)
            diags[level] = (state, 0, zero, zero, zero)
            continue
        res = gauss_newton_level(
            _level_linearizer(src[level], tgt[level], intr.at_level(level), config),
            state,
            max_iterations=config.max_iterations[level],
            min_gradient_norm=config.min_gradient_norms[level],
            lambda_step=config.lambda_steps[level],
            adaptive_scale=sigma if tdist else None,
            adaptive_burnin=TDIST_BURNIN if (tdist and first_active) else 0,
        )
        state = res.state
        diags[level] = res
        if tdist:
            sigma = tdist_scale_update(res.cost, res.num_valid)
            first_active = False
    return stack_levels(diags)


@functools.partial(jax.jit, static_argnames=("config",))
def align_analytic(
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_intensity: jax.Array,
    target_depth: jax.Array,  # unused (reference SetTargetFrame ignores depth)
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
) -> AlignmentResult:
    del target_depth
    # u8 inputs are converted on device (reference SetSourceFrame's 1/255,
    # …Analytic.h:470-471) — host-side conversion is slow and quadruples the
    # host->device transfer.
    src = prep_frame_analytic(
        device_unit_intensity(source_intensity), source_depth, intr, config
    )
    tgt = prep_frame_analytic(
        device_unit_intensity(target_intensity), None, intr, config
    )
    return align_prepped(src, tgt, intr, init_state, config)


@functools.partial(jax.jit, static_argnames=("config", "warm_start"))
def align_sequence(
    intensities: jax.Array,  # (B, H, W) consecutive frames
    depths: jax.Array,  # (B, H, W)
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
) -> AlignmentResult:
    """Align all consecutive pairs of a buffered frame sequence in ONE device
    program — the shape of the reference VO app's frame loop
    (PhotoconsistencyVisualOdometry.cpp:212-259) with one dispatch per
    segment instead of one per pair. Returns batched AlignmentResult with
    leading dim B-1 (pair k aligns frame k -> k+1).

    Zero-init chains solve all pairs as one batch; warm_start (each pair
    initialized from the previous relative state) scans the pairs in order
    (models/base.py align_chain)."""
    return align_chain(
        prep_frame_analytic, align_prepped, intensities, depths, intr,
        config, warm_start, not warm_start,
    )


@functools.partial(
    jax.jit, static_argnames=("config", "warm_start", "depth_scale"),
)
def align_sequence_chunk(
    carry_intensity: jax.Array,  # (H, W) last frame of the previous chunk
    carry_depth: jax.Array,  # (H, W)
    intensities: jax.Array,  # (B, H, W) new frames (uint8 or float32)
    depths: jax.Array,  # (B, H, W) metric float32 or raw uint16 counts
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
    depth_scale: float | None = None,
) -> tuple[AlignmentResult, jax.Array, jax.Array]:
    """Streaming variant of align_sequence for the chunked VO pipeline.

    The carry frame (last frame of the previous chunk) stays device-resident
    between calls and the chunk is prepended on DEVICE, so per chunk the host
    transfers only the new frames — in their storage dtype: uint8 intensity
    and (with depth_scale) uint16 depth counts, converted on device. Returns
    (results over B pairs, new carry intensity, new carry depth) — the carry
    outputs are already in converted float form.
    """
    I, D = chunk_device_prep(
        carry_intensity, carry_depth, intensities, depths, depth_scale
    )
    results = align_sequence(I, D, intr, config, warm_start)
    return results, I[-1], D[-1]


class PhotoconsistencyOdometryAnalytic(PhotoconsistencyOdometryBase):
    """Object API over `align_analytic` (reference class:
    CPhotoconsistencyOdometryAnalytic, …Analytic.h:57)."""

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_analytic(si, sd, ti, td, intr, init_state, self.config)
