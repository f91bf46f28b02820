"""Autodiff / trust-region backend (the reference's "Ceres" path, JAX-native).

Re-design of phovo::Ceres::CPhotoconsistencyOdometryCeres
(CPhotoconsistencyOdometryCeres.h:60-577). The reference's Jacobian is
forward-mode autodiff through `SampleWithDerivative`, which bilinear-samples
the precomputed Scharr gradient images at the warped coordinates and chains
them (third_party/sample.h:104-123, third_party/jet_extras.h:73-110). That
is EXACTLY the analytic linearization with bilinear sampling and
gradient_at='warped' — so in production this backend drives the same
packed-gather linearizer as the analytic backend (ops/fused.py), under our
Ceres-schema trust-region LM (solvers/trust_region.py). No Jet plumbing,
no N x 6 Jacobian, compile time measured in seconds instead of minutes.

A pure jax.jacfwd path (`jacobian_mode='jacfwd'`: exact derivative of the
bilinear interpolant itself) is kept for validation — the JAX-native
equivalent of pushing Jets through the sampler — and cross-checked against
the linearizer path in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from phovo_tpu.models.analytic import prep_frame_analytic
from phovo_tpu.models.base import (
    AlignmentResult,
    PhotoconsistencyOdometryBase,
    align_chain,
    chunk_device_prep,
    device_unit_intensity,
    stack_levels,
)
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.fused import packed_normal_equations
from phovo_tpu.ops.residuals import residual_valid_count, residual_vector
from phovo_tpu.solvers.trust_region import (
    residual_to_linearizer,
    trust_region_level,
)
from phovo_tpu.utils.config import PhovoConfig


def _check_config(config: PhovoConfig) -> None:
    if config.robust_loss == "tdist":
        raise ValueError(
            "robust_loss='tdist' needs the Gauss-Newton solver (its "
            "adaptive scale changes the cost between trust-region "
            "iterations, breaking the accept/reject comparison); use the "
            "'analytic' backend, or huber/cauchy/tukey here"
        )


def align_prepped_tr(
    src: dict,
    tgt: dict,
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
    jacobian_mode: str = "linearizer",
) -> AlignmentResult:
    """Coarse-to-fine trust-region LM of one pair from the source's and the
    target's prep_frame_analytic products (the backend always samples
    bilinearly and reads the target gradients at the warped position —
    the Ceres functor's convention — whatever config.sampling and
    config.gradient_at say)."""
    _check_config(config)
    L = config.num_levels
    state = jnp.asarray(init_state, jnp.float32)
    diags = [None] * L
    for level in range(L - 1, -1, -1):
        intr_l = intr.at_level(level)
        if config.max_iterations[level] <= 0:
            zero = jnp.float32(0.0)
            diags[level] = (state, 0, zero, zero, zero)
            continue
        i0, d0, _ = src[level]
        p1 = tgt[level][2]
        if jacobian_mode == "jacfwd":

            def r_fn(s, _i0=i0, _d0=d0, _p1=p1, _intr=intr_l):
                return residual_vector(
                    s, _i0, _d0, _p1[..., 0], _intr,
                    min_depth=config.min_depth, max_depth=config.max_depth,
                )

            def nv_fn(s, _d0=d0, _p1=p1, _intr=intr_l):
                return residual_valid_count(
                    s, _d0, _p1[..., 0], _intr,
                    min_depth=config.min_depth, max_depth=config.max_depth,
                )

            linearize = residual_to_linearizer(
                lambda s, _fn=r_fn: (_fn(s), jax.jacfwd(_fn)(s)),
                robust_loss=config.robust_loss,
                robust_delta=config.robust_delta,
                num_valid_fn=nv_fn,
            )
        else:

            def linearize(s, _i0=i0, _d0=d0, _p1=p1, _intr=intr_l):
                return packed_normal_equations(
                    _i0, _d0, _p1, s, _intr,
                    config.min_depth, config.max_depth, sampling="bilinear",
                    robust_loss=config.robust_loss,
                    robust_delta=config.robust_delta,
                )

        res = trust_region_level(
            linearize, state, config.trust_region_options(level)
        )
        state = res.state
        diags[level] = (
            res.state, res.iterations, res.gradient_norm, res.cost,
            res.num_valid,
        )
    return stack_levels(diags)


@functools.partial(jax.jit, static_argnames=("config", "jacobian_mode"))
def align_autodiff(
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_intensity: jax.Array,
    target_depth: jax.Array,  # unused, like the reference Ceres backend
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
    jacobian_mode: str = "linearizer",
) -> AlignmentResult:
    del target_depth
    _check_config(config)
    # u8 inputs convert on device (reference SetSourceFrame's 1/255):
    # host-side conversion would quadruple the host->device transfer
    src = prep_frame_analytic(
        device_unit_intensity(source_intensity), source_depth, intr, config
    )
    tgt = prep_frame_analytic(
        device_unit_intensity(target_intensity), None, intr, config
    )
    return align_prepped_tr(src, tgt, intr, init_state, config, jacobian_mode)


def _align_prepped_jacfwd(src, tgt, intr, init_state, config):
    return align_prepped_tr(src, tgt, intr, init_state, config, "jacfwd")


@functools.partial(
    jax.jit, static_argnames=("config", "jacobian_mode", "warm_start")
)
def align_sequence_autodiff(
    intensities: jax.Array,  # (B, H, W) consecutive frames
    depths: jax.Array,
    intr: Intrinsics,
    config: PhovoConfig,
    jacobian_mode: str = "linearizer",
    warm_start: bool = False,
) -> AlignmentResult:
    """Buffered-segment trust-region alignment (the 'ceres' backend's analog
    of analytic.align_sequence): zero-init chains solve all pairs as one
    batch, each pair with its own radius and termination flag."""
    _check_config(config)
    align_fn = (
        _align_prepped_jacfwd if jacobian_mode == "jacfwd" else align_prepped_tr
    )
    return align_chain(
        prep_frame_analytic, align_fn, intensities, depths, intr, config,
        warm_start, not warm_start,
    )


@functools.partial(
    jax.jit,
    static_argnames=("config", "jacobian_mode", "warm_start", "depth_scale"),
)
def align_sequence_chunk_autodiff(
    carry_intensity: jax.Array,
    carry_depth: jax.Array,
    intensities: jax.Array,
    depths: jax.Array,
    intr: Intrinsics,
    config: PhovoConfig,
    jacobian_mode: str = "linearizer",
    warm_start: bool = False,
    depth_scale: float | None = None,
) -> tuple[AlignmentResult, jax.Array, jax.Array]:
    """Streaming chunked variant for phovo-vo --chunk --backend ceres
    (device-resident carry, storage-dtype ingestion; see
    analytic.align_sequence_chunk)."""
    I, D = chunk_device_prep(
        carry_intensity, carry_depth, intensities, depths, depth_scale
    )
    results = align_sequence_autodiff(
        I, D, intr, config, jacobian_mode, warm_start
    )
    return results, I[-1], D[-1]


class PhotoconsistencyOdometryAutodiff(PhotoconsistencyOdometryBase):
    """Object API over `align_autodiff` (reference class:
    CPhotoconsistencyOdometryCeres, …Ceres.h:60)."""

    COST_IS_HALF_SUM_SQ = True  # TRLevelResult cost = 0.5 * sum r^2 (Ceres)

    def __init__(self, config: PhovoConfig | None = None, jacobian_mode: str = "linearizer"):
        super().__init__(config)
        self.jacobian_mode = jacobian_mode

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_autodiff(
            si, sd, ti, td, intr, init_state, self.config, self.jacobian_mode
        )
