"""Inverse-compositional Gauss-Newton backend.

A fourth aligner beyond the reference's three (ops/ic.py for the algorithm):
per pyramid level the Jacobian and its Cholesky factor come from the SOURCE
frame once, so each GN iteration is one single-channel sampling pass, with
matching pose estimates on synthetic ground truth (tests/test_ic.py).

Note the gradient convention: IC chains with the SOURCE image gradient, so
`gradient_scales` should approximate the true derivative (OpenCV Scharr is
unnormalized by 32; scale 0.03125 = 1/32 makes J metric). The reference's
analytic preset value 0.0625 also converges (steps are uniformly halved).
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
from phovo_tpu.ops import ic as ic_ops
from phovo_tpu.ops import pyramid as pyr
from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.utils.config import PhovoConfig


def _check_config(config: PhovoConfig) -> None:
    if config.robust_loss != "none":
        # IC's speed comes from the precomputed source-frame Jacobian and its
        # frozen Cholesky factor; IRLS reweighting changes J^T W J every
        # iteration, which would silently fall back to unweighted steps here.
        # Fail loudly instead (use the analytic/biobjective/ceres backends
        # for robust losses).
        raise ValueError(
            "the IC backend does not support robust_loss="
            f"{config.robust_loss!r} (its factorization is precomputed from "
            "the source frame); use backend 'analytic', 'biobjective' or "
            "'ceres', or set robust_loss: none"
        )


def prep_frame_ic(
    intensity: jax.Array,  # (H, W) float32 0..1
    depth: jax.Array,
    intr: Intrinsics,
    config: PhovoConfig,
) -> dict:
    """Per-frame products for every ACTIVE level: (I, D, J8, chol).

    A frame is a pair's TARGET (needs only its intensity) and the next
    pair's SOURCE (needs the precomputed Jacobian system ic_precompute:
    J8 (8, N) and the Cholesky factor of J0^T J0); a chain computes both
    once per frame."""
    L = config.num_levels
    blur = tuple(config.blur_filter_sizes)
    int_p = pyr.build_pyramid(intensity, L, blur, blur_type=config.blur_type)
    dep_p = pyr.build_pyramid(depth, L, None)
    # SOURCE gradients (the defining difference from the forward backends)
    gx, gy = pyr.build_gradient_pyramid(int_p, tuple(config.gradient_scales))
    out = {}
    for level in range(L):
        if config.max_iterations[level] <= 0:
            continue
        J8, chol = ic_ops.ic_precompute(
            int_p[level], dep_p[level], gx[level], gy[level],
            intr.at_level(level), config.min_depth, config.max_depth,
        )
        out[level] = (int_p[level], dep_p[level], J8, chol)
    return out


def align_prepped_ic(
    src: dict,
    tgt: dict,
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
) -> AlignmentResult:
    """Coarse-to-fine IC Gauss-Newton of one pair from the source's and the
    target's prep_frame_ic products; the pose is carried in matrix form
    across levels and converted to the Euler state once at the end."""
    _check_config(config)
    L = config.num_levels
    T = se3.pose_matrix(jnp.asarray(init_state, jnp.float32))
    diags = [None] * L
    for level in range(L - 1, -1, -1):
        if config.max_iterations[level] <= 0:
            zero = jnp.float32(0.0)
            diags[level] = (None, 0, zero, zero, zero)
            continue
        _, d0, J8, chol = src[level]
        T, its, gnorm, cost, nvalid = ic_ops.ic_gn_level(
            T, d0, J8, chol, tgt[level][0], intr.at_level(level),
            config.max_iterations[level],
            config.min_gradient_norms[level],
            config.lambda_steps[level],
            config.sampling,
        )
        diags[level] = (None, its, gnorm, cost, nvalid)
    state = se3.matrix_to_state(T).astype(jnp.float32)
    diags[0] = (state,) + tuple(diags[0][1:])
    return stack_levels(diags)


@functools.partial(jax.jit, static_argnames=("config",))
def align_ic(
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_intensity: jax.Array,
    target_depth: jax.Array,  # unused (parity with the other backends)
    intr: Intrinsics,
    init_state: jax.Array,
    config: PhovoConfig,
) -> AlignmentResult:
    _check_config(config)
    src = prep_frame_ic(
        device_unit_intensity(source_intensity), source_depth, intr, config
    )
    # the target's depth is never read: its Jacobian products are dead code
    tgt = prep_frame_ic(
        device_unit_intensity(target_intensity), target_depth, intr, config
    )
    return align_prepped_ic(src, tgt, intr, init_state, config)


@functools.partial(jax.jit, static_argnames=("config", "warm_start"))
def align_sequence_ic(
    intensities: jax.Array,
    depths: jax.Array,
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
) -> AlignmentResult:
    """Buffered-segment IC alignment (see models/analytic.py align_sequence
    for the pipeline rationale): zero-init chains solve all pairs as one
    batch."""
    _check_config(config)
    return align_chain(
        prep_frame_ic, align_prepped_ic, intensities, depths, intr, config,
        warm_start, not warm_start,
    )


@functools.partial(
    jax.jit, static_argnames=("config", "warm_start", "depth_scale"),
)
def align_sequence_chunk_ic(
    carry_intensity: jax.Array,
    carry_depth: jax.Array,
    intensities: jax.Array,
    depths: jax.Array,
    intr: Intrinsics,
    config: PhovoConfig,
    warm_start: bool = False,
    depth_scale: float | None = None,
):
    """IC variant of models/analytic.py align_sequence_chunk: device-resident
    carry, storage-dtype transfers, on-device conversion."""
    I, D = chunk_device_prep(
        carry_intensity, carry_depth, intensities, depths, depth_scale
    )
    results = align_sequence_ic(I, D, intr, config, warm_start)
    return results, I[-1], D[-1]


class PhotoconsistencyOdometryIC(PhotoconsistencyOdometryBase):
    """Object API over `align_ic` (no reference counterpart; a fourth
    backend)."""

    def align(self, si, sd, ti, td, intr, init_state) -> AlignmentResult:
        return align_ic(si, sd, ti, td, intr, init_state, self.config)
