"""Per-pixel photometric / geometric residuals and analytic Jacobians.

Reference functionality being re-designed (not translated):
  - analytic kernel: CPhotoconsistencyOdometryAnalytic.h:191-367 (per-pixel
    backproject -> transform -> project -> residual + 2x6 Jacobian from 26
    precomputed trig terms, chained with the target Scharr gradient);
  - bi-objective kernel: CPhotoconsistencyOdometryBiObjective.h:241-452
    (adds a depth residual with gain = mean(I1)/mean(D1) and separated
    3x6 rigid / 2x3 projection Jacobians);
  - Ceres functor: CPhotoconsistencyOdometryCeres.h:123-270 (forward-mode
    autodiff through bilinear sampling) -> here `residual_vector` is a pure
    function differentiated with jax.jacfwd.

Design decisions vs the reference (deliberate, documented divergences):
  1. GATHER formulation: residual i lives at the SOURCE pixel i and compares
     I1 sampled at the warped coordinates against I0(i). The reference
     scatters the residual at the *transformed* integer pixel index
     (…Analytic.h:358) while storing the Jacobian at i (…Analytic.h:351-356),
     so its normal equations pair J_i with r_sigma(i). The gather form is the
     mathematically consistent Gauss-Newton and is scatter-free.
  2. Correct chain rule: the reference Analytic backend's d/dz,yaw,pitch,roll
     terms contain an algebraic slip (temp11 = cos(pitch)*cos(yaw) + x at
     …Analytic.h:253 multiplies px, injecting px*x instead of x). We use the
     exact separated-Jacobian chain (matching the reference BiObjective path
     and the Maxima worksheets), which coincides at state == 0 where every
     reference alignment starts.
  3. The depth residual pairs D1(warped) with the TRANSFORMED source depth
     tz(state) — consistent with the reference's -Rt_z Jacobian term
     (…BiObjective.h:417-418); the reference residual itself uses the raw
     source depth (…BiObjective.h:441-442), which only matches its own
     Jacobian at state == 0.

All functions are vectorized over the whole pixel field: the per-pixel loops
of the reference become fused elementwise work + XLA gathers + one
(N,6)^T (N,6) reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics, backproject
from phovo_tpu.ops.warp import sample_bilinear, sample_nearest, transform_points


class NormalEquations(NamedTuple):
    """Reduced Gauss-Newton quantities for one linearization."""

    JtJ: jax.Array  # (6, 6)
    Jtr: jax.Array  # (6,)
    cost: jax.Array  # scalar: sum of squared residuals
    num_valid: jax.Array  # scalar: number of contributing pixels


def rigid_jacobian(points: jax.Array, state: jax.Array) -> jax.Array:
    """d(R p + t)/d(state): (..., 3) points -> (..., 3, 6).

    Columns 0..2 (translation) are identity; columns 3..5 are
    dR/d(yaw|pitch|roll) @ p. Matches the reference's separated jacobianRt
    (CPhotoconsistencyOdometryBiObjective.h:351-381).
    """
    dR = se3.rotation_jacobian_wrt_euler(state)  # (3[angle], 3, 3)
    rot_cols = jnp.einsum(
        "aij,...j->...ia", dR, points, precision=jax.lax.Precision.HIGHEST
    )  # (..., 3, 3)
    eye = jnp.broadcast_to(
        jnp.eye(3, dtype=points.dtype), points.shape[:-1] + (3, 3)
    )
    return jnp.concatenate([eye, rot_cols], axis=-1)


def projection_jacobian(tp: jax.Array, intr: Intrinsics) -> jax.Array:
    """d(u, v)/d(transformed point): (..., 3) -> (..., 2, 3).

    u = fx tx/tz + cx, v = fy ty/tz + cy
    (reference jacobianProy, CPhotoconsistencyOdometryBiObjective.h:384-396).
    """
    tx, ty, tz = tp[..., 0], tp[..., 1], tp[..., 2]
    inv_z = 1.0 / tz
    zero = jnp.zeros_like(tx)
    row_u = jnp.stack([intr.fx * inv_z, zero, -intr.fx * tx * inv_z * inv_z], -1)
    row_v = jnp.stack([zero, intr.fy * inv_z, -intr.fy * ty * inv_z * inv_z], -1)
    return jnp.stack([row_u, row_v], axis=-2)


def warp_and_jacobian(
    source_depth: jax.Array,
    state: jax.Array,
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
    row_offset=0.0,
    return_rigid: bool = False,
):
    """Shared geometry for all residual kernels.

    Returns (col, row, tp, J_pix, valid_src) where J_pix is the (..., 2, 6)
    Jacobian of the projected pixel coordinates w.r.t. the state.
    row_offset: see ops/camera.py backproject (row-sharded execution).
    return_rigid appends the intermediate (..., 3, 6) rigid-transform
    Jacobian (the bi-objective depth channel needs its z-row — returning it
    avoids re-deriving backproject + rigid_jacobian at the call site).
    """
    T = se3.pose_matrix(state)
    pts = backproject(source_depth, intr, row_offset)
    tp = transform_points(pts, T)
    tz = tp[..., 2]
    safe_z = jnp.where(jnp.abs(tz) > 1e-12, tz, 1e-12)
    tp_safe = tp.at[..., 2].set(safe_z)
    col = tp_safe[..., 0] * intr.fx / safe_z + intr.cx
    row = tp_safe[..., 1] * intr.fy / safe_z + intr.cy
    J_rt = rigid_jacobian(pts, state)  # (..., 3, 6)
    J_proj = projection_jacobian(tp_safe, intr)  # (..., 2, 3)
    J_pix = jnp.einsum(
        "...ik,...kj->...ij", J_proj, J_rt, precision=jax.lax.Precision.HIGHEST
    )  # (..., 2, 6)
    valid_src = (source_depth > min_depth) & (source_depth < max_depth) & (tz > 0)
    if return_rigid:
        return col, row, tp_safe, J_pix, valid_src, J_rt
    return col, row, tp_safe, J_pix, valid_src


def photometric_residual_jacobian(
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_intensity: jax.Array,
    target_grad_x: jax.Array,
    target_grad_y: jax.Array,
    state: jax.Array,
    intr: Intrinsics,
    min_depth: float = 0.3,
    max_depth: float = 5.0,
    sampling: str = "nearest",
    gradient_at: str = "warped",
    row_offset=0.0,
    source_grad_x: jax.Array | None = None,
    source_grad_y: jax.Array | None = None,
):
    """Photometric residual field + analytic Jacobian rows.

    Returns (residual (H,W), J (H,W,6), valid (H,W)).

    sampling: 'nearest' (reference Analytic, …Analytic.h:297-298) or
        'bilinear' (reference Ceres, third_party/sample.h:52-99).
    gradient_at: 'warped' samples the target gradient at the warped
        coordinates (consistent linearization); 'source' reads it at the
        source pixel index like the reference analytic kernel
        (…Analytic.h:346-347); 'esm' averages the warped target gradient
        with the SOURCE gradient at the source pixel (Efficient Second-order
        Minimization, Benhimane & Malis 2004 — second-order convergence from
        first derivatives only; no reference analog). 'esm' requires
        source_grad_x/source_grad_y (Scharr of the source intensity, same
        per-level scaling as the target gradients).
    """
    col, row, _, J_pix, valid_src = warp_and_jacobian(
        source_depth, state, intr, min_depth, max_depth, row_offset
    )
    sample = sample_bilinear if sampling == "bilinear" else sample_nearest
    tgt_val, inb = sample(target_intensity, col, row)
    if gradient_at == "warped":
        gx, _ = sample(target_grad_x, col, row)
        gy, _ = sample(target_grad_y, col, row)
    elif gradient_at == "esm":
        if source_grad_x is None or source_grad_y is None:
            raise ValueError("gradient_at='esm' needs source_grad_x/y")
        gx1, _ = sample(target_grad_x, col, row)
        gy1, _ = sample(target_grad_y, col, row)
        gx = 0.5 * (gx1 + source_grad_x)
        gy = 0.5 * (gy1 + source_grad_y)
    else:
        gx, gy = target_grad_x, target_grad_y
    valid = valid_src & inb
    residual = jnp.where(valid, tgt_val - source_intensity, 0.0)
    grad = jnp.stack([gx, gy], axis=-1)  # (..., 2)
    J = jnp.einsum(
        "...k,...kj->...j", grad, J_pix, precision=jax.lax.Precision.HIGHEST
    )
    J = jnp.where(valid[..., None], J, 0.0)
    return residual, J, valid


def biobjective_residual_jacobian(
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_intensity: jax.Array,
    target_depth: jax.Array,
    target_grad_x: jax.Array,
    target_grad_y: jax.Array,
    target_depth_grad_x: jax.Array,
    target_depth_grad_y: jax.Array,
    state: jax.Array,
    intr: Intrinsics,
    min_depth: float = 0.3,
    max_depth: float = 5.0,
    sampling: str = "nearest",
    gradient_at: str = "warped",
    depth_gain: jax.Array | None = None,
):
    """Joint intensity + depth residuals (reference BiObjective backend).

    Returns (residual (2,H,W), J (2,H,W,6), valid (H,W)). Channel 0 is
    intensity, channel 1 depth. depth_gain defaults to
    mean(target_intensity)/mean(target_depth) (…BiObjective.h:299).
    """
    if depth_gain is None:
        depth_gain = jnp.mean(target_intensity) / jnp.mean(target_depth)
    col, row, tp, J_pix, valid_src, J_rt = warp_and_jacobian(
        source_depth, state, intr, min_depth, max_depth, return_rigid=True
    )
    sample = sample_bilinear if sampling == "bilinear" else sample_nearest
    tgt_i, inb = sample(target_intensity, col, row)
    tgt_d, _ = sample(target_depth, col, row)
    if gradient_at == "warped":
        gx, _ = sample(target_grad_x, col, row)
        gy, _ = sample(target_grad_y, col, row)
        dgx, _ = sample(target_depth_grad_x, col, row)
        dgy, _ = sample(target_depth_grad_y, col, row)
    else:
        gx, gy = target_grad_x, target_grad_y
        dgx, dgy = target_depth_grad_x, target_depth_grad_y
    valid = valid_src & inb

    r_int = jnp.where(valid, tgt_i - source_intensity, 0.0)
    grad_i = jnp.stack([gx, gy], axis=-1)
    J_int = jnp.einsum(
        "...k,...kj->...j", grad_i, J_pix, precision=jax.lax.Precision.HIGHEST
    )

    # Depth channel: residual gain*(D1(warped) - tz), Jacobian
    # gain*(gradD . J_pix - J_rt_z) (…BiObjective.h:407-418; see module
    # docstring note 3 for the residual pairing).
    tz = tp[..., 2]
    r_dep = jnp.where(valid, depth_gain * (tgt_d - tz), 0.0)
    J_rt_z = J_rt[..., 2, :]
    grad_d = jnp.stack([dgx, dgy], axis=-1)
    J_dep = depth_gain * (
        jnp.einsum("...k,...kj->...j", grad_d, J_pix, precision=jax.lax.Precision.HIGHEST)
        - J_rt_z
    )

    vmask = valid[..., None]
    J = jnp.stack([jnp.where(vmask, J_int, 0.0), jnp.where(vmask, J_dep, 0.0)])
    r = jnp.stack([r_int, r_dep])
    return r, J, valid


def normal_equations(
    residual: jax.Array,
    J: jax.Array,
    valid: jax.Array,
    robust_loss: str = "none",
    robust_delta: float = 0.1,
) -> NormalEquations:
    """Reduce a residual field to Gauss-Newton normal equations.

    J: (..., 6), residual/valid broadcastable to J[..., 0]. One matmul:
    JtJ = J^T J over all leading axes (invalid rows already zeroed).

    With a robust loss, every row is scaled by sqrt(w(r)) (ops/robust.py),
    making this one IRLS step; the reported cost is the reweighted
    sum w r^2.
    """
    if robust_loss != "none":
        from phovo_tpu.ops.robust import sqrt_weight

        sw = sqrt_weight(residual, robust_loss, robust_delta)
        residual = residual * sw
        J = J * sw[..., None]
    Jf = J.reshape(-1, 6)
    rf = residual.reshape(-1)
    JtJ = jnp.einsum(
        "ni,nj->ij", Jf, Jf, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    Jtr = jnp.einsum(
        "ni,n->i", Jf, rf, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    cost = jnp.sum(rf * rf)
    num_valid = jnp.sum(valid.astype(jnp.float32))
    return NormalEquations(JtJ, Jtr, cost, num_valid)


def residual_vector(
    state: jax.Array,
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_intensity: jax.Array,
    intr: Intrinsics,
    min_depth: float = 0.3,
    max_depth: float = 5.0,
) -> jax.Array:
    """Pure differentiable residual field for the autodiff ("ceres") backend.

    Bilinear sampling makes this piecewise-differentiable in state; jacfwd of
    this function is the JAX-native equivalent of the reference's
    Jet/SampleWithDerivative machinery (CPhotoconsistencyOdometryCeres.h:
    156-269 + third_party/jet_extras.h:73-110), with no custom chain-rule
    plumbing needed.
    """
    tgt, valid = _warped_target_and_valid(
        state, source_depth, target_intensity, intr, min_depth, max_depth
    )
    r = jnp.where(valid, tgt - source_intensity, 0.0)
    return r.reshape(-1)


def _warped_target_and_valid(
    state, source_depth, target_intensity, intr, min_depth, max_depth
):
    """Shared warp + validity predicate of the autodiff residual path."""
    T = se3.pose_matrix(state)
    pts = backproject(source_depth, intr)
    tp = transform_points(pts, T)
    tz = tp[..., 2]
    safe_z = jnp.where(jnp.abs(tz) > 1e-12, tz, 1e-12)
    col = tp[..., 0] * intr.fx / safe_z + intr.cx
    row = tp[..., 1] * intr.fy / safe_z + intr.cy
    tgt, inb = sample_bilinear(target_intensity, col, row)
    valid = (source_depth > min_depth) & (source_depth < max_depth) & (tz > 0) & inb
    return tgt, valid


def residual_valid_count(
    state, source_depth, target_intensity, intr,
    min_depth: float = 0.3, max_depth: float = 5.0,
) -> jax.Array:
    """Number of pixels contributing to residual_vector at this state (the
    num_valid diagnostic the jacfwd linearizer path reports)."""
    _, valid = _warped_target_and_valid(
        state, source_depth, target_intensity, intr, min_depth, max_depth
    )
    return jnp.sum(valid.astype(jnp.float32))
