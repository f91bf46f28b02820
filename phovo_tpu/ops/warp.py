"""Image warping between RGB-D frames.

Two formulations:
  - `forward_warp`: scatter source intensity to the target frame at the
    projected integer pixel (reference `warpImage`,
    CPhotoconsistencyOdometry.h:73-134; used for visualization/diagnostics).
    Scatter in XLA is a `.at[].set` segment write — fine off the hot path.
  - `gather_warp` / `sample_*`: sample the target image AT the projected
    coordinates of each source pixel. This is the formulation the residual
    kernels use (mathematically consistent with the Jacobians — see
    ops/residuals.py docstring) and is gather-based: no write conflicts,
    unlike a scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics, backproject, project


def transform_points(points: jax.Array, T: jax.Array) -> jax.Array:
    """Apply rigid transform T (4,4) to points (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    rotated = jnp.einsum(
        "...ij,...j->...i", jnp.broadcast_to(R, points.shape[:-1] + (3, 3)), points,
        precision=jax.lax.Precision.HIGHEST,
    )
    return rotated + t


def warp_coordinates(
    depth: jax.Array, state: jax.Array, intr: Intrinsics
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Project every source pixel into the target frame.

    Returns (col, row, transformed_z) arrays of shape (H, W). Invalid depths
    still produce (garbage) coordinates; callers mask with their own validity
    predicate. Division guards against z == 0.
    """
    T = se3.pose_matrix(state)
    pts = backproject(depth, intr)
    tp = transform_points(pts, T)
    z = tp[..., 2]
    safe = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    col, row = project(tp.at[..., 2].set(safe), intr)
    return col, row, z


def sample_nearest(img: jax.Array, col: jax.Array, row: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Nearest-neighbor sample with round() (reference analytic kernel,
    CPhotoconsistencyOdometryAnalytic.h:297-298). Returns (values, in_bounds).
    Out-of-bounds reads are clamped; mask with `in_bounds`."""
    H, W = img.shape[-2:]
    ri = jnp.round(row).astype(jnp.int32)
    ci = jnp.round(col).astype(jnp.int32)
    inb = (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
    ric = jnp.clip(ri, 0, H - 1)
    cic = jnp.clip(ci, 0, W - 1)
    flat = img.reshape(*img.shape[:-2], H * W)
    vals = jnp.take(flat, ric * W + cic, axis=-1)
    return vals, inb


def sample_bilinear(
    img: jax.Array, col: jax.Array, row: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Bilinear sample at (col, row) with edge clamping.

    In-bounds predicate matches the reference Ceres functor's continuous test
    (CPhotoconsistencyOdometryCeres.h:249-250): 0 <= coord < size.
    """
    H, W = img.shape[-2:]
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    r0 = jnp.floor(row)
    c0 = jnp.floor(col)
    wr = row - r0
    wc = col - c0
    r0i = jnp.clip(r0.astype(jnp.int32), 0, H - 1)
    c0i = jnp.clip(c0.astype(jnp.int32), 0, W - 1)
    r1i = jnp.clip(r0i + 1, 0, H - 1)
    c1i = jnp.clip(c0i + 1, 0, W - 1)
    flat = img.reshape(*img.shape[:-2], H * W)

    def g(ri, ci):
        return jnp.take(flat, ri * W + ci, axis=-1)

    v00 = g(r0i, c0i)
    v01 = g(r0i, c1i)
    v10 = g(r1i, c0i)
    v11 = g(r1i, c1i)
    top = v00 * (1 - wc) + v01 * wc
    bot = v10 * (1 - wc) + v11 * wc
    return top * (1 - wr) + bot * wr, inb


def forward_warp(
    intensity: jax.Array,
    depth: jax.Array,
    state: jax.Array,
    intr: Intrinsics,
    level: int = 0,
) -> jax.Array:
    """Reference `warpImage` semantics: scatter source intensity into the
    target frame at the int-truncated projected pixel; zeros elsewhere
    (CPhotoconsistencyOdometry.h:98-133). Later writes win ties, like the
    reference's sequential loop."""
    H, W = intensity.shape[-2:]
    intr_l = intr.at_level(level)
    col, row, z = warp_coordinates(depth, state, intr_l)
    ci = col.astype(jnp.int32)  # static_cast<int> truncation, not round
    ri = row.astype(jnp.int32)
    valid = (depth > 0) & (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
    idx = jnp.where(valid, ri * W + ci, H * W)  # dump invalid in overflow slot
    out = jnp.zeros(H * W + 1, dtype=intensity.dtype)
    out = out.at[idx.reshape(-1)].set(intensity.reshape(-1))
    return out[: H * W].reshape(H, W)


def gather_warp(
    target: jax.Array,
    source_depth: jax.Array,
    state: jax.Array,
    intr: Intrinsics,
    level: int = 0,
    bilinear: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Sample `target` at the projected coordinates of each source pixel.

    Returns (warped_target, valid_mask). valid = source depth > 0, projected
    z > 0 and in-bounds.
    """
    intr_l = intr.at_level(level)
    col, row, z = warp_coordinates(source_depth, state, intr_l)
    sample = sample_bilinear if bilinear else sample_nearest
    vals, inb = sample(target, col, row)
    valid = (source_depth > 0) & (z > 0) & inb
    return jnp.where(valid, vals, 0.0), valid
