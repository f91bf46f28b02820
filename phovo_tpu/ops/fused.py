"""Packed-gather normal-equation linearization.

This module owns the hot loop of the whole framework — the per-iteration
linearization the reference spends >90% of its time in
(ComputeResidualsAndJacobians, CPhotoconsistencyOdometryAnalytic.h:191-367).

The forward backends sample three target channels (intensity and the two
Scharr gradients) at the warped coordinates of every source pixel. Stacking
them into one (H, W, 4) array (`pack_target`) turns three scalar gathers
into ONE 4-wide gather per sample point, so the per-index cost of the
gather is paid once. XLA fuses that gather with the elementwise warp /
Jacobian math and the JtJ reduction.

`packed_normal_equations` produces the same NormalEquations as the
reference residual path in ops/residuals.py (tests/test_fused.py checks the
agreement for both sampling modes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.residuals import (
    NormalEquations,
    normal_equations,
    warp_and_jacobian,
)


def pack_target(target_intensity, target_grad_x, target_grad_y):
    """(H, W, 4) channel-packed target for single-gather sampling."""
    z = jnp.zeros_like(target_intensity)
    return jnp.stack([target_intensity, target_grad_x, target_grad_y, z], axis=-1)


def _sample_packed(packed, col, row, sampling):
    """Sample (H, W, 4) packed image at float (col, row). Returns
    ((..., 4) values, in_bounds)."""
    H, W = packed.shape[:2]
    flat = packed.reshape(H * W, 4)
    if sampling == "nearest":
        ri = jnp.round(row).astype(jnp.int32)
        ci = jnp.round(col).astype(jnp.int32)
        inb = (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
        idx = jnp.clip(ri, 0, H - 1) * W + jnp.clip(ci, 0, W - 1)
        vals = jnp.take(flat, idx.reshape(-1), axis=0).reshape(col.shape + (4,))
        return vals, inb
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    r0 = jnp.floor(row)
    c0 = jnp.floor(col)
    wr = (row - r0)[..., None]
    wc = (col - c0)[..., None]
    r0i = jnp.clip(r0.astype(jnp.int32), 0, H - 1)
    c0i = jnp.clip(c0.astype(jnp.int32), 0, W - 1)
    r1i = jnp.clip(r0i + 1, 0, H - 1)
    c1i = jnp.clip(c0i + 1, 0, W - 1)

    def g(ri, ci):
        return jnp.take(flat, (ri * W + ci).reshape(-1), axis=0).reshape(
            col.shape + (4,)
        )

    top = g(r0i, c0i) * (1 - wc) + g(r0i, c1i) * wc
    bot = g(r1i, c0i) * (1 - wc) + g(r1i, c1i) * wc
    return top * (1 - wr) + bot * wr, inb


def packed_normal_equations(
    source_intensity: jax.Array,
    source_depth: jax.Array,
    target_packed: jax.Array,  # (H, W, 4) from pack_target
    state: jax.Array,
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
    sampling: str = "nearest",
    robust_loss: str = "none",
    robust_delta: float = 0.1,
) -> NormalEquations:
    """Normal equations of the photometric residual (target gradients
    sampled at the warped position) with the single packed gather."""
    col, row, _, J_pix, valid_src = warp_and_jacobian(
        source_depth, state, intr, min_depth, max_depth
    )
    vals, inb = _sample_packed(target_packed, col, row, sampling)
    valid = valid_src & inb
    residual = jnp.where(valid, vals[..., 0] - source_intensity, 0.0)
    grad = vals[..., 1:3]
    J = jnp.einsum(
        "...k,...kj->...j", grad, J_pix, precision=jax.lax.Precision.HIGHEST
    )
    J = jnp.where(valid[..., None], J, 0.0)
    return normal_equations(residual, J, valid, robust_loss, robust_delta)
