"""Inverse-compositional Gauss-Newton: constant-Jacobian photometric alignment.

An extension beyond the reference's three backends (which all re-linearize
at the warped position every iteration,
CPhotoconsistencyOdometryAnalytic.h:191-367). The inverse-compositional
(IC) formulation (Baker & Matthews, "Lucas-Kanade 20 Years On") parametrizes
the update on the SOURCE frame:

    min_delta  sum_k [ I1(pi(T x) p_k) - I0(pi(T(delta) p_k)) ]^2

so the Jacobian J0_k = grad I0(p_k) . dpi/dp . dT/ddelta|_0 depends only on
the source frame: J0, J0^T J0 and its Cholesky factor are computed ONCE per
pyramid level, and every GN iteration reduces to

    warp -> sample ONE channel of I1 -> r -> g = J0^T r -> presolved 6x6
    -> T <- T . T(delta)^{-1}

versus the forward backends' three-channel sampling + fresh Jacobian chain +
fresh factorization. The pose is carried as a 4x4 matrix across iterations
and levels; the Euler state is extracted once at the end
(se3.matrix_to_state).

Approximation note (standard for IC trackers): J0^T J0 is accumulated over
all depth-valid source pixels; pixels whose warp leaves the target image in
a given iteration contribute r = 0 but stay in the factored system. The
forward backends drop them from both sides. Near convergence the sets agree;
tests/test_ic.py checks pose agreement with the analytic backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phovo_tpu.ops import se3
from phovo_tpu.ops import warp as warp_ops
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.residuals import warp_and_jacobian


def ic_precompute(
    source_intensity: jax.Array,  # (H, W) float
    source_depth: jax.Array,
    source_grad_x: jax.Array,  # Scharr of the SOURCE intensity
    source_grad_y: jax.Array,
    intr: Intrinsics,
    min_depth: float,
    max_depth: float,
):
    """Constant per-level quantities: packed Jacobian rows and the Cholesky
    factor of J0^T J0.

    Returns (J8 (8, N) = [J0..J5; I0; valid0], L (6, 6) lower-triangular)."""
    H, W = source_intensity.shape
    zero = jnp.zeros(6, jnp.float32)
    # identity-warp projection+rigid Jacobian at each source pixel
    _, _, _, J_pix, valid = warp_and_jacobian(
        source_depth, zero, intr, min_depth, max_depth
    )
    grad = jnp.stack([source_grad_x, source_grad_y], axis=-1)  # (H, W, 2)
    J = jnp.einsum(
        "...k,...kj->...j", grad, J_pix, precision=jax.lax.Precision.HIGHEST
    )  # (H, W, 6)
    validf = valid.astype(jnp.float32)
    J = J * validf[..., None]
    JtJ = jnp.einsum(
        "...i,...j->ij", J, J, precision=jax.lax.Precision.HIGHEST
    )
    # tiny Tikhonov floor keeps the factor finite on degenerate levels
    L = jnp.linalg.cholesky(JtJ + 1e-8 * jnp.eye(6, dtype=JtJ.dtype))
    N = H * W
    J8 = jnp.concatenate(
        [
            J.reshape(N, 6).T,  # rows 0..5
            source_intensity.reshape(1, N),
            validf.reshape(1, N),
        ],
        axis=0,
    )  # (8, N)
    return J8, L


def ic_gn_level(
    T: jax.Array,
    source_depth: jax.Array,
    J8: jax.Array,
    L: jax.Array,
    target_intensity: jax.Array,
    intr: Intrinsics,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float,
    sampling: str = "nearest",
):
    """One IC Gauss-Newton level. Returns (T', iterations, gnorm, cost,
    num_valid)."""
    H, W = source_depth.shape
    N = H * W
    Jrows = J8[:6]  # (6, N)
    i0 = J8[6].reshape(H, W)
    valid0 = J8[7].reshape(H, W) > 0.5
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )

    def linearize(T):
        pz = source_depth
        px = (xs - intr.cx) * pz / intr.fx
        py = (ys - intr.cy) * pz / intr.fy
        R = T[:3, :3]
        t = T[:3, 3]
        tx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
        ty = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
        tz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
        safe_z = jnp.where(jnp.abs(tz) > 1e-12, tz, 1e-12)
        u = tx * intr.fx / safe_z + intr.cx
        v = ty * intr.fy / safe_z + intr.cy
        sample = (
            warp_ops.sample_bilinear if sampling == "bilinear"
            else warp_ops.sample_nearest
        )
        i1w, inb = sample(target_intensity, u, v)
        valid = valid0 & inb & (tz > 0)
        r = jnp.where(valid, i1w - i0, 0.0).reshape(N)
        g = Jrows @ r  # (6,)
        cost = jnp.sum(r * r)
        nvalid = jnp.sum(valid.astype(jnp.float32))
        return g, cost, nvalid

    def cond(carry):
        _, it, gnorm, _, _ = carry
        return (it < max_iterations) & (gnorm >= min_gradient_norm)

    def body(carry):
        T, it, _, _, _ = carry
        g, cost, nvalid = linearize(T)
        delta = jax.scipy.linalg.cho_solve((L, True), g)
        finite = jnp.all(jnp.isfinite(delta))
        Td = se3.pose_matrix(lambda_step * delta)
        Tn = jnp.where(finite, T @ se3.inverse(Td), T)
        return (Tn, it + 1, jnp.linalg.norm(g), cost, nvalid)

    carry = (
        T.astype(jnp.float32), jnp.int32(0), jnp.float32(jnp.inf),
        jnp.float32(0), jnp.float32(0),
    )
    T, it, gnorm, cost, nvalid = jax.lax.while_loop(cond, body, carry)
    return T, it, jnp.where(jnp.isfinite(gnorm), gnorm, 0.0), cost, nvalid
