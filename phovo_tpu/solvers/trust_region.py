"""Trust-region Levenberg-Marquardt honoring the Ceres parameter schema.

The reference delegates its autodiff backend to Ceres's trust-region LM with
per-level options read from YAML (CPhotoconsistencyOdometryCeres.h:464-477:
max iterations, function/gradient/parameter tolerances, initial/max/min
trust-region radius, min_relative_decrease). This module is a from-scratch
jit-compilable LM with the same control parameters and Ceres's radius-update
rule, so the reference's 8 ceres config presets drive it unchanged.

The solver consumes reduced NormalEquations (JtJ, Jtr, cost) from any
linearizer — the packed-gather linearizer in production (models/autodiff.py), or
jacfwd of a pure residual (the validation path; `residual_to_linearizer`).
The step model is classic Levenberg-Marquardt on the normal equations:
    (J^T J + (1/radius) * diag(J^T J)) dx = -J^T r
(Ceres's LevenbergMarquardtStrategy with Jacobi scaling approximated by the
JtJ diagonal). Accept when rho = actual/predicted decrease exceeds
min_relative_decrease; radius grows as radius / max(1/3, 1 - (2 rho - 1)^3)
on acceptance and shrinks by 0.5 on rejection (Ceres's update rule).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from phovo_tpu.ops.residuals import NormalEquations
from phovo_tpu.solvers.gauss_newton import solve6


class TRLevelResult(NamedTuple):
    state: jax.Array  # (6,)
    iterations: jax.Array  # int32
    cost: jax.Array  # final accepted cost (0.5 * sum r^2)
    gradient_norm: jax.Array  # max-norm of J^T r at termination
    radius: jax.Array  # final trust-region radius
    num_valid: jax.Array  # valid pixels at last accepted linearization


class TROptions(NamedTuple):
    max_iterations: int = 50
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3


def residual_to_linearizer(
    residual_and_jacobian: Callable[[jax.Array], tuple[jax.Array, jax.Array]],
    robust_loss: str = "none",
    robust_delta: float = 0.1,
    num_valid_fn: Callable[[jax.Array], jax.Array] | None = None,
) -> Callable[[jax.Array], NormalEquations]:
    """Adapt an (r, J)-producing function (e.g. jacfwd of a pure residual)
    to the NormalEquations interface. With a robust loss, rows are IRLS
    reweighted by sqrt(w(r)) (ops/robust.py).

    num_valid_fn(state) supplies the valid-pixel diagnostic (the residual
    vector alone cannot distinguish invalid rows from perfectly-aligned
    ones); without it num_valid reports 0, which downstream consumers like
    the keyframe overlap gate would misread as zero overlap."""

    def linearize(state) -> NormalEquations:
        r, J = residual_and_jacobian(state)
        if robust_loss != "none":
            from phovo_tpu.ops.robust import sqrt_weight

            sw = sqrt_weight(r, robust_loss, robust_delta)
            r = r * sw
            J = J * sw[:, None]
        JtJ = jnp.einsum(
            "ni,nj->ij", J, J, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        Jtr = jnp.einsum("ni,n->i", J, r, precision=jax.lax.Precision.HIGHEST)
        cost = jnp.dot(r, r)
        nv = (
            jnp.float32(0.0) if num_valid_fn is None
            else jnp.asarray(num_valid_fn(state), jnp.float32)
        )
        return NormalEquations(JtJ, Jtr, cost, nv)

    return linearize


def trust_region_level(
    linearize: Callable[[jax.Array], NormalEquations],
    init_state: jax.Array,
    opts: TROptions,
) -> TRLevelResult:
    """Run trust-region LM at one pyramid level.

    linearize(state) -> NormalEquations (cost convention: sum of squared
    residuals; the LM bookkeeping uses 0.5x internally like Ceres).
    """
    init_state = jnp.asarray(init_state, dtype=jnp.float32)
    if opts.max_iterations <= 0:
        zero = jnp.float32(0.0)
        return TRLevelResult(
            init_state, jnp.int32(0), zero, zero,
            jnp.float32(opts.initial_trust_region_radius), zero,
        )

    ne0 = linearize(init_state)
    cost0 = 0.5 * ne0.cost

    # carry: state, cost, JtJ, Jtr, num_valid, radius, iteration, done
    def cond(carry):
        return (carry[-2] < opts.max_iterations) & jnp.logical_not(carry[-1])

    def body(carry):
        state, cost, JtJ, Jtr, nv, radius, it, _ = carry
        diag = jnp.clip(jnp.diag(JtJ), 1e-12, 1e32)
        A = JtJ + jnp.diag(diag) / radius
        step = solve6(A, -Jtr)
        step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))

        new_state = state + step
        ne = linearize(new_state)
        new_cost = 0.5 * ne.cost

        # rho = actual decrease / model decrease for the LM step
        predicted = -jnp.dot(step, Jtr) - 0.5 * jnp.dot(step, JtJ @ step)
        predicted = jnp.maximum(predicted, 1e-30)
        rho = (cost - new_cost) / predicted

        accept = rho > opts.min_relative_decrease
        grow = radius / jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        new_radius = jnp.where(
            accept, jnp.minimum(grow, opts.max_trust_region_radius), radius * 0.5
        )

        state_n = jnp.where(accept, new_state, state)
        cost_n = jnp.where(accept, new_cost, cost)
        JtJ_n = jnp.where(accept, ne.JtJ, JtJ)
        Jtr_n = jnp.where(accept, ne.Jtr, Jtr)
        nv_n = jnp.where(accept, ne.num_valid, nv)

        f_done = accept & (jnp.abs(cost - new_cost) <= opts.function_tolerance * cost)
        g_done = jnp.max(jnp.abs(Jtr_n)) <= opts.gradient_tolerance
        p_done = accept & (
            jnp.linalg.norm(step)
            <= opts.parameter_tolerance * (jnp.linalg.norm(state) + opts.parameter_tolerance)
        )
        r_done = new_radius < opts.min_trust_region_radius
        done = f_done | g_done | p_done | r_done
        return (state_n, cost_n, JtJ_n, Jtr_n, nv_n, new_radius, it + 1, done)

    init = (
        init_state,
        cost0,
        ne0.JtJ,
        ne0.Jtr,
        ne0.num_valid,
        jnp.float32(opts.initial_trust_region_radius),
        jnp.int32(0),
        jnp.max(jnp.abs(ne0.Jtr)) <= opts.gradient_tolerance,
    )
    state, cost, _, Jtr, nv, radius, it, _ = jax.lax.while_loop(cond, body, init)
    return TRLevelResult(state, it, cost, jnp.max(jnp.abs(Jtr)), radius, nv)
