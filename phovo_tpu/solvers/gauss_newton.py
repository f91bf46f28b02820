"""Lambda-damped Gauss-Newton with the reference termination criteria.

Reference loop being re-designed: CPhotoconsistencyOdometryAnalytic.h:499-563
(per level: g = J^T r; x <- x - lambda * (J^T J)^{-1} g; stop on iteration
count >= max_num_iterations[level] or ||g|| < min_gradient_norm[level],
…Analytic.h:376-426). Here the loop is a lax.while_loop so a whole
multi-level Optimize jits into a single XLA program with no host round-trips.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from phovo_tpu.ops.residuals import NormalEquations


class GNLevelResult(NamedTuple):
    state: jax.Array  # (6,) final state for this level
    iterations: jax.Array  # int32: number of GN updates performed
    gradient_norm: jax.Array  # ||J^T r|| at the last performed update
    cost: jax.Array  # sum of squared residuals at the last linearization
    num_valid: jax.Array  # valid-pixel count at the last linearization


def solve6(A: jax.Array, b: jax.Array) -> jax.Array:
    """Unrolled 6x6 Cholesky solve (A symmetric positive definite).

    jnp.linalg.solve lowers to a general LU solve, a library call per
    iteration that a frame running 75 GN iterations pays 75 times. The
    unrolled scalar DAG (~150 flops) fuses into the surrounding kernel and
    vmaps over a batch of pairs as plain elementwise work. Non-PD pivots are guarded to keep the result finite
    (the caller additionally zero-guards).
    """
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = A[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            s = A[j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    # forward substitution L y = b
    ys = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * ys[k]
        ys[i] = s / L[i][i]
    # back substitution L^T x = y
    xs = [None] * 6
    for i in range(5, -1, -1):
        s = ys[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * xs[k]
        xs[i] = s / L[i][i]
    return jnp.stack(xs)


def _solve_step(JtJ: jax.Array, g: jax.Array, damping: float) -> jax.Array:
    """(JtJ + damping I)^{-1} g with a non-finite guard (the reference inverts
    blindly, …Analytic.h:540; a singular system there silently produces NaNs
    that propagate — here a NaN/Inf step degrades to zero so the solver
    freezes instead of diverging)."""
    A = JtJ + damping * jnp.eye(6, dtype=JtJ.dtype)
    step = solve6(A, g)
    ok = jnp.all(jnp.isfinite(step))
    return jnp.where(ok, step, jnp.zeros_like(step))


def gauss_newton_level(
    linearize: Callable[[jax.Array], NormalEquations],
    init_state: jax.Array,
    max_iterations: int,
    min_gradient_norm: float,
    lambda_step: float = 1.0,
    damping: float = 0.0,
    adaptive_scale=None,
    adaptive_burnin: int = 0,
) -> GNLevelResult:
    """Run Gauss-Newton at one pyramid level.

    linearize(state) -> NormalEquations for the level's image data (closed
    over by the caller; static shapes per level so each level compiles once).

    adaptive_scale (robust_loss='tdist'): initial residual scale sigma0
    (float or traced scalar — the caller carries it across levels);
    linearize is then called as linearize(state, sigma) and sigma is
    re-estimated each iteration from the reweighted cost the linearization
    returns (one t-distribution fixed-point step per GN iteration,
    ops/robust.py tdist_scale_update — the DVO scheme). adaptive_burnin
    runs that fixed point N extra times at the initial state (no state
    update) before iterating — used at the first active level, where the
    config seed sigma0 can be far off and a nearly-unweighted first step
    would commit to an outlier-biased basin. The final sigma is recoverable
    by the caller as tdist_scale_update(result.cost, result.num_valid).

    Semantics match the reference: an update is performed, then the gradient
    norm of THAT linearization gates the next iteration; max_iterations == 0
    leaves the state untouched (skipped level,
    …Analytic.h:526 / config_only_level_k presets).
    """
    init_state = jnp.asarray(init_state, dtype=jnp.float32)
    if max_iterations <= 0:
        zero = jnp.float32(0.0)
        return GNLevelResult(init_state, jnp.int32(0), zero, zero, zero)

    tdist = adaptive_scale is not None
    if tdist:
        from phovo_tpu.ops.robust import tdist_scale_update

        sigma0 = jnp.asarray(adaptive_scale, jnp.float32)
        for _ in range(adaptive_burnin):
            ne = linearize(init_state, sigma0)
            sigma0 = tdist_scale_update(ne.cost, ne.num_valid)

    def cond(carry):
        it, gnorm = carry[1], carry[2]
        return (it < max_iterations) & (gnorm >= min_gradient_norm)

    def body(carry):
        state = carry[0]
        if tdist:
            ne = linearize(state, carry[5])
            sigma = tdist_scale_update(ne.cost, ne.num_valid)
        else:
            ne = linearize(state)
        step = _solve_step(ne.JtJ, ne.Jtr, damping)
        new_state = state - lambda_step * step
        gnorm = jnp.linalg.norm(ne.Jtr)
        out = (new_state, carry[1] + 1, gnorm, ne.cost, ne.num_valid)
        return out + ((sigma,) if tdist else ())

    init = (
        init_state,
        jnp.int32(0),
        jnp.float32(jnp.inf),
        jnp.float32(0.0),
        jnp.float32(0.0),
    ) + ((sigma0,) if tdist else ())
    final = jax.lax.while_loop(cond, body, init)
    state, it, gnorm, cost, nvalid = final[:5]
    return GNLevelResult(state, it, gnorm, cost, nvalid)
