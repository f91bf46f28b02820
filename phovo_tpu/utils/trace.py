"""Per-iteration optimization trace — the reference's `visualizeIterations`.

The reference optionally displays the |target - warped source| image after
EVERY Gauss-Newton / trust-region iteration (visualizeIterations config key;
CPhotoconsistencyOdometryAnalytic.h:551-557, CPhotoconsistencyOdometryCeres.h
:272-303 VisualizationCallback). There is no display on a headless server, and the
production solvers run all iterations inside one device program precisely so
nothing crosses the host boundary — so the equivalent here is a separate
*diagnostic replay*: a host-driven loop with the same per-level linearization
and update rule that records the state after every iteration, from which
per-iteration diff images are rendered to PNG files.

The replay uses the same packed-gather linearizer as the solvers, on any
backend; its per-iteration states match the jitted solver's semantics
(update performed, then that linearization's gradient norm gates the next
iteration — solvers/gauss_newton.py) up to the last few ulps. This is a diagnostic, not a production
path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phovo_tpu.ops import fused as fused_ops
from phovo_tpu.ops import pyramid as pyr
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.residuals import biobjective_residual_jacobian, normal_equations
from phovo_tpu.solvers.gauss_newton import solve6
from phovo_tpu.utils.config import PhovoConfig


class TraceRecord(NamedTuple):
    level: int
    iteration: int  # 1-based, within the level
    state: np.ndarray  # (6,) after this iteration's update
    gradient_norm: float  # ||J^T r|| of the linearization that produced it
    cost: float
    num_valid: float


def trace_alignment(
    source_intensity,
    source_depth,
    target_intensity,
    target_depth,
    intr: Intrinsics,
    config: PhovoConfig,
    backend: str = "analytic",
    init_state=None,
) -> list[TraceRecord]:
    """Replay a coarse-to-fine alignment, recording every GN iteration.

    Supports the Gauss-Newton backends ('analytic', 'biobjective'); the
    trust-region backend manages its own radius state and is traced via its
    structured per-level diagnostics instead.
    """
    if backend not in ("analytic", "biobjective"):
        raise ValueError(
            f"iteration trace supports 'analytic' and 'biobjective', not "
            f"{backend!r} (the trust-region backend reports per-level "
            "diagnostics from AlignmentResult instead)"
        )
    from phovo_tpu.models.base import device_unit_intensity

    si = device_unit_intensity(jnp.asarray(source_intensity))
    ti = device_unit_intensity(jnp.asarray(target_intensity))
    sd = jnp.asarray(source_depth, jnp.float32)
    td = jnp.asarray(target_depth, jnp.float32)

    L = config.num_levels
    blur = tuple(config.blur_filter_sizes)
    scales = tuple(config.gradient_scales)
    int0 = pyr.build_pyramid(si, L, blur, blur_type=config.blur_type)
    dep0 = pyr.build_pyramid(sd, L, None)
    int1 = pyr.build_pyramid(ti, L, blur, blur_type=config.blur_type)
    gx1, gy1 = pyr.build_gradient_pyramid(int1, scales)
    esm = config.gradient_at == "esm"
    if esm:
        # ESM needs the SOURCE gradient pyramid too (models/analytic.py)
        gx0, gy0 = pyr.build_gradient_pyramid(int0, scales)
    bi = backend == "biobjective"
    if bi:
        dep1 = pyr.build_pyramid(td, L, None)
        dep1_norm = [d * (1.0 / config.max_depth) for d in dep1]
        dgx1, dgy1 = pyr.build_gradient_pyramid(dep1_norm, scales)

    state = (
        jnp.zeros(6, jnp.float32)
        if init_state is None
        else jnp.asarray(init_state, jnp.float32)
    )
    records: list[TraceRecord] = []
    # robust_loss='tdist': replay the solvers' adaptive-scale carry
    # (models/analytic.py): sigma flows coarse -> fine, with scale-only
    # burn-in at the first active level
    tdist = config.robust_loss == "tdist"
    if tdist:
        from phovo_tpu.ops.robust import TDIST_BURNIN, tdist_scale_update

        sigma = jnp.float32(config.robust_delta)
        first_active = True
    for level in range(L - 1, -1, -1):
        iters = config.max_iterations[level]
        if iters <= 0:
            continue
        intr_l = intr.at_level(level)
        if bi:
            gain = jnp.mean(int1[level]) / jnp.mean(dep1[level])

            def linearize(s, *sigma, _l=level, _intr=intr_l, _gain=gain):
                r, J, valid = biobjective_residual_jacobian(
                    int0[_l], dep0[_l], int1[_l], dep1[_l],
                    gx1[_l], gy1[_l], dgx1[_l], dgy1[_l],
                    s, _intr,
                    min_depth=config.min_depth, max_depth=config.max_depth,
                    sampling=config.sampling, gradient_at=config.gradient_at,
                    depth_gain=_gain,
                )
                return normal_equations(
                    r, J, valid, config.robust_loss,
                    sigma[0] if sigma else config.robust_delta,
                )

        elif config.gradient_at == "warped":
            packed = fused_ops.pack_target(int1[level], gx1[level], gy1[level])

            def linearize(s, *sigma, _l=level, _intr=intr_l, _packed=packed):
                return fused_ops.packed_normal_equations(
                    int0[_l], dep0[_l], _packed, s, _intr,
                    config.min_depth, config.max_depth, config.sampling,
                    config.robust_loss,
                    sigma[0] if sigma else config.robust_delta,
                )

        else:  # 'source'/'esm' replay the reference-shaped path

            def linearize(s, *sigma, _l=level, _intr=intr_l):
                from phovo_tpu.ops.residuals import photometric_residual_jacobian

                r, J, valid = photometric_residual_jacobian(
                    int0[_l], dep0[_l], int1[_l], gx1[_l], gy1[_l], s, _intr,
                    min_depth=config.min_depth, max_depth=config.max_depth,
                    sampling=config.sampling, gradient_at=config.gradient_at,
                    source_grad_x=gx0[_l] if esm else None,
                    source_grad_y=gy0[_l] if esm else None,
                )
                return normal_equations(
                    r, J, valid, config.robust_loss,
                    sigma[0] if sigma else config.robust_delta,
                )

        linearize = jax.jit(linearize)
        lam = config.lambda_steps[level]
        min_g = config.min_gradient_norms[level]
        if tdist and first_active:
            for _ in range(TDIST_BURNIN):
                ne = linearize(state, sigma)
                sigma = tdist_scale_update(ne.cost, ne.num_valid)
            first_active = False
        for it in range(1, iters + 1):
            if tdist:
                ne = linearize(state, sigma)
                sigma = tdist_scale_update(ne.cost, ne.num_valid)
            else:
                ne = linearize(state)
            step = solve6(ne.JtJ, ne.Jtr)
            ok = jnp.all(jnp.isfinite(step))
            state = jnp.where(ok, state - lam * step, state)
            gnorm = float(jnp.linalg.norm(ne.Jtr))
            records.append(
                TraceRecord(
                    level=level,
                    iteration=it,
                    state=np.asarray(state),
                    gradient_norm=gnorm,
                    cost=float(ne.cost),
                    num_valid=float(ne.num_valid),
                )
            )
            if gnorm < min_g:
                break
    return records


def save_iteration_diffs(
    records: list[TraceRecord],
    source_intensity,
    source_depth,
    target_intensity,
    intr: Intrinsics,
    out_dir,
) -> list[str]:
    """Render each traced state as a full-resolution |target - warped source|
    PNG (named level{L}_iter{N}.png). The reference displays the diff at the
    current pyramid level's resolution; full resolution is rendered here as
    the strictly-more-informative variant (deliberate divergence)."""
    from pathlib import Path

    from phovo_tpu.utils.viz import alignment_diff, save_image

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = np.asarray(source_intensity, np.float32)
    if src.max() > 1.5:  # u8-range input
        src = src / 255.0
    tgt = np.asarray(target_intensity, np.float32)
    if tgt.max() > 1.5:
        tgt = tgt / 255.0
    paths = []
    for rec in records:
        # src/tgt were normalized to [0, 1] above, so the diff is unit-range
        diff = alignment_diff(src, source_depth, tgt, rec.state, intr)
        p = out / f"level{rec.level}_iter{rec.iteration:03d}.png"
        save_image(p, diff, unit_range=True)
        paths.append(str(p))
    return paths
