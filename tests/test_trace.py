"""Per-iteration trace diagnostics (the reference's visualizeIterations)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.utils.config import PhovoConfig
from phovo_tpu.utils.trace import save_iteration_diffs, trace_alignment

CFG = PhovoConfig(
    num_levels=2,
    blur_filter_sizes=(0, 0),
    gradient_scales=(0.0625,) * 2,
    max_iterations=(3, 5),
    lambda_steps=(1.0,) * 2,
    min_gradient_norms=(0.0,) * 2,
    sampling="bilinear",
)


def test_trace_matches_solver_final_state(intr, small_pair):
    """The replay's last recorded state equals the jitted solver's result
    (same linearizer path, same update rule)."""
    from phovo_tpu.models.analytic import align_analytic

    I0, D0, I1, D1, _ = small_pair
    records = trace_alignment(I0, D0, I1, D1, intr, CFG, backend="analytic")
    assert len(records) == 3 + 5  # full budgets: min_gradient_norm 0
    # coarse-to-fine: level 1 runs max_iterations[1]=5, then level 0 runs 3
    assert [r.level for r in records] == [1] * 5 + [0] * 3
    res = align_analytic(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6, jnp.float32), CFG,
    )
    np.testing.assert_allclose(
        records[-1].state, np.asarray(res.state), atol=1e-5
    )
    # costs decrease over the fine level
    fine = [r.cost for r in records if r.level == 0]
    assert fine[-1] <= fine[0]


def test_trace_termination_criterion(intr, small_pair):
    """A large min_gradient_norm stops each level after one iteration,
    matching the solver's update-then-gate semantics."""
    I0, D0, I1, D1, _ = small_pair
    cfg = dataclasses.replace(CFG, min_gradient_norms=(1e12, 1e12))
    records = trace_alignment(I0, D0, I1, D1, intr, cfg, backend="analytic")
    assert [(r.level, r.iteration) for r in records] == [(1, 1), (0, 1)]


def test_trace_biobjective_runs(intr, small_pair):
    I0, D0, I1, D1, _ = small_pair
    cfg = dataclasses.replace(CFG, max_iterations=(2, 2))
    records = trace_alignment(I0, D0, I1, D1, intr, cfg, backend="biobjective")
    assert len(records) == 4
    assert all(np.isfinite(r.state).all() for r in records)


def test_trace_rejects_unsupported_backend(intr, small_pair):
    I0, D0, I1, D1, _ = small_pair
    with pytest.raises(ValueError, match="trust-region"):
        trace_alignment(I0, D0, I1, D1, intr, CFG, backend="ceres")


def test_save_iteration_diffs(intr, small_pair, tmp_path):
    I0, D0, I1, D1, _ = small_pair
    cfg = dataclasses.replace(CFG, max_iterations=(1, 2))
    records = trace_alignment(I0, D0, I1, D1, intr, cfg)
    paths = save_iteration_diffs(records, I0, D0, I1, intr, tmp_path)
    assert len(paths) == 3
    import cv2

    img = cv2.imread(paths[-1], cv2.IMREAD_GRAYSCALE)
    assert img is not None and img.shape == I0.shape


def test_trace_honors_gradient_at_source(intr, small_pair):
    """gradient_at: 'source' replays through the reference-shaped linearizer
    (regression: the trace used warped gradients regardless, diverging from
    the solver it documents)."""
    from phovo_tpu.models.analytic import align_analytic

    I0, D0, I1, D1, _ = small_pair
    cfg = dataclasses.replace(CFG, gradient_at="source")
    records = trace_alignment(I0, D0, I1, D1, intr, cfg, backend="analytic")
    res = align_analytic(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6, jnp.float32), cfg,
    )
    np.testing.assert_allclose(
        records[-1].state, np.asarray(res.state), atol=1e-5
    )


def test_trace_esm_matches_solver(intr, small_pair):
    """gradient_at: 'esm' builds the source gradient pyramid in the replay
    (regression: the trace crashed with 'esm needs source_grad_x/y')."""
    from phovo_tpu.models.analytic import align_analytic

    I0, D0, I1, D1, _ = small_pair
    cfg = dataclasses.replace(CFG, gradient_at="esm")
    records = trace_alignment(I0, D0, I1, D1, intr, cfg, backend="analytic")
    res = align_analytic(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6, jnp.float32), cfg,
    )
    np.testing.assert_allclose(
        records[-1].state, np.asarray(res.state), atol=1e-5
    )


def test_trace_tdist_matches_solver(intr, small_pair):
    """robust_loss: 'tdist' replays the solver's adaptive-scale carry
    (burn-in at the first active level + per-iteration fixed-point step)."""
    from phovo_tpu.models.analytic import align_analytic

    I0, D0, I1, D1, _ = small_pair
    cfg = dataclasses.replace(CFG, robust_loss="tdist", robust_delta=0.1)
    records = trace_alignment(I0, D0, I1, D1, intr, cfg, backend="analytic")
    res = align_analytic(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6, jnp.float32), cfg,
    )
    np.testing.assert_allclose(
        records[-1].state, np.asarray(res.state), atol=1e-5
    )
