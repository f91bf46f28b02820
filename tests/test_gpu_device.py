"""On-card regression suite — `python -m pytest tests/test_gpu_device.py -m gpu`.

The CPU suite checks the same arithmetic with XLA's CPU backend; these
re-run the comparisons that depend on what the GPU compiler emits (fused
gathers and reductions, batched while loops, matmul precision) on the card.
Every test takes the `gpu` fixture (tests/conftest.py), which skips it when
JAX's default backend is not a GPU. chip_smoke.py runs this module.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.models.base import align_chain
from phovo_tpu.ops import fused, pyramid
from phovo_tpu.ops.camera import TUM_FR1, Intrinsics
from phovo_tpu.ops.residuals import normal_equations, photometric_residual_jacobian
from phovo_tpu.utils.config import PhovoConfig, load_builtin
from phovo_tpu.utils.synthetic import make_pair, make_sequence

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parents[1]

QVGA = (240, 320)
INTR_QVGA = Intrinsics(
    np.float32(258.5), np.float32(258.5), np.float32(159.5), np.float32(119.5)
)
STATE = jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.008, 0.012], jnp.float32)


def _fixed(cfg: PhovoConfig) -> PhovoConfig:
    """The preset with its early exits off and bilinear sampling: every pair
    runs the whole schedule, so batched and serial orders do identical
    work. (Nearest sampling makes the cost piecewise constant: over a long
    fixed schedule last-bit differences between the two reduction orders
    move samples to neighbouring pixels and the states part by
    centimetres; the bilinear iteration settles.)"""
    n = cfg.num_levels
    return dataclasses.replace(
        cfg, min_gradient_norms=(0.0,) * n, sampling="bilinear",
        function_tolerances=(0.0,) * n if cfg.function_tolerances else None,
        gradient_tolerances=(0.0,) * n if cfg.gradient_tolerances else None,
        parameter_tolerances=(0.0,) * n if cfg.parameter_tolerances else None,
    )


def _backends():
    from phovo_tpu.models.analytic import align_prepped, prep_frame_analytic
    from phovo_tpu.models.autodiff import align_prepped_tr
    from phovo_tpu.models.biobjective import (
        align_prepped_biobjective,
        prep_frame_biobjective,
    )
    from phovo_tpu.models.ic import align_prepped_ic, prep_frame_ic

    gn = load_builtin("config_5_level_optimization_analytic")
    tr = load_builtin("config_5_level_optimization_ceres")
    return {
        "analytic": (prep_frame_analytic, align_prepped, gn),
        "ceres": (prep_frame_analytic, align_prepped_tr, tr),
        "biobjective": (prep_frame_biobjective, align_prepped_biobjective, gn),
        "ic": (prep_frame_ic, align_prepped_ic, gn),
    }


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_packed_normal_equations_on_device(gpu, sampling):
    """Packed gather vs the reference path at VGA: 307,200-term float32
    sums in different orders agree to a few parts in 1e5."""
    I0, D0, I1, _, _ = map(jnp.asarray, make_pair(TUM_FR1, shape=(480, 640)))
    gx = pyramid.scharr(I1, "x", 0.0625)
    gy = pyramid.scharr(I1, "y", 0.0625)
    ne = fused.packed_normal_equations(
        I0, D0, fused.pack_target(I1, gx, gy), STATE, TUM_FR1, 0.3, 5.0,
        sampling,
    )
    r, J, v = photometric_residual_jacobian(
        I0, D0, I1, gx, gy, STATE, TUM_FR1, sampling=sampling
    )
    ref = normal_equations(r, J, v)
    scale = float(jnp.abs(ref.JtJ).max())
    np.testing.assert_allclose(ne.JtJ, ref.JtJ, atol=5e-5 * scale)
    np.testing.assert_allclose(
        ne.Jtr, ref.Jtr, atol=5e-5 * float(jnp.abs(ref.Jtr).max())
    )
    assert float(ne.num_valid) == float(ref.num_valid)


def test_normal_equations_are_float32_on_device(gpu):
    """JtJ must be accumulated in float32, not TF32: against a float64
    host reduction the relative error stays near float32 rounding
    (TF32 operands would leave ~1e-3)."""
    rng = np.random.default_rng(0)
    J = rng.standard_normal((200_000, 6)).astype(np.float32)
    r = rng.standard_normal(200_000).astype(np.float32)
    ne = normal_equations(jnp.asarray(r), jnp.asarray(J), jnp.ones(200_000, bool))
    ref = J.astype(np.float64).T @ J.astype(np.float64)
    rel = np.abs(np.asarray(ne.JtJ, np.float64) - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel


@pytest.mark.parametrize("backend", ["analytic", "ceres", "biobjective", "ic"])
def test_batched_chain_matches_serial_on_device(gpu, backend):
    """The vmapped level-major chain vs the serial scan at QVGA, fixed
    schedule: same iteration counts, states within reassociation noise."""
    prep, align, cfg = _backends()[backend]
    cfg = _fixed(cfg)
    I, D, _, _ = make_sequence(INTR_QVGA, QVGA, n_frames=7, seed=1)
    Is, Ds = jnp.asarray(np.stack(I)), jnp.asarray(np.stack(D))
    chain = jax.jit(
        functools.partial(align_chain, prep, align),
        static_argnames=("config", "warm_start", "batched"),
    )
    b = chain(Is, Ds, INTR_QVGA, config=cfg, warm_start=False, batched=True)
    s = chain(Is, Ds, INTR_QVGA, config=cfg, warm_start=False, batched=False)
    np.testing.assert_array_equal(b.iterations, s.iterations)
    np.testing.assert_allclose(b.state, s.state, atol=1e-4)


@pytest.mark.parametrize("backend", ["analytic", "ceres", "biobjective", "ic"])
def test_early_exit_chain_matches_serial_on_device(gpu, backend):
    """Early exit at VGA, where each pair leaves the vmapped while_loop on
    its own: analytic runs bench.py's early-exit workload (nearest sampling,
    min_gradient_norm 300) through align_sequence and bench.serial_chain,
    the others their shipped 5-level presets. At least one pair stops
    before its level's max_iterations; states within 1e-4. Iteration
    counts must match for the gradient-norm exits; the trust-region
    preset's relative tolerances (1e-4..1e-6) fire on float32 rounding near
    convergence, so its stopping iteration moves with the reduction order
    and only its states are compared."""
    from phovo_tpu.models.analytic import align_sequence

    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    prep, align, cfg = _backends()[backend]
    I, D, _, _ = make_sequence(TUM_FR1, (480, 640), n_frames=9, seed=0)
    Is, Ds = jnp.asarray(np.stack(I)), jnp.asarray(np.stack(D))
    if backend == "analytic":
        cfg = bench.bench_config(300.0)
        b = align_sequence(Is, Ds, TUM_FR1, cfg)
        s = bench.serial_chain(Is, Ds, TUM_FR1, cfg)
    else:
        chain = jax.jit(
            functools.partial(align_chain, prep, align),
            static_argnames=("config", "warm_start", "batched"),
        )
        b = chain(Is, Ds, TUM_FR1, config=cfg, warm_start=False, batched=True)
        s = chain(Is, Ds, TUM_FR1, config=cfg, warm_start=False, batched=False)
    its, full = np.asarray(b.iterations), np.asarray(cfg.max_iterations)
    active = full > 0
    assert (its[:, active] < full[active]).any(), its
    if backend != "ceres":
        np.testing.assert_array_equal(its, s.iterations)
    np.testing.assert_allclose(b.state, s.state, atol=1e-4)


@pytest.mark.parametrize("backend", ["analytic", "ceres"])
def test_track_chunk_matches_per_frame_on_device(gpu, backend):
    """Keyframe chunk tracking (shared keyframe products, batched) vs
    aligning each frame on its own from the same init."""
    from phovo_tpu.models.analytic import align_analytic, align_prepped
    from phovo_tpu.models.autodiff import align_autodiff, align_prepped_tr
    from phovo_tpu.models.keyframe import prep_keyframe, track_chunk

    _, _, cfg = _backends()[backend]
    cfg = _fixed(cfg)
    I, D, _, _ = make_sequence(INTR_QVGA, QVGA, n_frames=5, seed=2)
    Is = jnp.asarray(np.stack(I[1:]))
    kf = prep_keyframe(jnp.asarray(I[0]), jnp.asarray(D[0]), INTR_QVGA, cfg)
    fn, one = (
        (align_prepped, align_analytic) if backend == "analytic"
        else (align_prepped_tr, align_autodiff)
    )
    res = track_chunk(kf, Is, INTR_QVGA, jnp.zeros((4, 6)), cfg, fn, False)
    for k in range(4):
        ref = one(
            jnp.asarray(I[0]), jnp.asarray(D[0]), Is[k], jnp.asarray(D[k + 1]),
            INTR_QVGA, jnp.zeros(6), cfg,
        )
        np.testing.assert_allclose(res.state[k], ref.state, atol=1e-4)


@pytest.mark.parametrize("gradient_at", ["warped", "esm"])
def test_full_alignment_recovers_pose_on_device(gpu, gradient_at):
    """The shipped 5-level schedule run to convergence recovers the
    synthetic VGA pose to 2 mm / 0.11 deg."""
    from phovo_tpu.models.analytic import align_analytic

    I0, D0, I1, D1, gt = make_pair(TUM_FR1, shape=(480, 640))
    cfg = dataclasses.replace(
        _fixed(load_builtin("config_5_level_optimization_analytic")),
        gradient_at=gradient_at,
    )
    res = align_analytic(
        *map(jnp.asarray, (I0, D0, I1, D1)), TUM_FR1, jnp.zeros(6), cfg
    )
    np.testing.assert_allclose(res.state, gt, atol=2e-3)
