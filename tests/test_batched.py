"""Batched (level-major) frame chains vs the serial per-pair scan.

models/base.py align_chain solves the pairs of a zero-init chain as one
batch — jax.vmap of the backend's per-pair solve, so every pyramid level
advances all pairs in lockstep — or scans them in order. Both orders run
the same per-pair arithmetic; only the reduction order of the batched
sums differs, so states agree to float32 reassociation noise and
iteration counts exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.models.analytic import align_prepped, prep_frame_analytic
from phovo_tpu.models.autodiff import align_prepped_tr
from phovo_tpu.models.base import align_chain
from phovo_tpu.models.biobjective import (
    align_prepped_biobjective,
    prep_frame_biobjective,
)
from phovo_tpu.models.ic import align_prepped_ic, prep_frame_ic
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.utils.config import PhovoConfig
from phovo_tpu.utils.synthetic import make_sequence

SHAPE = (48, 64)
INTR = Intrinsics(
    np.float32(64.0), np.float32(64.0), np.float32(31.5), np.float32(23.5)
)
BACKENDS = {
    "analytic": (prep_frame_analytic, align_prepped),
    "ceres": (prep_frame_analytic, align_prepped_tr),
    "biobjective": (prep_frame_biobjective, align_prepped_biobjective),
    "ic": (prep_frame_ic, align_prepped_ic),
}


@functools.lru_cache(maxsize=None)
def _frames(n: int = 4, seed: int = 3):
    I, D, _, _ = make_sequence(INTR, SHAPE, n_frames=n, seed=seed)
    return jnp.asarray(np.stack(I)), jnp.asarray(np.stack(D))


def _config(backend, sampling, loss, gradient_at, early):
    """A 2-level schedule; `early` turns on the backend's early exit at a
    threshold that fires mid-schedule on these frames. Nearest sampling
    gets a shorter schedule (see test_batched_chain_matches_serial)."""
    nearest = sampling == "nearest"
    exit_at = {"ic": 16.0 if nearest else 0.05}.get(
        backend, 100.0 if nearest else 1.0
    )
    if nearest:
        schedule = (3, 3) if early else (2, 2)
    else:
        schedule = (4, 6)
    kw = dict(
        num_levels=2, blur_filter_sizes=(0, 0),
        gradient_scales=(0.0625,) * 2,
        max_iterations=schedule,
        lambda_steps=(1.0, 1.0),
        min_gradient_norms=(exit_at,) * 2 if early else (0.0, 0.0),
        sampling=sampling, gradient_at=gradient_at,
        robust_loss=loss, robust_delta=0.05,
    )
    if backend == "ceres":
        tol = 1e-2 if early else 0.0
        kw.update(
            function_tolerances=(tol,) * 2, gradient_tolerances=(0.0,) * 2,
            parameter_tolerances=(tol,) * 2,
        )
    if backend == "ic":
        kw["gradient_scales"] = (0.03125,) * 2
    return PhovoConfig(**kw)


def _chain(backend, cfg, batched, n=4, seed=3):
    prep, align = BACKENDS[backend]
    Is, Ds = _frames(n, seed)
    return jax.jit(
        functools.partial(align_chain, prep, align),
        static_argnames=("config", "warm_start", "batched"),
    )(Is, Ds, INTR, config=cfg, warm_start=False, batched=batched)


CASES = (
    [
        ("analytic", s, loss, g, early)
        for s in ("nearest", "bilinear")
        for loss in ("none", "huber")
        for g in ("warped", "esm")
        for early in (False, True)
    ]
    + [("analytic", "bilinear", "tdist", "warped", early)
       for early in (False, True)]
    + [("ceres", "bilinear", loss, "warped", early)
       for loss in ("none", "huber") for early in (False, True)]
    + [
        ("biobjective", s, loss, "warped", early)
        for s in ("nearest", "bilinear")
        for loss in ("none", "huber")
        for early in (False, True)
    ]
    + [("ic", s, "none", "warped", early)
       for s in ("nearest", "bilinear") for early in (False, True)]
)


@pytest.mark.parametrize(
    "backend,sampling,loss,gradient_at,early", CASES,
    ids=["-".join(str(x) for x in c) for c in CASES],
)
def test_batched_chain_matches_serial(backend, sampling, loss, gradient_at,
                                      early):
    """Nearest sampling rounds the warped coordinates: a 1e-7 difference
    between the two reduction orders can move one pixel's sample to its
    neighbour, a discrete jump the next iterations carry on. Its cases run
    at most 2-3 iterations per level and are held to 1e-4; bilinear
    sampling is continuous and held to 1e-5 over 4+6 iterations. The
    tdist cases use bilinear sampling only: with nearest sampling the
    adaptive scale amplifies those jumps, so that a 1e-7 relative change
    of the input intensities moves the serial scan's own result by 1.5e-4
    (XLA's CPU backend, these frames)."""
    cfg = _config(backend, sampling, loss, gradient_at, early)
    b = _chain(backend, cfg, batched=True)
    s = _chain(backend, cfg, batched=False)
    assert b.state.shape == (3, 6) and b.iterations.shape == (3, 2)
    its = np.asarray(b.iterations)
    np.testing.assert_array_equal(its, np.asarray(s.iterations))
    np.testing.assert_allclose(
        np.asarray(b.state), np.asarray(s.state),
        atol=1e-4 if sampling == "nearest" else 1e-5,
    )
    np.testing.assert_allclose(np.asarray(b.num_valid),
                               np.asarray(s.num_valid), atol=0.5)
    full = np.asarray(cfg.max_iterations)[None, :]
    if early:
        assert (its < full).any(), its
    else:
        assert (its == full).all(), its
