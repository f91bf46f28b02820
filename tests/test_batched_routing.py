"""Batched chains: per-pair freeze, keyframe tracking, routing, sharding.

Companion of tests/test_batched.py: the properties of the batched
(level-major) path beyond per-case agreement with the serial scan."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.models import analytic, autodiff, biobjective, ic
from phovo_tpu.models.base import align_chain
from phovo_tpu.models.keyframe import prep_keyframe, track_chunk
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.utils.config import PhovoConfig
from phovo_tpu.utils.synthetic import make_sequence

SHAPE = (48, 64)
INTR = Intrinsics(
    np.float32(64.0), np.float32(64.0), np.float32(31.5), np.float32(23.5)
)
GN = PhovoConfig(
    num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2,
    max_iterations=(4, 6), lambda_steps=(1.0, 1.0),
    min_gradient_norms=(1.0, 1.0), sampling="bilinear",
)
TR = dataclasses.replace(
    GN, function_tolerances=(1e-2,) * 2, gradient_tolerances=(1e-3,) * 2,
    parameter_tolerances=(1e-2,) * 2,
)
IC = dataclasses.replace(
    GN, gradient_scales=(0.03125,) * 2, min_gradient_norms=(0.05, 0.05)
)
BACKENDS = {
    "analytic": (analytic.prep_frame_analytic, analytic.align_prepped, GN),
    "ceres": (analytic.prep_frame_analytic, autodiff.align_prepped_tr, TR),
    "biobjective": (
        biobjective.prep_frame_biobjective,
        biobjective.align_prepped_biobjective, GN,
    ),
    "ic": (ic.prep_frame_ic, ic.align_prepped_ic, IC),
}
SEQUENCE_FNS = {
    "analytic": analytic.align_sequence,
    "ceres": autodiff.align_sequence_autodiff,
    "biobjective": biobjective.align_sequence_biobjective,
    "ic": ic.align_sequence_ic,
}


@functools.lru_cache(maxsize=None)
def _frames(n: int = 4, seed: int = 5):
    I, D, _, _ = make_sequence(INTR, SHAPE, n_frames=n, seed=seed)
    return np.stack(I), np.stack(D)


def _chain(backend, Is, Ds, batched):
    prep, align, cfg = BACKENDS[backend]
    return jax.jit(
        functools.partial(align_chain, prep, align),
        static_argnames=("config", "warm_start", "batched"),
    )(Is, Ds, INTR, config=cfg, warm_start=False, batched=batched)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_per_pair_freeze_and_iteration_counts(backend):
    """A batch whose pairs need different work: pair 1 aligns a frame with
    itself and stops after one iteration per level, the others run on.
    The batched loop runs until its slowest pair stops, but every pair
    keeps its own iteration count and its frozen state."""
    I, D = _frames()
    Is = jnp.asarray(np.stack([I[0], I[1], I[1], I[2]]))
    Ds = jnp.asarray(np.stack([D[0], D[1], D[1], D[2]]))
    b = _chain(backend, Is, Ds, batched=True)
    s = _chain(backend, Is, Ds, batched=False)
    its = np.asarray(b.iterations)
    np.testing.assert_array_equal(its, np.asarray(s.iterations))
    assert (its[1] <= 1).all(), its  # the identity pair stops at once
    assert its[0].sum() > its[1].sum() and its[2].sum() > its[1].sum(), its
    np.testing.assert_allclose(np.asarray(b.state[1]), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(b.state), np.asarray(s.state),
                               atol=1e-5)


@pytest.mark.parametrize("warm_chain", [False, True])
@pytest.mark.parametrize("backend", ["analytic", "ceres"])
def test_shared_keyframe_track_matches_per_frame(backend, warm_chain):
    """track_chunk (one keyframe's products shared by the whole chunk) vs
    aligning each frame on its own: from the same init when batched, and
    from the previous frame's result on the warm chain."""
    _, align_fn, cfg = BACKENDS[backend]
    one = (
        analytic.align_analytic if backend == "analytic"
        else autodiff.align_autodiff
    )
    I, D = _frames(5)
    kf = prep_keyframe(jnp.asarray(I[0]), jnp.asarray(D[0]), INTR, cfg)
    init = jnp.asarray([0.001, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    res = track_chunk(
        kf, jnp.asarray(I[1:]), INTR, jnp.broadcast_to(init, (4, 6)), cfg,
        align_fn, warm_chain,
    )
    x = init
    for k in range(4):
        ref = one(jnp.asarray(I[0]), jnp.asarray(D[0]), jnp.asarray(I[k + 1]),
                  jnp.asarray(D[k + 1]), INTR, x if warm_chain else init, cfg)
        np.testing.assert_allclose(np.asarray(res.state[k]),
                                   np.asarray(ref.state), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(res.iterations[k]),
                                      np.asarray(ref.iterations))
        x = ref.state


def _primitives(jaxpr, out=None):
    out = set() if out is None else out
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _primitives(inner, out)
    return out


@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("backend", list(SEQUENCE_FNS))
def test_sequence_routing(backend, warm_start):
    """Zero-init chains take the batched path (no scan over pairs); a
    warm start scans the pairs in order."""
    I, D = _frames()
    cfg = BACKENDS[backend][2]
    jaxpr = jax.make_jaxpr(
        lambda a, b: SEQUENCE_FNS[backend](
            a, b, INTR, cfg, warm_start=warm_start
        )
    )(jnp.asarray(I), jnp.asarray(D))
    assert ("scan" in _primitives(jaxpr.jaxpr)) is warm_start


def test_tdist_routes_to_the_scan():
    """robust_loss='tdist' routes like any other loss: a warm-started chain
    scans the pairs in order, a zero-init chain is one batch (the vmapped
    loops carry one adaptive scale per pair; tests/test_batched.py checks
    its agreement with the scan)."""
    I, D = _frames()
    cfg = dataclasses.replace(GN, robust_loss="tdist")
    for warm_start in (True, False):
        jaxpr = jax.make_jaxpr(
            lambda a, b: analytic.align_sequence(a, b, INTR, cfg, warm_start)
        )(jnp.asarray(I), jnp.asarray(D))
        assert ("scan" in _primitives(jaxpr.jaxpr)) is warm_start


@pytest.mark.parametrize("n_data", [2, 4, 8])
def test_sharded_batch_on_virtual_mesh(n_data):
    """make_multi_sequence_server (shard_map over 'data', each device
    batching its own streams) vs the 1-device align_sequences."""
    from phovo_tpu.parallel.batch import (
        align_sequences,
        make_multi_sequence_server,
    )
    from phovo_tpu.parallel.mesh import make_mesh

    I, D = _frames(3)
    S = n_data
    Is = jnp.asarray(np.stack([I] * S)) + (
        jnp.arange(S, dtype=jnp.float32)[:, None, None, None] * 0.002
    )
    Ds = jnp.asarray(np.stack([D] * S))
    sh, _ = make_multi_sequence_server(make_mesh(n_data), GN)(Is, Ds, INTR)
    single, _ = align_sequences(Is, Ds, INTR, GN)
    assert sh.state.shape == (S, 2, 6)
    np.testing.assert_allclose(np.asarray(sh.state), np.asarray(single.state),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(sh.iterations),
                                  np.asarray(single.iterations))


def test_sharded_server_per_camera_intrinsics():
    """make_multi_sequence_server with (S,) intrinsics vectors: each
    device receives its own streams' cameras."""
    from phovo_tpu.parallel.batch import (
        align_sequences,
        make_multi_sequence_server,
    )
    from phovo_tpu.parallel.mesh import make_mesh

    I, D = _frames(3)
    S = 4
    Is = jnp.asarray(np.stack([I] * S))
    Ds = jnp.asarray(np.stack([D] * S))
    f = jnp.asarray([60.0, 62.0, 64.0, 66.0], jnp.float32)
    intr = Intrinsics(f, f, jnp.full(S, 31.5), jnp.full(S, 23.5))
    sh, poses = make_multi_sequence_server(make_mesh(S), GN)(Is, Ds, intr)
    single, single_poses = align_sequences(Is, Ds, intr, GN)
    np.testing.assert_allclose(np.asarray(sh.state), np.asarray(single.state),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(poses), np.asarray(single_poses),
                               atol=1e-5)
    # distinct cameras give distinct solutions
    assert np.abs(np.asarray(sh.state[0] - sh.state[3])).max() > 1e-4
