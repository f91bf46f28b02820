"""Data-parallel batched alignment over a device mesh.

The reference aligns one pair at a time on one core. Here the same math
vmaps over a batch of frame pairs (sliding-window odometry, multi-sequence
serving, relocalization candidate scoring) and shards the batch over the
mesh "data" axis — each pair lives on one device, so the per-pair work
needs no cross-device communication.

A vmapped solver keeps each pair's own schedule: lax.while_loop over a
batched carry runs until EVERY pair's termination criterion fires, and a
pair that has stopped keeps its state (the batching rule selects the old
carry for it). Results match serial alignment up to the reassociation of
the batched reductions; tests/test_parallel.py checks the agreement.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from phovo_tpu.models.analytic import (
    align_analytic,
    align_sequence,
    align_sequence_chunk,
)
from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.parallel.mesh import DATA_AXIS
from phovo_tpu.utils.config import PhovoConfig


def _intr_axes(intr: Intrinsics) -> Intrinsics:
    """vmap in_axes for intrinsics: scalars are shared, (B,) vectors are
    per item."""
    return Intrinsics(*(0 if jnp.ndim(v) > 0 else None for v in intr))


@functools.partial(jax.jit, static_argnames=("config",))
def align_batch(
    source_intensity: jax.Array,  # (B, H, W)
    source_depth: jax.Array,
    target_intensity: jax.Array,
    target_depth: jax.Array,
    intr: Intrinsics,  # scalars (shared) or vectors of shape (B,)
    init_states: jax.Array,  # (B, 6)
    config: PhovoConfig,
):
    """vmapped multi-level alignment; returns batched AlignmentResult."""
    return jax.vmap(
        lambda si, sd, ti, td, it, s0: align_analytic(
            si, sd, ti, td, it, s0, config
        ),
        in_axes=(0, 0, 0, 0, _intr_axes(intr), 0),
    )(source_intensity, source_depth, target_intensity, target_depth, intr, init_states)


def make_data_parallel_aligner(mesh: Mesh, config: PhovoConfig):
    """Returns align(batch...) with the batch dimension sharded over the
    mesh 'data' axis. Any (B, H, W) batch is accepted: a B not divisible by
    the data-axis size is padded by repeating the last pair (each padded
    pair is an independent vmapped alignment, so the real pairs' results
    are bit-identical to the divisible case) and the outputs are sliced
    back to B. Outputs are replicated (6,)-per-pair states."""
    data_sharded = NamedSharding(mesh, P(DATA_AXIS, None, None))
    state_sharded = NamedSharding(mesh, P(DATA_AXIS, None))
    n_data = mesh.shape[DATA_AXIS]

    @functools.partial(
        jax.jit,
        in_shardings=(data_sharded,) * 4 + (None, state_sharded),
        static_argnames=(),
    )
    def align(si, sd, ti, td, intr, init_states):
        return align_batch(si, sd, ti, td, intr, init_states, config)

    def align_any_batch(si, sd, ti, td, intr, init_states):
        B = si.shape[0]
        pad = (-B) % n_data
        if pad:
            rep = lambda a: jnp.concatenate(
                [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0
            )
            si, sd, ti, td, init_states = (
                rep(si), rep(sd), rep(ti), rep(td), rep(init_states),
            )
        res = align(si, sd, ti, td, intr, init_states)
        if pad:
            res = jax.tree.map(lambda x: x[:B], res)
        return res

    return align_any_batch


@functools.partial(jax.jit, static_argnames=("config", "warm_start"))
def align_sequences(
    intensities: jax.Array,  # (S, T, H, W) — S independent camera streams
    depths: jax.Array,  # (S, T, H, W)
    intr: Intrinsics,  # scalars (shared rig) or (S,) vectors (per camera)
    config: PhovoConfig,
    warm_start: bool = False,
):
    """Align S independent frame sequences in one device program.

    Each sequence runs `align_sequence` (models/analytic.py); vmap lifts it
    over the stream axis. Zero-init pairs are independent across streams
    too, so the S*(T-1) pairs of the fleet advance level by level as one
    batch. Returns (AlignmentResult with leading dims (S, T-1), global
    poses (S, T-1, 4, 4)) — poses integrated on device with the O(log T)
    associative-scan prefix product (ops/se3.py integrate_trajectory),
    replacing the reference VO app's host-side running pose ∘= Rt⁻¹ loop
    (PhotoconsistencyVisualOdometry.cpp:233-234).
    """
    res = jax.vmap(
        lambda I, D, it: align_sequence(I, D, it, config, warm_start),
        in_axes=(0, 0, _intr_axes(intr)),
    )(intensities, depths, intr)
    poses = jax.vmap(se3.integrate_trajectory)(res.state)
    return res, poses


def make_multi_sequence_server(
    mesh: Mesh,
    config: PhovoConfig,
    warm_start: bool = False,
):
    """Multi-camera serving entry: S camera streams sharded over the mesh
    'data' axis, one alignment chain per stream, zero cross-device
    communication (each stream lives on one device). With S = k * n_data
    streams, every device aligns k streams.

    Each device runs align_sequences on its own streams under shard_map, so
    its solver loops stop when its own pairs have converged.

    Returns serve(intensities (S,T,H,W), depths, intr) ->
    (AlignmentResult (S, T-1, ...), global poses (S, T-1, 4, 4)).
    Intrinsics are scalars (shared rig) or (S,) vectors (per camera).
    S must be divisible by the data-axis size.
    """
    seq_sharded = NamedSharding(mesh, P(DATA_AXIS, None, None, None))
    spec = P(DATA_AXIS, None, None, None)

    def local(intensities, depths, intr):
        return align_sequences(intensities, depths, intr, config, warm_start)

    @functools.partial(jax.jit, in_shardings=(seq_sharded, seq_sharded, None))
    def serve(intensities, depths, intr):
        intr_spec = Intrinsics(
            *(P(DATA_AXIS) if jnp.ndim(v) > 0 else P() for v in intr)
        )
        return jax.shard_map(
            local, mesh=mesh, in_specs=(spec, spec, intr_spec),
            out_specs=P(DATA_AXIS), check_vma=False,
        )(intensities, depths, intr)

    return serve


@functools.partial(
    jax.jit, static_argnames=("config", "warm_start", "depth_scale"),
)
def serve_sequences_chunk(
    carry_intensity: jax.Array,  # (S, H, W) last frame of each stream's prev chunk
    carry_depth: jax.Array,  # (S, H, W)
    intensities: jax.Array,  # (S, B, H, W) new frames (uint8 or float32)
    depths: jax.Array,  # (S, B, H, W) metric float32 or raw uint16 counts
    intr: Intrinsics,  # scalars (shared rig) or (S,) vectors
    config: PhovoConfig,
    warm_start: bool = False,
    depth_scale: float | None = None,
):
    """Streaming multi-camera serving step: one chunk of B frames for each of
    S streams per dispatch (vmap of models/analytic.py align_sequence_chunk
    over the stream axis; zero-init chunks of all streams solve as one
    batch).

    Returns (AlignmentResult with leading dims (S, B), chunk-relative poses
    (S, B, 4, 4) — pair k's pose relative to the stream's chunk-start frame,
    integrated on device — new carry intensities (S, H, W) float, new carry
    depths). The host advances each stream's global pose with ONE 4x4
    multiply per chunk-pose: G_k = G_chunk_start @ poses[s, k].
    """

    def one(ci, cd, I, D, it):
        return align_sequence_chunk(
            ci, cd, I, D, it, config, warm_start, depth_scale
        )

    res, new_ci, new_cd = jax.vmap(
        one, in_axes=(0, 0, 0, 0, _intr_axes(intr))
    )(carry_intensity, carry_depth, intensities, depths, intr)
    poses = jax.vmap(se3.integrate_trajectory)(res.state)
    return res, poses, new_ci, new_cd


def make_chunked_sequence_server(
    mesh: Mesh,
    config: PhovoConfig,
    warm_start: bool = False,
    depth_scale: float | None = None,
):
    """Streaming production server: S camera streams sharded over the mesh
    'data' axis, chunked frame ingestion in storage dtype (uint8/uint16 over
    PCIe, converted on device), device-resident carry frames, device-side
    chunk-pose integration. Used by apps/phovo_serve.py. S must be divisible
    by the data-axis size.

    Each device serves its own streams under shard_map, so its solver loops
    stop when its own pairs have converged. Intrinsics are shared by all
    streams (scalars)."""
    carry_sh = NamedSharding(mesh, P(DATA_AXIS, None, None))
    chunk_sh = NamedSharding(mesh, P(DATA_AXIS, None, None, None))
    spec3 = P(DATA_AXIS, None, None)
    spec4 = P(DATA_AXIS, None, None, None)

    def local(ci, cd, I, D, intr):
        return serve_sequences_chunk(
            ci, cd, I, D, intr, config, warm_start, depth_scale
        )

    @functools.partial(
        jax.jit, in_shardings=(carry_sh, carry_sh, chunk_sh, chunk_sh, None)
    )
    def serve(carry_i, carry_d, intensities, depths, intr):
        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(spec3, spec3, spec4, spec4, P()),
            out_specs=P(DATA_AXIS),
            check_vma=False,
        )(carry_i, carry_d, intensities, depths, intr)

    return serve
