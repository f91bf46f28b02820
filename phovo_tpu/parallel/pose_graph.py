"""Distributed pose-graph optimization (net-new; SURVEY §5/§7).

The reference integrates pose chain-style with no global optimization
(PhotoconsistencyVisualOdometry.cpp:233-234), so drift is unbounded. This
module adds the standard back-end: keyframe poses optimized against
relative-pose constraints (odometry edges + loop closures) with
Gauss-Newton, constraints SHARDED over the device mesh.

Decomposition: each device holds a shard of constraints; it computes its
residuals and the dense (6M x 6M is never formed — we use per-constraint
6x6 blocks) contributions J_k^T J_k and J_k^T r_k, accumulated into block
structure with segment-sums, then psum-merged across devices. The block
system is solved with a damped dense solve on the replicated result (fine up
to hundreds of keyframes; block-sparse Schur elimination is the follow-up
for map-scale problems).

Parameterization: each pose is the same [x,y,z,yaw,pitch,roll] vector the
front-end estimates; constraint (i, j, z_ij) says pose_matrix(z_ij) should
equal T_i^{-1} T_j (measured j-in-i transform, the front-end's Rt^{-1}
convention folded in by the caller).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from phovo_tpu.ops import se3


class PoseGraph(NamedTuple):
    states: jax.Array  # (M, 6) current pose estimates (world <- keyframe)
    edges_i: jax.Array  # (K,) int32 source keyframe index
    edges_j: jax.Array  # (K,) int32 target keyframe index
    measurements: jax.Array  # (K, 6) measured state of T_i^{-1} T_j
    weights: jax.Array  # (K,) scalar information weight per edge


def edge_residual(si: jax.Array, sj: jax.Array, z: jax.Array) -> jax.Array:
    """6-vector error of one constraint: state of Z^{-1} (T_i^{-1} T_j)."""
    Ti = se3.pose_matrix(si)
    Tj = se3.pose_matrix(sj)
    Z = se3.pose_matrix(z)
    E = se3.inverse(Z) @ (se3.inverse(Ti) @ Tj)
    return se3.matrix_to_state(E)


def _edge_residual_and_jacobians(si, sj, z, w):
    """Residual + d/dsi, d/dsj via forward-mode (12 tangents, tiny)."""
    r = edge_residual(si, sj, z)
    Ji = jax.jacfwd(lambda s: edge_residual(s, sj, z))(si)
    Jj = jax.jacfwd(lambda s: edge_residual(si, s, z))(sj)
    sw = jnp.sqrt(w)
    return r * sw, Ji * sw, Jj * sw


def _accumulate_shard(states, ei, ej, z, w, M, vma_axes=()):
    """Block-structured J^T J and J^T r for one shard of edges.

    Returns H (M, M, 6, 6) block matrix and g (M, 6). Edges marked with
    i == -1 (padding) contribute zero.

    All K edges linearize in parallel (vmap over the tiny per-edge jacfwd)
    and land in H/g via four batched scatter-adds — duplicate (i, j) pairs
    accumulate correctly. The earlier form was a serial lax.scan carrying
    the dense (M, M, 6, 6) matrix through K sequential steps: with loop
    closures that is thousands of device steps each rewriting M^2 * 36
    floats; this form is O(1) device steps (same pattern as
    bundle_adjustment._accumulate_shard).
    """
    valid = ei >= 0
    iw = jnp.where(valid, ei, 0).astype(jnp.int32)
    jw = jnp.where(valid, ej, 0).astype(jnp.int32)
    r, Ji, Jj = jax.vmap(_edge_residual_and_jacobians)(
        states[iw], states[jw], z, w
    )
    zero = valid.astype(jnp.float32)
    r = r * zero[:, None]
    Ji = Ji * zero[:, None, None]
    Jj = Jj * zero[:, None, None]
    hp = jax.lax.Precision.HIGHEST
    JiTJi = jnp.einsum("kab,kac->kbc", Ji, Ji, precision=hp)
    JiTJj = jnp.einsum("kab,kac->kbc", Ji, Jj, precision=hp)
    JjTJj = jnp.einsum("kab,kac->kbc", Jj, Jj, precision=hp)
    gi = jnp.einsum("kab,ka->kb", Ji, r, precision=hp)
    gj = jnp.einsum("kab,ka->kb", Jj, r, precision=hp)
    H0 = jnp.zeros((M, M, 6, 6), jnp.float32)
    g0 = jnp.zeros((M, 6), jnp.float32)
    if vma_axes:
        # Under shard_map the edge arrays vary per device, so the scatter
        # targets must be marked device-varying too (JAX vma typing rule).
        H0 = jax.lax.pcast(H0, vma_axes, to="varying")
        g0 = jax.lax.pcast(g0, vma_axes, to="varying")
    H = H0.at[iw, iw].add(JiTJi)
    H = H.at[iw, jw].add(JiTJj)
    H = H.at[jw, iw].add(jnp.swapaxes(JiTJj, -1, -2))
    H = H.at[jw, jw].add(JjTJj)
    g = g0.at[iw].add(gi).at[jw].add(gj)
    return H, g, jnp.sum(r * r)


def optimize_pose_graph(
    graph: PoseGraph,
    mesh: Mesh | None = None,
    axis: str | None = None,
    iterations: int = 10,
    damping: float = 1e-6,
    fixed_first: bool = True,
    solver: str = "auto",
    cg_iterations: int = 100,
    cg_tol: float = 1e-8,
    bucket: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Gauss-Newton over all keyframe poses. Returns (states, final_cost).

    With a mesh, edges are padded to a multiple of the axis size and sharded;
    each device accumulates its block contributions and a psum merges them.

    bucket=True pads BOTH the pose count and the edge count to powers of
    two (floor 32 / 64) before entering jit: without it every distinct
    (M keyframes, K edges) pair compiles its own program — tens of
    seconds per novel graph size, which dominated keyframe-mode finalize
    wall-clock. Geometric growth matters for the INCREMENTAL mode: with
    multiple-of-32 pose bucketing, a growing map crossed a new bucket
    every ~32 keyframes, so at --pg-incremental cadence nearly EVERY
    re-solve compiled. Power-of-two buckets bound the lifetime compile
    count at O(log M). Padding poses have no edges (their
    normal-equation rows are damping-only, step exactly 0) and padding
    edges carry i = -1 (masked inside the accumulators), so the returned
    states are numerically identical to the unbucketed solve; the sliced
    [:M] result is returned.

    solver:
      'dense' — form the (M, M, 6, 6) block Hessian, dense 6Mx6M solve.
        Exact; DCN/ICI traffic one (M,M,6,6) allreduce per GN iteration;
        right for keyframe windows (M up to a couple hundred).
      'cg'    — matrix-free block-Jacobi-preconditioned conjugate gradient:
        H is never formed; each CG iteration applies H edge-wise (gather two
        pose blocks, two 6x6 block products, scatter-add) and psums ONE
        (M, 6) vector (~48*M bytes vs 144*M^2 for the dense Hessian). Memory
        and traffic are O(M + K); right for map-scale graphs.
      'auto'  — 'dense' for M <= 192, else 'cg'.
    """
    K = graph.edges_i.shape[0]
    M = graph.states.shape[0]
    if solver == "auto":
        solver = "dense" if M <= 192 else "cg"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    ei, ej, z, w = graph.edges_i, graph.edges_j, graph.measurements, graph.weights
    states0 = graph.states
    # host-side padding when the graph arrives as numpy (the keyframe
    # back-end builds it host-side): each eager jnp.concatenate below
    # would otherwise be its own device dispatch, and those round trips
    # would dominate the incremental re-solve latency (the jitted call then
    # uploads each padded array exactly once)
    host = not isinstance(ei, jax.Array)
    xp = np if host else jnp
    i32 = np.int32 if host else jnp.int32
    f32 = np.float32 if host else jnp.float32
    if bucket:
        Mb = max(32, 1 << (M - 1).bit_length())
        Kb = max(64, 1 << (K - 1).bit_length()) if K else 64
        states0 = xp.concatenate(
            [states0, xp.zeros((Mb - M, 6), f32)]
        )
        kpad = Kb - K
        ei = xp.concatenate([ei, -xp.ones(kpad, i32)])
        ej = xp.concatenate([ej, -xp.ones(kpad, i32)])
        z = xp.concatenate([z, xp.zeros((kpad, 6), f32)])
        w = xp.concatenate([w, xp.zeros(kpad, f32)])
        K = Kb  # the mesh padding below aligns the BUCKETED edge count
        graph = graph._replace(states=states0)
    if mesh is not None:
        n = 1
        for a in mesh.axis_names:
            n *= mesh.shape[a]
        pad = (-K) % n
        ei = xp.concatenate([ei, -xp.ones(pad, i32)])
        ej = xp.concatenate([ej, -xp.ones(pad, i32)])
        z = xp.concatenate([z, xp.zeros((pad, 6), f32)])
        w = xp.concatenate([w, xp.zeros(pad, f32)])
    states, cost = _optimize_pose_graph_jit(
        graph.states, ei, ej, z, w, jnp.float32(damping),
        mesh=mesh, iterations=iterations, fixed_first=fixed_first,
        solver=solver, cg_iterations=cg_iterations, cg_tol=float(cg_tol),
    )
    return (states[:M] if bucket else states), cost


def _cg_gn_step(
    states, ei, ej, z, w, damping, M, fixed_first, cg_iterations, cg_tol,
    vma_axes=(),
):
    """One Gauss-Newton step with a matrix-free PCG inner solve.

    Linearizes the local edge shard once, then runs block-Jacobi-
    preconditioned CG on (J^T J + damping I) step = J^T r without ever
    forming J^T J: each CG iteration gathers the two pose blocks of every
    edge, applies the cached 6x6 Jacobian blocks, scatter-adds, and (under
    shard_map) psums one (M, 6) vector. The gauge (pose 0, fixed_first)
    is handled by projection: its residual/step components are pinned to
    zero, so all CG iterates stay in the fixed-gauge subspace — the same
    solution as the dense path's row/col masking.
    """
    hp = jax.lax.Precision.HIGHEST
    psum = (
        (lambda x: jax.lax.psum(x, vma_axes)) if vma_axes else (lambda x: x)
    )

    valid = ei >= 0
    iw = jnp.where(valid, ei, 0).astype(jnp.int32)
    jw = jnp.where(valid, ej, 0).astype(jnp.int32)
    r, Ji, Jj = jax.vmap(_edge_residual_and_jacobians)(
        states[iw], states[jw], z, w
    )
    mask = valid.astype(jnp.float32)
    r = r * mask[:, None]
    Ji = Ji * mask[:, None, None]
    Jj = Jj * mask[:, None, None]
    cost = psum(jnp.sum(r * r))

    def zeros(shape):
        x = jnp.zeros(shape, jnp.float32)
        if vma_axes:
            x = jax.lax.pcast(x, vma_axes, to="varying")
        return x

    def jt_apply(u):  # J^T u: (K, 6) -> (M, 6)
        g = (
            zeros((M, 6))
            .at[iw].add(jnp.einsum("kab,ka->kb", Ji, u, precision=hp))
            .at[jw].add(jnp.einsum("kab,ka->kb", Jj, u, precision=hp))
        )
        return psum(g)

    g = jt_apply(r)
    # block-Jacobi preconditioner from the diagonal 6x6 blocks
    D = (
        zeros((M, 6, 6))
        .at[iw].add(jnp.einsum("kab,kac->kbc", Ji, Ji, precision=hp))
        .at[jw].add(jnp.einsum("kab,kac->kbc", Jj, Jj, precision=hp))
    )
    D = psum(D) + damping * jnp.eye(6, dtype=jnp.float32)
    if fixed_first:
        g = g.at[0].set(0.0)
        D = D.at[0].set(jnp.eye(6, dtype=jnp.float32))
    Pinv = jnp.linalg.inv(D)  # (M, 6, 6)

    def precond(v):
        return jnp.einsum("mab,mb->ma", Pinv, v, precision=hp)

    def hess_apply(v):  # (J^T J + damping I) v, gauge row pinned
        u = jnp.einsum("kab,kb->ka", Ji, v[iw], precision=hp) + jnp.einsum(
            "kab,kb->ka", Jj, v[jw], precision=hp
        )
        y = jt_apply(u) + damping * v
        if fixed_first:
            y = y.at[0].set(v[0])
        return y

    def vdot(a, b):
        return jnp.sum(a * b)

    gnorm = vdot(g, g)
    x0 = jnp.zeros((M, 6), jnp.float32)
    z0 = precond(g)
    carry0 = (jnp.int32(0), x0, g, z0, vdot(g, z0))

    def cond(c):
        k, _, rv, _, rz = c
        return (
            (k < cg_iterations)
            & (rz > 0.0)
            & (vdot(rv, rv) > (cg_tol * cg_tol) * gnorm)
        )

    def body(c):
        k, x, rv, p, rz = c
        Hp = hess_apply(p)
        pHp = vdot(p, Hp)
        alpha = rz / jnp.where(pHp > 0.0, pHp, 1.0)
        alpha = jnp.where(pHp > 0.0, alpha, 0.0)
        x = x + alpha * p
        rv = rv - alpha * Hp
        zv = precond(rv)
        rz_new = vdot(rv, zv)
        beta = rz_new / jnp.where(rz > 0.0, rz, 1.0)
        p = zv + beta * p
        return (k + 1, x, rv, p, rz_new)

    # seed the search direction with z0 by entering the loop with p = z0
    _, x, _, _, _ = jax.lax.while_loop(
        cond, body, (carry0[0], carry0[1], carry0[2], carry0[3], carry0[4])
    )
    step = jnp.where(jnp.all(jnp.isfinite(x)), x, jnp.zeros_like(x))
    return states - step, cost


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "iterations", "fixed_first", "solver", "cg_iterations",
        "cg_tol",
    ),
)
def _optimize_pose_graph_jit(
    states0, ei, ej, z, w, damping, *, mesh, iterations, fixed_first,
    solver="dense", cg_iterations=100, cg_tol=1e-8,
):
    """Jitted core with the graph data as ARGUMENTS: a closure-captured
    graph would be baked into the program as constants, making every
    distinct graph compile (and persistent-cache-miss) its own program."""
    M = states0.shape[0]

    if solver == "cg":
        if mesh is not None:
            axes = tuple(mesh.axis_names)
            spec = P(mesh.axis_names)

            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(), spec, spec, spec, spec, P()),
                out_specs=(P(), P()),
            )
            def cg_step(states, ei_s, ej_s, z_s, w_s, damp):
                return _cg_gn_step(
                    states, ei_s, ej_s, z_s, w_s, damp, M, fixed_first,
                    cg_iterations, cg_tol, axes,
                )

            def gn_step(states, _):
                return cg_step(states, ei, ej, z, w, damping)

        else:

            def gn_step(states, _):
                return _cg_gn_step(
                    states, ei, ej, z, w, damping, M, fixed_first,
                    cg_iterations, cg_tol,
                )

        states, costs = jax.lax.scan(gn_step, states0, None, length=iterations)
        return states, costs[-1]

    if mesh is not None:
        spec = P(mesh.axis_names)  # shard edges over ALL mesh axes flattened

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), spec, spec, spec, spec),
            out_specs=(P(), P(), P()),
        )
        def accumulate(states, ei_s, ej_s, z_s, w_s):
            H, g, c = _accumulate_shard(
                states, ei_s, ej_s, z_s, w_s, M, tuple(mesh.axis_names)
            )
            H = jax.lax.psum(H, mesh.axis_names)
            g = jax.lax.psum(g, mesh.axis_names)
            c = jax.lax.psum(c, mesh.axis_names)
            return H, g, c

        def build(states):
            return accumulate(states, ei, ej, z, w)

    else:

        def build(states):
            return _accumulate_shard(states, ei, ej, z, w, M)

    def gn_step(states, _):
        H, g, cost = build(states)
        Hd = jnp.transpose(H, (0, 2, 1, 3)).reshape(6 * M, 6 * M)
        gd = g.reshape(6 * M)
        if fixed_first:
            # gauge fix: clamp pose 0 by zeroing its rows/cols + unit diag
            mask = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (M - 1))])
            Hd = Hd * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
            gd = gd * mask
        Hd = Hd + damping * jnp.eye(6 * M, dtype=Hd.dtype)
        step = jnp.linalg.solve(Hd, gd)
        step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))
        return states - step.reshape(M, 6), cost

    states, costs = jax.lax.scan(gn_step, states0, None, length=iterations)
    return states, costs[-1]


def chain_to_graph(
    relative_states: jax.Array,  # (N-1, 6) front-end per-pair states
    loop_closures: list[tuple[int, int, jax.Array]] | None = None,
    odometry_weight: float = 1.0,
    loop_weight: float = 1.0,
) -> PoseGraph:
    """Build a pose graph from sequential odometry + optional loop edges.

    Front-end convention: align(source=k, target=k+1) estimates T with
    p_{k+1} = T p_k, and the global pose integrates pose_{k+1} =
    pose_k @ T^{-1} (PhotoconsistencyVisualOdometry.cpp:233-234). Hence the
    measured j-in-i transform for edge (k, k+1) is T^{-1}.
    """
    rel = jnp.asarray(relative_states, jnp.float32)
    N = rel.shape[0] + 1
    T_inv = se3.inverse(se3.pose_matrix(rel))  # (N-1, 4, 4)
    meas = se3.matrix_to_state(T_inv)

    # initial states: the O(log N) device-side prefix product (a host loop
    # here costs N sequential dispatches — seconds at map scale)
    Tw = se3.integrate_trajectory(rel)  # (N-1, 4, 4)
    states = jnp.concatenate(
        [jnp.zeros((1, 6), jnp.float32), se3.matrix_to_state(Tw)]
    )

    ei = list(range(N - 1))
    ej = list(range(1, N))
    zs = [meas[k] for k in range(N - 1)]
    ws = [odometry_weight] * (N - 1)
    for (i, j, z) in loop_closures or []:
        ei.append(i)
        ej.append(j)
        zs.append(jnp.asarray(z, jnp.float32))
        ws.append(loop_weight)
    return PoseGraph(
        states=states,
        edges_i=jnp.asarray(ei, jnp.int32),
        edges_j=jnp.asarray(ej, jnp.int32),
        measurements=jnp.stack(zs),
        weights=jnp.asarray(ws, jnp.float32),
    )
