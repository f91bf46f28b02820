"""Sparse bundle adjustment with Schur-complement elimination, sharded
over the device mesh (net-new; SURVEY §5/§7 "distributed pose-graph/BA
backend whose JtJ/Jtr and Schur-complement reductions run over collectives").

The reference has no mapping back-end at all (its global pose is a running
product, PhotoconsistencyVisualOdometry.cpp:233-234); parallel/pose_graph.py
adds pose-only graph optimization. This module adds the full structure-aware
back-end: M keyframe poses and P landmark points refined jointly against
pixel reprojection observations.

Math (classic reduced camera system): with per-observation residual
r_k(s_i, X_j) and Jacobians A_k = dr/ds_i (2x6), B_k = dr/dX_j (2x3), the
Gauss-Newton system is

    [ U   W ] [dx_pose ]   [ v ]        U: block-diag (M, 6, 6)
    [ W^T V ] [dx_point] = [ w ]        V: block-diag (P, 3, 3)

Landmarks are eliminated by the Schur complement

    S = U - W V^{-1} W^T          (6M x 6M reduced camera system)
    S dx_pose = v - W V^{-1} w
    dx_point_j = V_j^{-1} (w_j - sum_i W_{ij}^T dx_pose_i)

Decomposition: observations are padded and sharded over the flattened
mesh; every device scatter-accumulates its shard's {U, V, W, v, w, cost}
blocks locally, ONE psum per GN iteration merges them (the only collective),
and the reduced 6M x 6M solve + landmark back-substitution run replicated —
M is a keyframe-window count (tens), so the solve is trivial next to the
O(K) accumulation. W is kept dense (M, P, 6, 3): for window BA
(M<=64, P<=few thousand) that is a few MB of dense layout and makes
the Schur contraction three dense einsums instead of ragged per-landmark
gathers.

Conventions match the rest of the framework: pose state s_i is the 6-vector
[x y z yaw pitch roll] with T_i = pose_matrix(s_i) the world-from-keyframe
transform (parallel/pose_graph.py), landmarks live in world coordinates, and
a landmark is observed in keyframe i at pixel (u, v) via the reference's
pinhole projection (CPhotoconsistencyOdometry.h:87-133)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics

# schur='auto' memory guard, shared with parallel/photometric_ba.py: the
# dense-Schur path materializes W (M, P, 6, 3) plus the WVinv intermediate
# (M, P, 6, 3) — 2 * M * P * 18 f32 values. Dense wins on TIME wherever it
# fits (tools/ba_scale_bench.py crossover table), so the
# budget is purely a memory cap.
DENSE_W_BUDGET_BYTES = 256e6


def dense_w_fits(n_poses: int, n_points: int) -> bool:
    """True when the dense-Schur W intermediates for an (M poses, P points)
    problem fit DENSE_W_BUDGET_BYTES."""
    return 2 * n_poses * n_points * 18 * 4 <= DENSE_W_BUDGET_BYTES


class BAProblem(NamedTuple):
    """A fixed-size RGB-D bundle-adjustment problem (pytree; jit-stable
    shapes).

    Observations are RGB-D: a pixel (u, v) plus the measured camera-frame
    depth z (this is a depth-camera framework — the reference reads 16-bit
    depth PNGs for every frame, CImageReader.h:43-83). The depth residual is
    essential: pixel-only BA with a single anchored pose leaves global scale
    as a gauge freedom (cond(H) ~ 1e12), which no solver arithmetic can fix;
    the depth rows pin scale and condition the system. Set z_weights to 0 for
    pixel-only observations.

    Padding: observations with pose index -1 are ignored (contribute exact
    zeros). Landmarks never observed by any real observation are frozen by
    the V damping floor."""

    pose_states: jax.Array  # (M, 6) keyframe states (world <- keyframe)
    points: jax.Array  # (P, 3) world landmarks
    obs_pose: jax.Array  # (K,) int32 keyframe index per observation (-1 pad)
    obs_point: jax.Array  # (K,) int32 landmark index per observation
    obs_uv: jax.Array  # (K, 2) measured pixel (u, v)
    obs_z: jax.Array  # (K,) measured camera-frame depth (meters)
    weights: jax.Array  # (K,) pixel information weight per observation
    z_weights: jax.Array  # (K,) depth information weight (0 = pixel-only)


def project_point(state: jax.Array, point: jax.Array, intr: Intrinsics):
    """Project one world point into the keyframe with pose `state`.

    Returns ((u, v), depth-in-camera). p_cam = T^{-1} X (T world-from-kf),
    pinhole projection with the reference's K (u = fx x/z + cx)."""
    T = se3.pose_matrix(state)
    R = T[:3, :3]
    t = T[:3, 3]
    p = R.T @ (point - t)
    z = p[2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    u = intr.fx * p[0] / safe_z + intr.cx
    v = intr.fy * p[1] / safe_z + intr.cy
    return jnp.stack([u, v]), z


def _obs_residual(state, point, uvz, intr):
    pred, z = project_point(state, point, intr)
    return jnp.concatenate([pred - uvz[:2], (z - uvz[2])[None]])


def _linearize_obs(states, points, obs_pose, obs_point, obs_uv, obs_z,
                   weights, z_weights, intr):
    """Per-observation residuals and Jacobians, vmapped + jacfwd (9 tangents
    per observation — tiny closed-chain work the VPU eats in registers).

    Returns r (K, 3), A (K, 3, 6), B (K, 3, 3): rows 0-1 are the pixel
    residual scaled by sqrt(w), row 2 the depth residual scaled by
    sqrt(w_z); all rows zeroed on padding observations."""
    valid = obs_pose >= 0
    iw = jnp.where(valid, obs_pose, 0)
    jw = jnp.where(valid, obs_point, 0)
    s = states[iw]
    X = points[jw]
    uvz = jnp.concatenate([obs_uv, obs_z[:, None]], axis=1)

    def one(s_k, X_k, uvz_k):
        r = _obs_residual(s_k, X_k, uvz_k, intr)
        A = jax.jacfwd(lambda q: _obs_residual(q, X_k, uvz_k, intr))(s_k)
        B = jax.jacfwd(lambda q: _obs_residual(s_k, q, uvz_k, intr))(X_k)
        return r, A, B

    r, A, B = jax.vmap(one)(s, X, uvz)
    vf = valid.astype(r.dtype)
    sw = jnp.stack(
        [jnp.sqrt(weights) * vf, jnp.sqrt(weights) * vf,
         jnp.sqrt(z_weights) * vf],
        axis=1,
    )
    r = r * sw
    A = A * sw[:, :, None]
    B = B * sw[:, :, None]
    return r, A, B, iw, jw


def _accumulate_shard(states, points, obs_pose, obs_point, obs_uv, obs_z,
                      weights, z_weights, intr, M, Pn, vma_axes=(),
                      robust_delta=None, sparse=False):
    """One shard's block contributions {U, V, W, v, w, cost}.

    sparse=True returns the per-observation coupling blocks AtB (K, 6, 3)
    in place of the dense W scatter (the _schur_step_sparse contract)."""
    r, A, B, iw, jw = _linearize_obs(
        states, points, obs_pose, obs_point, obs_uv, obs_z, weights,
        z_weights, intr
    )
    if robust_delta is not None:
        # Huber IRLS on the whitened per-observation residual norm: caps any
        # single observation's influence (outlier tracks / bad depth)
        n = jnp.linalg.norm(r, axis=1)
        sw = jnp.sqrt(jnp.minimum(1.0, robust_delta / jnp.maximum(n, 1e-12)))
        r = r * sw[:, None]
        A = A * sw[:, None, None]
        B = B * sw[:, None, None]
    hp = jax.lax.Precision.HIGHEST
    AtA = jnp.einsum("kai,kaj->kij", A, A, precision=hp)  # (K, 6, 6)
    BtB = jnp.einsum("kai,kaj->kij", B, B, precision=hp)  # (K, 3, 3)
    AtB = jnp.einsum("kai,kaj->kij", A, B, precision=hp)  # (K, 6, 3)
    Atr = jnp.einsum("kai,ka->ki", A, r, precision=hp)  # (K, 6)
    Btr = jnp.einsum("kai,ka->ki", B, r, precision=hp)  # (K, 3)

    U0 = jnp.zeros((M, 6, 6), jnp.float32)
    V0 = jnp.zeros((Pn, 3, 3), jnp.float32)
    v0 = jnp.zeros((M, 6), jnp.float32)
    w0 = jnp.zeros((Pn, 3), jnp.float32)
    seeds = [U0, V0, v0, w0]
    if not sparse:
        seeds.append(jnp.zeros((M, Pn, 6, 3), jnp.float32))
    if vma_axes:
        # under shard_map the scattered values vary per device; the scatter
        # operands must carry the same vma type (JAX typing rule)
        seeds = [jax.lax.pcast(a, vma_axes, to="varying") for a in seeds]
    U0, V0, v0, w0 = seeds[:4]
    U = U0.at[iw].add(AtA)
    V = V0.at[jw].add(BtB)
    vv = v0.at[iw].add(Atr)
    ww = w0.at[jw].add(Btr)
    cost = jnp.sum(r * r)
    if sparse:
        return U, V, AtB, vv, ww, cost
    Wb = seeds[4].at[iw, jw].add(AtB)
    return U, V, Wb, vv, ww, cost


def _damped_vinv(V, damping):
    """Inverse of the damped landmark blocks — MULTIPLICATIVE (Levenberg-
    Marquardt) damping: the blocks mix meter/radian/pixel^2 scales, so an
    absolute ridge is either negligible or crushing depending on units;
    scaling the diagonal is unit-free. Unobserved landmarks get the identity
    floor, making their update exactly zero; the tiny absolute floor guards
    exactly-zero diagonal entries (e.g. a point observed only on the optical
    axis with z_weights=0) whose whole row/col survives multiplicative
    damping — without it Vd is singular, inv() returns inf, and the finite
    guard discards the entire update."""
    Vdiag = V * jnp.eye(3, dtype=V.dtype)
    Vd = V + damping * Vdiag + (
        (jnp.abs(V).sum((-1, -2), keepdims=True) == 0).astype(V.dtype)
        + 1e-10
    ) * jnp.eye(3, dtype=V.dtype)
    return jnp.linalg.inv(Vd)  # (P, 3, 3)


def _reduced_pose_solve(U, S, rhs, damping, fixed_first):
    """Solve the Schur-reduced camera system S dx = rhs (S already has U on
    its block diagonal)."""
    M = U.shape[0]
    Sd = jnp.transpose(S, (0, 2, 1, 3)).reshape(6 * M, 6 * M)
    gd = rhs.reshape(6 * M)
    if fixed_first:
        mask = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (M - 1))])
        Sd = Sd * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        gd = gd * mask
    # multiplicative LM ridge on the PRE-elimination camera diagonal
    # (damping * diag(U), matching the dense-system ridge the elimination
    # must stay exact against) + tiny absolute floor for zero diagonals
    U_diag = jnp.diagonal(U, axis1=-2, axis2=-1).reshape(6 * M)  # (i*6+a)
    Sd = Sd + jnp.diag(damping * U_diag + 1e-10)
    # Jacobi preconditioning: the reduced camera system mixes meter and
    # radian columns against pixel residuals and reaches cond ~1e12 raw,
    # which an f32 solve cannot handle; symmetric diagonal rescaling brings
    # it into f32 range (same trick as Ceres's JACOBI preconditioner).
    d = jnp.sqrt(jnp.clip(jnp.diagonal(Sd), 1e-12, None))
    Ss = Sd / d[:, None] / d[None, :]
    return (jnp.linalg.solve(Ss, gd / d) / d).reshape(M, 6)


def _schur_step(states, points, blocks, damping, fixed_first):
    """One GN update from merged blocks: Schur-reduce, solve, back-substitute."""
    U, V, Wb, vv, ww, cost = blocks
    M = U.shape[0]
    hp = jax.lax.Precision.HIGHEST
    Vinv = _damped_vinv(V, damping)

    WVinv = jnp.einsum("ipab,pbc->ipac", Wb, Vinv, precision=hp)  # (M, P, 6, 3)
    S_off = jnp.einsum("ipac,jpdc->ijad", WVinv, Wb, precision=hp)  # (M, M, 6, 6)
    S = -S_off
    S = S.at[jnp.arange(M), jnp.arange(M)].add(U)
    rhs = vv - jnp.einsum("ipac,pc->ia", WVinv, ww, precision=hp)  # (M, 6)
    dx_pose = _reduced_pose_solve(U, S, rhs, damping, fixed_first)

    # landmark back-substitution
    corr = jnp.einsum("ipab,ia->pb", Wb, dx_pose, precision=hp)  # (P, 3)
    dx_point = jnp.einsum("pab,pb->pa", Vinv, ww - corr, precision=hp)

    finite = jnp.all(jnp.isfinite(dx_pose)) & jnp.all(jnp.isfinite(dx_point))
    dx_pose = jnp.where(finite, dx_pose, 0.0)
    dx_point = jnp.where(finite, dx_point, 0.0)
    return states - dx_pose, points - dx_point, cost


def build_schur_pairs(obs_pose, obs_point, pad_multiple: int = 1024):
    """Host-side sparse Schur fill pattern: int32 (pair_a, pair_b) arrays
    enumerating every ORDERED pair of real observations that share a
    landmark — exactly the (i_a, i_b) camera-block pairs the off-diagonal
    Schur term sum_j W_{i_a j} Vinv_j W_{i_b j}^T touches. Size is
    sum_j n_j^2 (n_j = observations of landmark j), i.e. O(K * mean track
    length) — independent of the M*P dense-W footprint. Padded with -1 to a
    multiple of pad_multiple so repeated window shapes reuse one compiled
    program."""
    import numpy as np

    op = np.asarray(obs_pose)
    ol = np.asarray(obs_point)
    real = np.nonzero(op >= 0)[0]
    order = real[np.argsort(ol[real], kind="stable")]
    pa, pb = [], []
    start = 0
    sorted_l = ol[order]
    while start < len(order):
        stop = start
        while stop < len(order) and sorted_l[stop] == sorted_l[start]:
            stop += 1
        grp = order[start:stop]
        A, B = np.meshgrid(grp, grp, indexing="ij")
        pa.append(A.reshape(-1))
        pb.append(B.reshape(-1))
        start = stop
    if pa:
        pa = np.concatenate(pa).astype(np.int32)
        pb = np.concatenate(pb).astype(np.int32)
    else:
        pa = np.zeros(0, np.int32)
        pb = np.zeros(0, np.int32)
    pad = (-len(pa)) % pad_multiple if len(pa) else pad_multiple
    pa = np.concatenate([pa, -np.ones(pad, np.int32)])
    pb = np.concatenate([pb, -np.ones(pad, np.int32)])
    return jnp.asarray(pa), jnp.asarray(pb)


def _schur_step_sparse(states, points, blocks, damping, fixed_first,
                       *, pair_a, pair_b):
    """Sparse-W GN update: the (M, P, 6, 3) dense W is never materialized
    (VERDICT r1 weak #6 — the scaling wall of the map-scale story). blocks
    carries the per-observation coupling blocks AtB (K, 6, 3) with their
    (iw, jw) indices plus the precomputed same-landmark pair list; all W
    contractions become segment scatter-adds:

      S_off[i_a, i_b] += AtB_a Vinv_{j} AtB_b^T   over the pair list
      rhs[i]          -= AtB_k Vinv_{j_k} w_{j_k}  per observation
      corr[j]         += AtB_k^T dx_pose[i_k]      per observation

    Memory: O(K + sum_j n_j^2) pair blocks instead of O(M*P) — a
    50k-observation / 10k-landmark window fits on chip where dense W
    (46 MB + the (M, P, 6, 3) WVinv intermediate) does not scale.

    pair_a/pair_b (closure-bound, from build_schur_pairs) index the pair
    list; cost stays last in `blocks` (the _lm_iterate contract)."""
    U, V, AtB, iw, jw, vv, ww, cost = blocks
    M = U.shape[0]
    hp = jax.lax.Precision.HIGHEST
    Vinv = _damped_vinv(V, damping)

    # per-observation W V^{-1} block (K, 6, 3)
    WV = jnp.einsum("kab,kbc->kac", AtB, Vinv[jw], precision=hp)

    # off-diagonal Schur fill over the same-landmark pair list
    maskp = (pair_a >= 0).astype(jnp.float32)
    pa = jnp.where(pair_a >= 0, pair_a, 0)
    pb = jnp.where(pair_b >= 0, pair_b, 0)
    Sblk = jnp.einsum(
        "kac,kdc->kad", WV[pa], AtB[pb], precision=hp
    ) * maskp[:, None, None]  # (K2, 6, 6)
    S = jnp.zeros((M, M, 6, 6), jnp.float32).at[iw[pa], iw[pb]].add(-Sblk)
    S = S.at[jnp.arange(M), jnp.arange(M)].add(U)

    rhs_corr = jnp.zeros((M, 6), jnp.float32).at[iw].add(
        jnp.einsum("kac,kc->ka", WV, ww[jw], precision=hp)
    )
    rhs = vv - rhs_corr
    dx_pose = _reduced_pose_solve(U, S, rhs, damping, fixed_first)

    # landmark back-substitution: corr_j = sum_k AtB_k^T dx_pose[i_k]
    corr = jnp.zeros_like(ww).at[jw].add(
        jnp.einsum("kab,ka->kb", AtB, dx_pose[iw], precision=hp)
    )
    dx_point = jnp.einsum("pab,pb->pa", Vinv, ww - corr, precision=hp)

    finite = jnp.all(jnp.isfinite(dx_pose)) & jnp.all(jnp.isfinite(dx_point))
    dx_pose = jnp.where(finite, dx_pose, 0.0)
    dx_point = jnp.where(finite, dx_point, 0.0)
    return states - dx_pose, points - dx_point, cost


def _lm_iterate(build, states0, points0, iterations, damping, fixed_first,
                step_fn=_schur_step):
    """Monotone Levenberg-Marquardt driver over _schur_step.

    Plain Gauss-Newton on a near-degenerate window (e.g. co-planar landmarks
    with short baselines — common in keyframe VO) can take an unbounded step
    along a near-null direction and corrupt a perfectly good initialization.
    Each scan iteration steps FROM the best accepted iterate using its
    CACHED linearization, then evaluates (and linearizes) the trial point
    with one build() call: accepted trials become the new best (ridge `lam`
    shrinks, floored at `damping`); rejected trials only grow `lam` 8x and
    the cached blocks are reused — a rejection never re-linearizes. Returns
    (best_states, best_points, best_cost) — cost is guaranteed
    non-increasing. Total cost: iterations + 1 build() calls."""

    blocks0 = build(states0, points0)

    def lm_step(carry, _):
        best_s, best_p, best_blocks, best_cost, lam = carry
        st_s, st_p, _ = step_fn(best_s, best_p, best_blocks, lam,
                                fixed_first)
        blocks = build(st_s, st_p)
        cost = blocks[-1]
        # exact comparison (equal-cost steps still accepted, so plateaus
        # keep moving): a relative tolerance here would let best_s drift to
        # a strictly-worse iterate than the reported best_cost
        ok = cost <= best_cost
        best_s2 = jnp.where(ok, st_s, best_s)
        best_p2 = jnp.where(ok, st_p, best_p)
        blocks2 = jax.tree.map(
            lambda a, b: jnp.where(ok, a, b), blocks, best_blocks
        )
        best_cost2 = jnp.minimum(cost, best_cost)
        lam2 = jnp.where(
            ok,
            jnp.maximum(lam * 0.5, damping),
            jnp.minimum(lam * 8.0, 1e3),
        )
        return (best_s2, best_p2, blocks2, best_cost2, lam2), cost

    init = (states0, points0, blocks0, blocks0[-1], jnp.float32(damping))
    (bs, bp, _, bc, _), _ = jax.lax.scan(lm_step, init, None,
                                         length=iterations)
    return bs, bp, bc


def optimize_bundle(
    problem: BAProblem,
    intr: Intrinsics,
    mesh: Mesh | None = None,
    iterations: int = 10,
    damping: float = 1e-6,
    fixed_first: bool = True,
    robust_delta: float | None = None,
    schur: str = "dense",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Gauss-Newton bundle adjustment. Returns (pose_states, points, cost).

    robust_delta enables a Huber IRLS weight on each observation's whitened
    residual norm (units: pixel-equivalents; e.g. 3.0 caps influence beyond
    ~3 px of reprojection error).

    schur='dense' materializes W as (M, P, 6, 3) — fastest for small
    windows (M<=64, P<=few k, the contraction is three dense einsums).
    schur='sparse' never materializes W: the Schur fill runs over the
    same-landmark observation-pair list (build_schur_pairs) with segment
    scatter-adds, memory O(K * mean-track-length) instead of O(M*P) — the
    map-scale path (50k observations / 10k landmarks).
    schur='auto' picks dense while the W + WVinv intermediates fit a
    256 MB budget and sparse beyond (measured crossover: dense wins on
    time wherever it fits — tools/ba_scale_bench.py —
    so the budget is purely a memory guard).

    With a mesh, observations are padded to a multiple of the flattened mesh
    size and sharded; each device accumulates its {U, V, W|AtB, v, w} blocks
    and one psum per iteration merges them. The Schur-reduced camera system
    is solved replicated (6M x 6M; M = keyframe-window size)."""
    if schur not in ("dense", "sparse", "auto"):
        raise ValueError(
            f"schur={schur!r}; expected 'dense', 'sparse', or 'auto'"
        )
    if schur == "auto":
        M = int(problem.pose_states.shape[0])
        P = int(problem.points.shape[0])
        schur = "dense" if dense_w_fits(M, P) else "sparse"
    K = problem.obs_pose.shape[0]
    if mesh is not None:
        n = 1
        for a in mesh.axis_names:
            n *= mesh.shape[a]
        pad = (-K) % n
        problem = problem._replace(
            obs_pose=jnp.concatenate(
                [problem.obs_pose, -jnp.ones(pad, jnp.int32)]
            ),
            obs_point=jnp.concatenate(
                [problem.obs_point, jnp.zeros(pad, jnp.int32)]
            ),
            obs_uv=jnp.concatenate(
                [problem.obs_uv, jnp.zeros((pad, 2), jnp.float32)]
            ),
            obs_z=jnp.concatenate([problem.obs_z, jnp.zeros(pad, jnp.float32)]),
            weights=jnp.concatenate(
                [problem.weights, jnp.zeros(pad, jnp.float32)]
            ),
            z_weights=jnp.concatenate(
                [problem.z_weights, jnp.zeros(pad, jnp.float32)]
            ),
        )
    if schur == "sparse":
        pair_a, pair_b = build_schur_pairs(problem.obs_pose, problem.obs_point)
        return _optimize_bundle_jit(
            problem, intr, jnp.float32(damping), pair_a, pair_b,
            mesh=mesh, iterations=iterations, fixed_first=fixed_first,
            robust_delta=robust_delta,
        )
    return _optimize_bundle_jit(
        problem, intr, jnp.float32(damping), None, None,
        mesh=mesh, iterations=iterations, fixed_first=fixed_first,
        robust_delta=robust_delta,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "iterations", "fixed_first", "robust_delta"),
)
def _optimize_bundle_jit(
    problem, intr, damping, pair_a, pair_b,
    *, mesh, iterations, fixed_first, robust_delta
):
    """Jitted core with the problem as an ARGUMENT: closure-captured problem
    data would be baked into the program as constants, so every distinct
    problem would compile (and persistent-cache-miss) its own program.

    pair_a/pair_b non-None selects the sparse-W Schur path."""
    M = problem.pose_states.shape[0]
    Pn = problem.points.shape[0]
    sparse = pair_a is not None

    if mesh is not None:
        spec = P(mesh.axis_names)
        # sparse: AtB keeps its per-observation shard (out_spec `spec`
        # stitches the global (K, 6, 3) back in order); everything else is
        # psum-merged as before
        out_specs = (
            (P(), P(), spec, P(), P(), P()) if sparse else (P(),) * 6
        )

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P(), spec, spec, spec, spec, spec, spec),
            out_specs=out_specs,
        )
        def accumulate(
            states, points, intr_r, op_s, ol_s, uv_s, oz_s, w_s, zw_s
        ):
            blocks = _accumulate_shard(
                states, points, op_s, ol_s, uv_s, oz_s, w_s, zw_s, intr_r,
                M, Pn, tuple(mesh.axis_names), robust_delta, sparse=sparse,
            )
            return tuple(
                b if (sparse and k == 2)
                else jax.lax.psum(b, mesh.axis_names)
                for k, b in enumerate(blocks)
            )

        def raw_build(states, points):
            return accumulate(
                states, points, intr, problem.obs_pose, problem.obs_point,
                problem.obs_uv, problem.obs_z, problem.weights,
                problem.z_weights,
            )

    else:

        def raw_build(states, points):
            return _accumulate_shard(
                states, points, problem.obs_pose, problem.obs_point,
                problem.obs_uv, problem.obs_z, problem.weights,
                problem.z_weights, intr, M, Pn, robust_delta=robust_delta,
                sparse=sparse,
            )

    if sparse:
        valid = problem.obs_pose >= 0
        iw = jnp.where(valid, problem.obs_pose, 0)
        jw = jnp.where(valid, problem.obs_point, 0)

        def build(states, points):
            U, V, AtB, vv, ww, cost = raw_build(states, points)
            return (U, V, AtB, iw, jw, vv, ww, cost)

        step_fn = functools.partial(
            _schur_step_sparse, pair_a=pair_a, pair_b=pair_b
        )
    else:
        build = raw_build
        step_fn = _schur_step

    return _lm_iterate(
        build, problem.pose_states, problem.points, iterations, damping,
        fixed_first, step_fn=step_fn,
    )


def dense_gn_step(problem: BAProblem, intr: Intrinsics,
                  damping: float = 1e-6, fixed_first: bool = True):
    """One GN update solving the FULL (6M + 3P) system directly — the
    correctness oracle for the Schur elimination (tests only). The solve runs
    in numpy float64: the raw normal equations reach cond ~1e12 (mixed
    pixel/meter/radian units), so an f32 oracle would be noisier than the
    preconditioned Schur path it is meant to check."""
    import numpy as np

    M = problem.pose_states.shape[0]
    Pn = problem.points.shape[0]
    r, A, B, iw, jw = _linearize_obs(
        problem.pose_states, problem.points, problem.obs_pose,
        problem.obs_point, problem.obs_uv, problem.obs_z, problem.weights,
        problem.z_weights, intr,
    )
    r, A, B, iw, jw = (np.asarray(x, np.float64) for x in (r, A, B, iw, jw))
    iw = iw.astype(np.int64)
    jw = jw.astype(np.int64)
    K = r.shape[0]
    D = 6 * M + 3 * Pn
    J = np.zeros((K, r.shape[1], D), np.float64)
    for k in range(K):
        J[k, :, 6 * iw[k] : 6 * iw[k] + 6] = A[k]
        J[k, :, 6 * M + 3 * jw[k] : 6 * M + 3 * jw[k] + 3] = B[k]
    Jf = J.reshape(K * r.shape[1], D)
    rf = r.reshape(K * r.shape[1])
    H = Jf.T @ Jf
    g = Jf.T @ rf
    if fixed_first:
        mask = np.concatenate([np.zeros(6), np.ones(D - 6)])
        H = H * mask[:, None] * mask[None, :] + np.diag(1.0 - mask)
        g = g * mask
    # multiplicative LM ridge + absolute floor, mirroring _schur_step
    H = H + np.diag(damping * np.diag(H) + 1e-10)
    # identity floor on unobserved landmark blocks, as in the Schur path
    for p in range(Pn):
        blk = slice(6 * M + 3 * p, 6 * M + 3 * p + 3)
        if np.abs(H[blk, blk]).sum() < 1e-8:
            H[blk, blk] += np.eye(3)
    dx = np.linalg.solve(H, g)
    states = problem.pose_states - jnp.asarray(
        dx[: 6 * M].reshape(M, 6), jnp.float32
    )
    points = problem.points - jnp.asarray(
        dx[6 * M :].reshape(Pn, 3), jnp.float32
    )
    return states, points, jnp.sum(r * r)


def make_synthetic_ba(
    n_poses: int = 6,
    n_points: int = 64,
    intr: Intrinsics | None = None,
    obs_per_pose: int | None = None,
    pixel_noise: float = 0.0,
    depth_noise: float = 0.0,
    state_noise: float = 0.02,
    point_noise: float = 0.02,
    seed: int = 0,
):
    """Ground-truthed synthetic RGB-D BA problem: poses on a short arc looking
    at a landmark cloud. By default every pose observes every landmark (dense
    visibility keeps shapes static; real front-ends pad); obs_per_pose=N
    instead samples N distinct landmarks per pose (sparse visibility). Depth observations carry the
    standard (fx/z)^2 information weight (a depth error of dz meters moves the
    reprojection by ~fx*dz/z pixels, so this expresses depth in
    pixel-equivalent units). Returns (problem, gt_states, gt_points)."""
    import numpy as np

    if intr is None:
        from phovo_tpu.ops.camera import TUM_DEFAULT

        intr = TUM_DEFAULT
    rng = np.random.default_rng(seed)
    gt_states = np.zeros((n_poses, 6), np.float32)
    gt_states[:, 0] = np.linspace(0.0, 0.4, n_poses)  # translate in x
    gt_states[:, 3] = np.linspace(0.0, 0.05, n_poses)  # slight yaw
    pts = np.stack(
        [
            rng.uniform(-1.0, 1.0, n_points),
            rng.uniform(-0.8, 0.8, n_points),
            rng.uniform(2.0, 4.0, n_points),
        ],
        axis=1,
    ).astype(np.float32)

    obs_pose, obs_point, obs_uv, obs_z, z_w = [], [], [], [], []
    proj = jax.vmap(
        lambda s, X: project_point(s, X, intr), in_axes=(None, 0)
    )
    for i in range(n_poses):
        uv, z = proj(jnp.asarray(gt_states[i]), jnp.asarray(pts))
        uv = np.asarray(uv) + rng.normal(
            0.0, pixel_noise, (n_points, 2)
        ).astype(np.float32)
        z = np.asarray(z) + rng.normal(0.0, depth_noise, n_points).astype(
            np.float32
        )
        sel = (
            np.arange(n_points)
            if obs_per_pose is None
            else rng.choice(n_points, obs_per_pose, replace=False)
        )
        for j in sel:
            obs_pose.append(i)
            obs_point.append(j)
            obs_uv.append(uv[j])
            obs_z.append(z[j])
            z_w.append((intr.fx / max(float(z[j]), 0.1)) ** 2)

    init_states = gt_states + rng.normal(
        0.0, state_noise, gt_states.shape
    ).astype(np.float32)
    init_states[0] = gt_states[0]  # gauge anchor
    init_points = pts + rng.normal(0.0, point_noise, pts.shape).astype(
        np.float32
    )
    problem = BAProblem(
        pose_states=jnp.asarray(init_states),
        points=jnp.asarray(init_points),
        obs_pose=jnp.asarray(obs_pose, jnp.int32),
        obs_point=jnp.asarray(obs_point, jnp.int32),
        obs_uv=jnp.asarray(np.stack(obs_uv)),
        obs_z=jnp.asarray(obs_z, jnp.float32),
        weights=jnp.ones(len(obs_pose), jnp.float32),
        z_weights=jnp.asarray(z_w, jnp.float32),
    )
    return problem, jnp.asarray(gt_states), jnp.asarray(pts)
