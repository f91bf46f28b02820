"""Mesh-sharded paths on the 8-virtual-device CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phovo_tpu.models.analytic import align_analytic
from phovo_tpu.ops import se3
from phovo_tpu.ops.residuals import normal_equations, photometric_residual_jacobian
from phovo_tpu.parallel.batch import make_data_parallel_aligner
from phovo_tpu.parallel.mesh import make_mesh
from phovo_tpu.parallel.pose_graph import (
    PoseGraph,
    chain_to_graph,
    edge_residual,
    optimize_pose_graph,
)
from phovo_tpu.parallel.sharded_ne import (
    make_pixel_sharded_aligner,
    sharded_normal_equations,
)
from phovo_tpu.utils.config import PhovoConfig

CFG = PhovoConfig(
    num_levels=2,
    blur_filter_sizes=(0, 0),
    gradient_scales=(0.0625, 0.0625),
    max_iterations=(8, 10),
    lambda_steps=(1.0, 1.0),
    min_gradient_norms=(1e-10, 1e-10),
    sampling="bilinear",
)


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_data_parallel_batch_matches_serial(intr, small_pair):
    I0, D0, I1, D1, gt = small_pair
    mesh = make_mesh(4, pixel_parallel=1)
    aligner = make_data_parallel_aligner(mesh, CFG)
    B = 4
    batch = lambda x: jnp.broadcast_to(jnp.asarray(x), (B,) + x.shape)
    res = aligner(batch(I0), batch(D0), batch(I1), batch(D1), intr, jnp.zeros((B, 6)))
    serial = align_analytic(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6), CFG,
    )
    for b in range(B):
        np.testing.assert_allclose(
            np.asarray(res.state[b]), np.asarray(serial.state), atol=1e-5
        )
    # and the batch recovered the pose
    np.testing.assert_allclose(np.asarray(res.state[0]), gt, atol=5e-3)


def test_sharded_normal_equations_match_unsharded(intr, small_pair):
    I0, D0, I1, _, _ = small_pair
    gx = jnp.asarray(np.gradient(I1, axis=1).astype(np.float32))
    gy = jnp.asarray(np.gradient(I1, axis=0).astype(np.float32))
    state = jnp.array([0.01, -0.01, 0.005, 0.004, -0.003, 0.002], jnp.float32)
    mesh = make_mesh(8, pixel_parallel=8)
    ne_sharded = sharded_normal_equations(
        mesh, jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), gx, gy,
        state, intr, 0.3, 5.0, "bilinear",
    )
    r, J, valid = photometric_residual_jacobian(
        I0, D0, I1, gx, gy, state, intr,
        min_depth=0.3, max_depth=5.0, sampling="bilinear", gradient_at="warped",
    )
    ne = normal_equations(r, J, valid)
    scale = np.abs(np.asarray(ne.JtJ)).max()
    np.testing.assert_allclose(
        np.asarray(ne_sharded.JtJ), np.asarray(ne.JtJ), atol=1e-5 * scale
    )
    np.testing.assert_allclose(
        np.asarray(ne_sharded.Jtr), np.asarray(ne.Jtr),
        atol=1e-5 * max(1.0, np.abs(np.asarray(ne.Jtr)).max()),
    )
    np.testing.assert_allclose(
        float(ne_sharded.num_valid), float(ne.num_valid), atol=0.5
    )


def test_pixel_sharded_aligner_recovers_pose(intr, small_pair):
    I0, D0, I1, D1, gt = small_pair
    mesh = make_mesh(8, pixel_parallel=8)
    align = make_pixel_sharded_aligner(mesh, CFG)
    res = align(
        jnp.asarray(I0), jnp.asarray(D0), jnp.asarray(I1), jnp.asarray(D1),
        intr, jnp.zeros(6),
    )
    np.testing.assert_allclose(np.asarray(res.state), gt, atol=5e-3)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------


def _noisy_chain(n=8, seed=0):
    rng = np.random.default_rng(seed)
    true_rel = np.stack(
        [
            np.array([0.1, 0.02, -0.01, 0.05, -0.02, 0.01])
            + 0.01 * rng.standard_normal(6)
            for _ in range(n - 1)
        ]
    ).astype(np.float32)
    return true_rel


def test_edge_residual_zero_for_consistent_poses():
    s_i = jnp.array([0.1, 0.2, 0.3, 0.1, -0.2, 0.15], jnp.float32)
    rel = jnp.array([0.05, -0.02, 0.1, 0.02, 0.01, -0.03], jnp.float32)
    T_j = se3.pose_matrix(s_i) @ se3.pose_matrix(rel)
    s_j = se3.matrix_to_state(T_j)
    r = edge_residual(s_i, s_j, rel)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-5)


def test_pose_graph_closes_loop_single_device():
    true_rel = _noisy_chain()
    # corrupt odometry with noise, add perfect loop closure 0 -> last
    noisy_rel = true_rel + 0.02 * np.random.default_rng(1).standard_normal(
        true_rel.shape
    ).astype(np.float32)
    # ground-truth total transform for the loop edge
    T = np.eye(4)
    for k in range(len(true_rel)):
        T = T @ np.asarray(se3.inverse(se3.pose_matrix(true_rel[k])))
    z_loop = np.asarray(se3.matrix_to_state(jnp.asarray(T)), dtype=np.float32)
    n = len(true_rel) + 1
    graph = chain_to_graph(noisy_rel, [(0, n - 1, z_loop)], loop_weight=100.0)

    # cost before
    _, cost0 = optimize_pose_graph(graph, iterations=1, damping=1e-4)
    states, cost = optimize_pose_graph(graph, iterations=15, damping=1e-4)
    assert float(cost) < float(cost0)
    # loop edge satisfied after optimization
    r_loop = edge_residual(states[0], states[n - 1], jnp.asarray(z_loop))
    assert np.linalg.norm(np.asarray(r_loop)) < 0.02


def test_pose_graph_sharded_matches_single_device():
    true_rel = _noisy_chain(n=6, seed=3)
    graph = chain_to_graph(true_rel)
    states_1, cost_1 = optimize_pose_graph(graph, iterations=5)
    mesh = make_mesh(8, pixel_parallel=2)
    states_8, cost_8 = optimize_pose_graph(graph, mesh=mesh, iterations=5)
    np.testing.assert_allclose(np.asarray(states_8), np.asarray(states_1), atol=1e-4)
    np.testing.assert_allclose(float(cost_8), float(cost_1), rtol=1e-4, atol=1e-6)


def test_multi_sequence_server_matches_serial(intr, small_pair):
    from phovo_tpu.models.analytic import align_sequence
    from phovo_tpu.parallel.batch import make_multi_sequence_server

    I0, D0, I1, D1, _ = small_pair
    # T=3 frames per stream: forward then back to the start
    I = jnp.stack([jnp.asarray(I0), jnp.asarray(I1), jnp.asarray(I0)])
    D = jnp.stack([jnp.asarray(D0), jnp.asarray(D1), jnp.asarray(D0)])
    S = 4
    Is = jnp.broadcast_to(I, (S,) + I.shape)
    Ds = jnp.broadcast_to(D, (S,) + D.shape)

    mesh = make_mesh(4, pixel_parallel=1)
    serve = make_multi_sequence_server(mesh, CFG)
    res, poses = serve(Is, Ds, intr)
    assert res.state.shape == (S, 2, 6)
    assert poses.shape == (S, 2, 4, 4)

    serial = align_sequence(I, D, intr, CFG)
    for s in range(S):
        np.testing.assert_allclose(
            np.asarray(res.state[s]), np.asarray(serial.state), atol=1e-5
        )
    # device pose integration == host pose <- pose @ Rt^-1 loop
    pose = np.eye(4)
    for k in range(2):
        Rt = np.asarray(se3.pose_matrix(serial.state[k]), dtype=np.float64)
        pose = pose @ np.linalg.inv(Rt)
        np.testing.assert_allclose(np.asarray(poses[0, k]), pose, atol=1e-4)


def test_pose_graph_cg_matches_dense():
    true_rel = _noisy_chain(n=8, seed=5)
    noisy = true_rel + 0.02 * np.random.default_rng(7).standard_normal(
        true_rel.shape
    ).astype(np.float32)
    graph = chain_to_graph(noisy)
    states_d, cost_d = optimize_pose_graph(
        graph, iterations=6, damping=1e-4, solver="dense"
    )
    states_c, cost_c = optimize_pose_graph(
        graph, iterations=6, damping=1e-4, solver="cg",
        cg_iterations=200, cg_tol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(states_c), np.asarray(states_d), atol=1e-4
    )
    np.testing.assert_allclose(float(cost_c), float(cost_d), rtol=1e-4, atol=1e-8)


def test_pose_graph_cg_sharded_matches_single_device():
    true_rel = _noisy_chain(n=6, seed=11)
    graph = chain_to_graph(true_rel, [(0, 5, np.zeros(6, np.float32))],
                           loop_weight=10.0)
    s1, c1 = optimize_pose_graph(
        graph, iterations=5, solver="cg", cg_iterations=150, cg_tol=1e-12
    )
    mesh = make_mesh(8, pixel_parallel=2)
    s8, c8 = optimize_pose_graph(
        graph, mesh=mesh, iterations=5, solver="cg",
        cg_iterations=150, cg_tol=1e-12,
    )
    np.testing.assert_allclose(np.asarray(s8), np.asarray(s1), atol=1e-4)
    np.testing.assert_allclose(float(c8), float(c1), rtol=1e-4, atol=1e-8)
    # and CG agrees with the dense solver on the same sharded graph
    sd, cd = optimize_pose_graph(graph, mesh=mesh, iterations=5, solver="dense")
    np.testing.assert_allclose(np.asarray(s8), np.asarray(sd), atol=1e-4)


def test_pose_graph_bucketed_matches_unbucketed():
    """bucket=True (shape bucketing for compile reuse) must return the
    same states/cost as the exact-shape solve, for both solvers, with and
    without a mesh. Padding poses are edge-less (step exactly 0) and
    padding edges are masked, so agreement is to f32 reduction noise."""
    true_rel = _noisy_chain(n=9, seed=13)  # 9 poses, 8 odometry edges
    noisy = true_rel + 0.02 * np.random.default_rng(3).standard_normal(
        true_rel.shape
    ).astype(np.float32)
    graph = chain_to_graph(noisy, [(0, 8, np.zeros(6, np.float32))],
                           loop_weight=10.0)
    for solver in ("dense", "cg"):
        s0, c0 = optimize_pose_graph(
            graph, iterations=5, damping=1e-4, solver=solver,
            cg_iterations=200, cg_tol=1e-12,
        )
        sb, cb = optimize_pose_graph(
            graph, iterations=5, damping=1e-4, solver=solver,
            cg_iterations=200, cg_tol=1e-12, bucket=True,
        )
        assert sb.shape == s0.shape  # sliced back to the real pose count
        np.testing.assert_allclose(
            np.asarray(sb), np.asarray(s0), atol=1e-5, err_msg=solver
        )
        np.testing.assert_allclose(float(cb), float(c0), rtol=1e-5, atol=1e-8)
    mesh = make_mesh(8, pixel_parallel=2)
    sm, cm = optimize_pose_graph(graph, mesh=mesh, iterations=5, damping=1e-4)
    smb, cmb = optimize_pose_graph(
        graph, mesh=mesh, iterations=5, damping=1e-4, bucket=True
    )
    np.testing.assert_allclose(np.asarray(smb), np.asarray(sm), atol=1e-5)
    np.testing.assert_allclose(float(cmb), float(cm), rtol=1e-5, atol=1e-8)


def test_levelmajor_sharded_matches_single_device(intr, small_pair):
    """The batched (level-major) chains composed with shard_map on the
    virtual mesh must reproduce the 1-device numbers — each device batches
    ITS streams' pairs locally, zero cross-device traffic."""
    from phovo_tpu.parallel.batch import (
        align_sequences,
        make_multi_sequence_server,
    )

    I0, D0, I1, D1, _ = small_pair
    cfg = PhovoConfig(
        num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2,
        max_iterations=(2, 3), lambda_steps=(1.0, 1.0),
        min_gradient_norms=(1e-10,) * 2, sampling="bilinear",
    )
    S, T = 4, 3
    Is = jnp.asarray(np.stack([np.stack([I0, I1, I0])] * S))
    Ds = jnp.asarray(np.stack([np.stack([D0, D1, D0])] * S))
    # perturb per stream so shards do distinct work
    Is = Is + jnp.arange(S, dtype=jnp.float32)[:, None, None, None] * 0.001
    mesh = make_mesh(4, pixel_parallel=1)
    sh, _ = make_multi_sequence_server(mesh, cfg)(Is, Ds, intr)
    single, _ = align_sequences(Is, Ds, intr, cfg)
    np.testing.assert_allclose(
        np.asarray(sh.state), np.asarray(single.state), atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(sh.iterations), np.asarray(single.iterations)
    )


def test_chunked_server_levelmajor_route_matches_default(intr, small_pair):
    """make_chunked_sequence_server (shard_map over the 'data' axis) must
    produce the chunk results of the unsharded serve_sequences_chunk on
    the same streams (same inits, zero warm start)."""
    from phovo_tpu.parallel.batch import (
        make_chunked_sequence_server,
        serve_sequences_chunk,
    )

    I0, D0, I1, D1, _ = small_pair
    cfg = PhovoConfig(
        num_levels=2, blur_filter_sizes=(0, 0), gradient_scales=(0.0625,) * 2,
        max_iterations=(2, 3), lambda_steps=(1.0, 1.0),
        min_gradient_norms=(1e-10,) * 2, sampling="bilinear",
    )
    S, B = 4, 2
    mesh = make_mesh(4, pixel_parallel=1)
    carry_i = jnp.asarray(np.stack([I0] * S))
    carry_d = jnp.asarray(np.stack([D0] * S))
    Is = jnp.asarray(np.stack([np.stack([I1, I0])] * S))
    Ds = jnp.asarray(np.stack([np.stack([D1, D0])] * S))
    serve = make_chunked_sequence_server(mesh, cfg)
    res_sh, poses_sh, ci_sh, cd_sh = serve(carry_i, carry_d, Is, Ds, intr)
    res_1, poses_1, ci_1, cd_1 = serve_sequences_chunk(
        carry_i, carry_d, Is, Ds, intr, cfg
    )
    assert res_sh.state.shape == (S, B, 6)
    np.testing.assert_allclose(
        np.asarray(res_sh.state), np.asarray(res_1.state), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(poses_sh), np.asarray(poses_1), atol=1e-4
    )
    np.testing.assert_allclose(np.asarray(ci_sh), np.asarray(ci_1))
    np.testing.assert_allclose(np.asarray(cd_sh), np.asarray(cd_1))
