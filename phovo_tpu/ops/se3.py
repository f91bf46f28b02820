"""SE(3) pose parameterization used across the framework.

State vector convention (matches the reference library's central convention,
/root/reference/phovo/include/CPhotoconsistencyOdometry.h:47-71):

    state = [x, y, z, yaw, pitch, roll]

with rotation R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (ZYX intrinsic Euler).
All functions are pure, jit-safe, dtype-polymorphic, and batched via vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pose_matrix(state: jax.Array) -> jax.Array:
    """6-vector [x,y,z,yaw,pitch,roll] -> 4x4 rigid transform.

    ZYX Euler convention identical to the reference `eigenPose`
    (CPhotoconsistencyOdometry.h:47-71). Supports leading batch dims.
    """
    state = jnp.asarray(state)
    x, y, z, yaw, pitch, roll = jnp.moveaxis(state, -1, 0)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr, x],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr, y],
        [-sp, cp * sr, cp * cr, z],
        [zero, zero, zero, one],
    ]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def pose_matrix_np(state) -> "np.ndarray":
    """Host-side float64 twin of pose_matrix (same ZYX convention).

    The host pipeline integrates one 4x4 pose per frame; routing that
    through the jitted pose_matrix costs a device dispatch + blocking
    fetch per frame (round-trip bound, and silently f32 since x64 is
    disabled). Keep it on the host in true double.
    Supports leading batch dims like the JAX version.
    """
    import numpy as np

    state = np.asarray(state, np.float64)
    x, y, z, yaw, pitch, roll = np.moveaxis(state, -1, 0)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    zero = np.zeros_like(x)
    one = np.ones_like(x)
    rows = [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr, x],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr, y],
        [-sp, cp * sr, cp * cr, z],
        [zero, zero, zero, one],
    ]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def matrix_to_state_np(T) -> "np.ndarray":
    """Host-side float64 twin of matrix_to_state (see pose_matrix_np)."""
    import numpy as np

    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    pitch = np.arcsin(np.clip(-R[..., 2, 0], -1.0, 1.0))
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    t = T[..., :3, 3]
    return np.concatenate(
        [t, np.stack([yaw, pitch, roll], axis=-1)], axis=-1
    )


def rotation_zyx(yaw: jax.Array, pitch: jax.Array, roll: jax.Array) -> jax.Array:
    """3x3 rotation R = Rz(yaw) Ry(pitch) Rx(roll)."""
    state = jnp.stack(
        [jnp.zeros_like(yaw), jnp.zeros_like(yaw), jnp.zeros_like(yaw), yaw, pitch, roll],
        axis=-1,
    )
    return pose_matrix(state)[..., :3, :3]


def inverse(T: jax.Array) -> jax.Array:
    """Closed-form inverse of a rigid transform (batched)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = jnp.swapaxes(R, -1, -2)
    top = jnp.concatenate([Rt, -Rt @ t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), T.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def compose(A: jax.Array, B: jax.Array) -> jax.Array:
    """A @ B for rigid transforms (batched matmul)."""
    return A @ B


def integrate_trajectory(states: jax.Array) -> jax.Array:
    """Device-side global-pose integration of per-pair relative states.

    states: (B, 6) relative states (pair k aligns frame k -> k+1, the
    align_sequence output). Returns (B, 4, 4) with
    pose_k = inv(Rt_0) @ inv(Rt_1) @ ... @ inv(Rt_k) — exactly the VO app's
    running integration pose <- pose @ Rt^-1 from identity
    (PhotoconsistencyVisualOdometry.cpp:233-234), but computed as an
    O(log B)-depth prefix product with lax.associative_scan (matrix
    composition is associative) instead of a host loop.
    """
    M = inverse(pose_matrix(states))
    return jax.lax.associative_scan(jnp.matmul, M)


def rotation_to_quaternion(R: jax.Array) -> jax.Array:
    """3x3 rotation -> unit quaternion [qx, qy, qz, qw].

    Branchless Shepperd-style selection (all four candidate quaternions are
    computed; the numerically best one is selected with jnp.where) so the
    function is jit- and vmap-safe. Matches Eigen's Quaternion(R) up to sign;
    we normalize to qw >= 0. Reference use: trajectory export
    (PhotoconsistencyVisualOdometry.cpp:235-243).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, 1e-24))

    # Candidate 0: trace-dominant
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    # Candidate 1: m00 dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    # Candidate 2: m11 dominant
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    # Candidate 3: m22 dominant
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)

    cond_tr = tr > 0.0
    cond_1 = (m00 > m11) & (m00 > m22)
    cond_2 = m11 > m22
    q = jnp.where(
        cond_tr[..., None],
        q0,
        jnp.where(cond_1[..., None], q1, jnp.where(cond_2[..., None], q2, q3)),
    )
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.where(q[..., 3:4] < 0, -q, q)


def rotation_to_quaternion_np(R) -> "np.ndarray":
    """Host-side float64 twin of rotation_to_quaternion (same candidate
    selection and qw >= 0 convention).

    Trajectory export/evaluation runs per pose on the host; routing each
    pose through the jitted jnp version costs a device dispatch + blocking
    fetch PER POSE — a 1,200-pose map-scale evaluation pays 1,200 round
    trips (same class of bug as the pose-integration fix,
    se3.pose_matrix_np)."""
    import numpy as np

    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return np.sqrt(np.maximum(v, 1e-24))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = np.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = np.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = np.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = np.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)
    cond_tr = (tr > 0.0)[..., None]
    cond_1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond_2 = (m11 > m22)[..., None]
    q = np.where(cond_tr, q0, np.where(cond_1, q1, np.where(cond_2, q2, q3)))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[..., 3:4] < 0, -q, q)


def quaternion_to_rotation_np(q) -> "np.ndarray":
    """Host-side float64 twin of quaternion_to_rotation (see
    rotation_to_quaternion_np for why the twins exist)."""
    import numpy as np

    q = np.asarray(q, np.float64)
    qx, qy, qz, qw = np.moveaxis(q, -1, 0)
    rows = [
        [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx**2 + qy**2)],
    ]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def quaternion_to_rotation(q: jax.Array) -> jax.Array:
    """Unit quaternion [qx,qy,qz,qw] -> 3x3 rotation (batched)."""
    qx, qy, qz, qw = jnp.moveaxis(q, -1, 0)
    rows = [
        [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx**2 + qy**2)],
    ]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def matrix_to_state(T: jax.Array) -> jax.Array:
    """4x4 rigid transform -> [x,y,z,yaw,pitch,roll] (inverse of pose_matrix).

    Uses atan2 extraction for the ZYX convention; pitch is clamped to the
    principal branch (gimbal lock at |pitch| = pi/2 resolved arbitrarily).
    """
    R = T[..., :3, :3]
    pitch = jnp.arcsin(jnp.clip(-R[..., 2, 0], -1.0, 1.0))
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    t = T[..., :3, 3]
    return jnp.concatenate(
        [t, jnp.stack([yaw, pitch, roll], axis=-1)], axis=-1
    )


def rotation_jacobian_wrt_euler(state: jax.Array) -> jax.Array:
    """d(R @ p)/d(yaw,pitch,roll) without the point: returns (3, 3, 3) tensor
    dRdA[k] = dR/d(angle_k) for angle order (yaw, pitch, roll).

    The per-point rigid Jacobian J_Rt (3x6) used by the residual kernels is
    then [I_3 | dRdA[0]@p, dRdA[1]@p, dRdA[2]@p]. Closed forms match the
    reference's separated Jacobians
    (CPhotoconsistencyOdometryBiObjective.h:351-381, derived in
    phovo/Maxima/derivatives_photoconsistency_separated_jacobians.wxm).
    """
    _, _, _, yaw, pitch, roll = jnp.moveaxis(jnp.asarray(state), -1, 0)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    z = jnp.zeros_like(yaw)

    dR_dyaw = jnp.stack(
        [
            jnp.stack([-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr], -1),
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            jnp.stack([z, z, z], -1),
        ],
        -2,
    )
    dR_dpitch = jnp.stack(
        [
            jnp.stack([-cy * sp, cy * cp * sr, cy * cp * cr], -1),
            jnp.stack([-sy * sp, sy * cp * sr, sy * cp * cr], -1),
            jnp.stack([-cp, -sp * sr, -sp * cr], -1),
        ],
        -2,
    )
    dR_droll = jnp.stack(
        [
            jnp.stack([z, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr], -1),
            jnp.stack([z, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr], -1),
            jnp.stack([z, cp * cr, -cp * sr], -1),
        ],
        -2,
    )
    return jnp.stack([dR_dyaw, dR_dpitch, dR_droll], axis=-3)
