"""Symbolic re-derivation of the analytic Jacobians (sympy).

The reference ships wxMaxima worksheets deriving its Jacobian expressions
(phovo/Maxima/derivatives_photoconsistency.wxm and
…_separated_jacobians.wxm — SURVEY §2 #22). This is the machine-checked
equivalent: sympy symbolically differentiates the full projection chain
u,v = proj(R(yaw,pitch,roll) p + t) and the results are compared numerically
against our closed-form implementations at random points.
"""

import numpy as np
import pytest
import sympy as sp

import jax.numpy as jnp

from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.residuals import projection_jacobian, rigid_jacobian, warp_and_jacobian


@pytest.fixture(scope="module")
def symbolic():
    x, y, z, yaw, pitch, roll = sp.symbols("x y z yaw pitch roll", real=True)
    px, py, pz = sp.symbols("px py pz", real=True)
    fx, fy, cx, cy = sp.symbols("fx fy cx cy", positive=True)

    Rz = sp.Matrix([[sp.cos(yaw), -sp.sin(yaw), 0],
                    [sp.sin(yaw), sp.cos(yaw), 0],
                    [0, 0, 1]])
    Ry = sp.Matrix([[sp.cos(pitch), 0, sp.sin(pitch)],
                    [0, 1, 0],
                    [-sp.sin(pitch), 0, sp.cos(pitch)]])
    Rx = sp.Matrix([[1, 0, 0],
                    [0, sp.cos(roll), -sp.sin(roll)],
                    [0, sp.sin(roll), sp.cos(roll)]])
    R = Rz * Ry * Rx  # ZYX convention (eigenPose / ops.se3.pose_matrix)
    p = sp.Matrix([px, py, pz])
    t = sp.Matrix([x, y, z])
    tp = R * p + t
    u = fx * tp[0] / tp[2] + cx
    v = fy * tp[1] / tp[2] + cy

    params = [x, y, z, yaw, pitch, roll]
    J_uv = sp.Matrix([[sp.diff(u, q) for q in params],
                      [sp.diff(v, q) for q in params]])
    syms = (x, y, z, yaw, pitch, roll, px, py, pz, fx, fy, cx, cy)
    return {
        "J_uv": sp.lambdify(syms, J_uv, "numpy"),
        "R": sp.lambdify((yaw, pitch, roll), R, "numpy"),
        "J_tp": sp.lambdify(
            syms, sp.Matrix([[sp.diff(tp[i], q) for q in params] for i in range(3)]),
            "numpy",
        ),
    }


RNG = np.random.default_rng(42)
CASES = [
    dict(
        state=RNG.uniform(-0.5, 0.5, 6),
        point=np.array([RNG.uniform(-1, 1), RNG.uniform(-1, 1), RNG.uniform(0.5, 4)]),
    )
    for _ in range(6)
]


def test_rotation_matches_symbolic(symbolic):
    for case in CASES:
        s = case["state"]
        R_sym = np.asarray(symbolic["R"](s[3], s[4], s[5]), dtype=np.float64)
        R_ours = np.asarray(se3.pose_matrix(s)[ :3, :3])
        np.testing.assert_allclose(R_ours, R_sym, atol=1e-6)


def test_rigid_jacobian_matches_symbolic(symbolic):
    """3x6 d(Rp+t)/dstate == sympy derivative of the chain (the separated
    jacobianRt of the reference, …BiObjective.h:351-381)."""
    for case in CASES:
        s, p = case["state"], case["point"]
        args = (*s, *p, 1.0, 1.0, 0.0, 0.0)
        J_sym = np.asarray(symbolic["J_tp"](*args), dtype=np.float64)
        J_ours = np.asarray(rigid_jacobian(jnp.asarray(p), jnp.asarray(s)))
        np.testing.assert_allclose(J_ours, J_sym, atol=1e-5)


def test_full_pixel_jacobian_matches_symbolic(symbolic):
    """2x6 d(u,v)/dstate — the quantity the reference's 26 'temp' trig
    expressions encode (…Analytic.h:243-342) and the Maxima worksheets
    derive. Checked against the exact symbolic derivative."""
    fx, fy, cx, cy = 525.0, 520.0, 319.5, 239.5
    intr = Intrinsics(np.float32(fx), np.float32(fy), np.float32(cx), np.float32(cy))
    for case in CASES:
        s, p = case["state"], case["point"]
        args = (*s, *p, fx, fy, cx, cy)
        J_sym = np.asarray(symbolic["J_uv"](*args), dtype=np.float64)

        # our chained form: depth image containing pz at the pixel that
        # backprojects to (px, py, pz)
        u0 = p[0] / p[2] * fx + cx
        v0 = p[1] / p[2] * fy + cy
        # build a 1x1 'image' via direct jacobian composition instead
        T = np.asarray(se3.pose_matrix(s))
        tp = T[:3, :3] @ p + T[:3, 3]
        J_proj = np.asarray(projection_jacobian(jnp.asarray(tp), intr))
        J_rt = np.asarray(rigid_jacobian(jnp.asarray(p), jnp.asarray(s)))
        J_ours = J_proj @ J_rt
        np.testing.assert_allclose(J_ours, J_sym, rtol=2e-4, atol=2e-4)


def test_kernel_geometry_matches_symbolic(symbolic):
    """warp_and_jacobian's J_pix (the quantity the linearizers compute
    per pixel) equals the symbolic derivative for an actual depth image."""
    fx, fy, cx, cy = 128.0, 130.0, 63.5, 47.5
    intr = Intrinsics(np.float32(fx), np.float32(fy), np.float32(cx), np.float32(cy))
    depth = np.full((8, 16), 2.0, np.float32)
    depth[3, 5] = 1.3
    s = CASES[0]["state"].astype(np.float32)
    col, row, tp, J_pix, valid = warp_and_jacobian(
        jnp.asarray(depth), jnp.asarray(s), intr, 0.3, 5.0
    )
    for (r, c) in [(3, 5), (0, 0), (7, 15)]:
        z = float(depth[r, c])
        p = np.array([(c - cx) * z / fx, (r - cy) * z / fy, z])
        args = (*s.astype(np.float64), *p, fx, fy, cx, cy)
        J_sym = np.asarray(symbolic["J_uv"](*args), dtype=np.float64)
        np.testing.assert_allclose(
            np.asarray(J_pix)[r, c], J_sym, rtol=3e-3, atol=3e-3
        )
