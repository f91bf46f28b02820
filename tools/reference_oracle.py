"""Reference-exact f64 emulation of the reference's three optimizer backends.

PURPOSE — parity oracle only. This module is NOT part of the framework
and shares no code with it: it exists so the blueprint's headline accuracy
target ("match the reference trajectory within its ATE bound per preset")
can be MEASURED instead of asserted. It re-executes the reference's math in
double-precision numpy + OpenCV (the very library the reference calls for
resize/GaussianBlur/Scharr), reproducing the reference bug-for-bug:

  * scatter residual indexing: the residual is written at the TRANSFORMED
    integer pixel index while the Jacobian row stays at the source index
    (CPhotoconsistencyOdometryAnalytic.h:351-358) — so J^T r pairs row i's
    Jacobian with whatever residual got scattered TO i;
  * the temp11 Jacobian slip: temp11 = cos(pitch)*cos(yaw) + x mixes the
    translation into a rotation term (…Analytic.h:253), used verbatim in the
    d/dz, d/dpitch and d/droll entries (…Analytic.h:325,334,340);
  * nearest-int rounding with C round() half-away-from-zero semantics
    (…Analytic.h:297-298), NOT numpy's banker's rounding;
  * the bi-objective row interleave overlap: intensity rows at index i,
    depth rows at index 2i of the same 2N arrays, later writes winning in
    row-major pixel order (…BiObjective.h:420-446);
  * the Ceres functor's float-coordinate bounds test, int-truncation scatter
    index, and bilinear sampling at (x-0.5, y-0.5) with LinearInitAxis edge
    clamping/extrapolation (…Ceres.h:249-262, third_party/sample.h:33-99);
  * double precision throughout (apps typedef CoordinateType = double).

The Ceres trust-region driver is emulated after Ceres's public
LevenbergMarquardtStrategy/TrustRegionMinimizer algorithm (the options the
reference sets at …Ceres.h:464-477); see CeresOracle for the documented
deviations (we cannot run the actual Ceres binary here).

Everything is vectorized numpy: duplicate-index fancy assignment takes the
last value in index order, which reproduces the reference's sequential
row-major scatter (covered by tests/test_reference_oracle.py against an
explicit per-pixel loop).
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is baked into this image
    cv2 = None

__all__ = [
    "AnalyticOracle",
    "BiObjectiveOracle",
    "CeresOracle",
    "oracle_for_backend",
    "pose_matrix",
]


# ---------------------------------------------------------------------------
# shared reference math (f64)
# ---------------------------------------------------------------------------


def pose_matrix(state: np.ndarray) -> np.ndarray:
    """eigenPose (CPhotoconsistencyOdometry.h:47-71): ZYX Euler + translation."""
    x, y, z, yaw, pitch, roll = (float(v) for v in state)
    sy, cy = np.sin(yaw), np.cos(yaw)
    sp, cp = np.sin(pitch), np.cos(pitch)
    sr, cr = np.sin(roll), np.cos(roll)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr, x],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr, y],
            [-sp, cp * sr, cp * cr, z],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float64,
    )


def _rotation_and_partials(yaw: float, pitch: float, roll: float):
    """R = Rz(yaw) Ry(pitch) Rx(roll) and its exact partials (what Ceres jet
    arithmetic computes through the Rt construction at …Ceres.h:178-200)."""
    sy, cy = np.sin(yaw), np.cos(yaw)
    sp, cp = np.sin(pitch), np.cos(pitch)
    sr, cr = np.sin(roll), np.cos(roll)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    dRz = np.array([[-sy, -cy, 0], [cy, -sy, 0], [0, 0, 0.0]])
    dRy = np.array([[-sp, 0, cp], [0, 0.0, 0], [-cp, 0, -sp]])
    dRx = np.array([[0.0, 0, 0], [0, -sr, -cr], [0, cr, -sr]])
    R = Rz @ Ry @ Rx
    return R, dRz @ Ry @ Rx, Rz @ dRy @ Rx, Rz @ Ry @ dRx


def _c_round(a: np.ndarray) -> np.ndarray:
    """C round(): half away from zero (…Analytic.h:297-298). numpy's
    np.round is half-to-even and would disagree on exact .5 coordinates."""
    return np.sign(a) * np.floor(np.abs(a) + 0.5)


def _to_unit_intensity(img: np.ndarray) -> np.ndarray:
    """SetSourceFrame's convertTo(depth.type(), 1/255) (…Analytic.h:470-471).

    uint8 input scales by 1/255; float input is assumed already converted
    by the caller (the apps always pass 8-bit grayscale)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float64) * (1.0 / 255.0)
    return img.astype(np.float64)


def _build_pyramid(
    img: np.ndarray, levels: int, blur_sizes, apply_blur: bool
) -> list[np.ndarray]:
    """BuildPyramid (…Analytic.h:115-163): level k = cv::resize of the
    ORIGINAL by 1/2^k (INTER_LINEAR), then double GaussianBlur(k, sigma=3)
    when apply_blur and blur size > 0."""
    pyramid = []
    factor = 1.0
    for level in range(levels):
        if level == 0:
            aux = img.copy()
        else:
            aux = cv2.resize(img, (0, 0), fx=factor, fy=factor)
        if apply_blur:
            k = int(blur_sizes[level]) if level < len(blur_sizes) else 0
            if k > 0:
                aux = cv2.GaussianBlur(aux, (k, k), 3)
                aux = cv2.GaussianBlur(aux, (k, k), 3)
        pyramid.append(aux)
        factor /= 2.0
    return pyramid


def _build_gradient_pyramids(pyramid, scales):
    """BuildDerivativesPyramids (…Analytic.h:165-189): cv::Scharr per level
    with the per-level scale, BORDER_DEFAULT (reflect-101)."""
    gx, gy = [], []
    for level, img in enumerate(pyramid):
        s = float(scales[level]) if level < len(scales) else scales[-1]
        gx.append(cv2.Scharr(img, cv2.CV_64F, 1, 0, scale=s, delta=0.0))
        gy.append(cv2.Scharr(img, cv2.CV_64F, 0, 1, scale=s, delta=0.0))
    return gx, gy


def _schedule(values, num_levels, default):
    """Per-level schedule access with the same padding the framework's
    loader applies when a preset ships a short array (the reference would
    read out of bounds — config_5_level_optimization_ceres.yml's 4-entry
    min_trust_region_radius for 5 levels)."""
    if values is None:
        return [default] * num_levels
    vals = list(values)
    while len(vals) < num_levels:
        vals.append(vals[-1] if vals else default)
    return vals[:num_levels]


class _OracleBase:
    """Shared 7-method reference API (CPhotoconsistencyOdometry.h:137-179)."""

    def __init__(self, config=None, min_depth: float = 0.3, max_depth: float = 5.0):
        if cv2 is None:
            raise RuntimeError("reference oracle requires OpenCV (cv2)")
        self.config = config
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.K = None
        self.state = np.zeros(6, dtype=np.float64)
        n = int(config.num_levels)
        self.num_levels = n
        self.blur_sizes = _schedule(config.blur_filter_sizes, n, 0)
        self.grad_scales = _schedule(config.gradient_scales, n, 0.0625)
        self.max_iterations = _schedule(config.max_iterations, n, 0)

    def set_min_depth(self, d: float) -> None:
        self.min_depth = float(d)

    def set_max_depth(self, d: float) -> None:
        self.max_depth = float(d)

    def set_intrinsic_matrix(self, K: np.ndarray) -> None:
        self.K = np.asarray(K, dtype=np.float64)

    def set_initial_state_vector(self, state: np.ndarray) -> None:
        self.state = np.asarray(state, dtype=np.float64).copy()

    def get_optimal_state_vector(self) -> np.ndarray:
        return self.state.copy()

    def get_optimal_rigid_transformation_matrix(self) -> np.ndarray:
        return pose_matrix(self.state)

    def _level_intrinsics(self, level: int):
        s = 1.0 / (2.0**level)
        K = self.K
        return K[0, 0] * s, K[1, 1] * s, K[0, 2] * s, K[1, 2] * s

    def _project(self, level: int, depth: np.ndarray, Rt: np.ndarray):
        """Back-project -> transform -> project (common to every backend).
        Returns (px, py, pz, tx, ty, tz, tc, tr, valid)."""
        fx, fy, ox, oy = self._level_intrinsics(level)
        nR, nC = depth.shape
        rr, cc = np.meshgrid(
            np.arange(nR, dtype=np.float64),
            np.arange(nC, dtype=np.float64),
            indexing="ij",
        )
        pz = depth
        valid = (self.min_depth < pz) & (pz < self.max_depth)
        with np.errstate(all="ignore"):
            px = (cc - ox) * pz * (1.0 / fx)
            py = (rr - oy) * pz * (1.0 / fy)
            tx = Rt[0, 0] * px + Rt[0, 1] * py + Rt[0, 2] * pz + Rt[0, 3]
            ty = Rt[1, 0] * px + Rt[1, 1] * py + Rt[1, 2] * pz + Rt[1, 3]
            tz = Rt[2, 0] * px + Rt[2, 1] * py + Rt[2, 2] * pz + Rt[2, 3]
            inv_tz = 1.0 / tz
            tc = tx * fx * inv_tz + ox
            tr = ty * fy * inv_tz + oy
        return px, py, pz, tx, ty, tz, tc, tr, valid


# ---------------------------------------------------------------------------
# analytic backend
# ---------------------------------------------------------------------------


class AnalyticOracle(_OracleBase):
    """CPhotoconsistencyOdometryAnalytic re-executed verbatim in f64 numpy.

    Per level (coarse to fine), per iteration (…Analytic.h:499-563):
    residuals/Jacobians via ComputeResidualsAndJacobians (:191-367) including
    the scatter residual write and the temp11 slip, then
    x <- x - lambda * (J^T J)^-1 J^T r, terminating on max-iters or
    ||J^T r|| < min_gradient_norm (:376-426)."""

    def __init__(self, config=None, min_depth: float = 0.3, max_depth: float = 5.0):
        super().__init__(config, min_depth, max_depth)
        self.lambda_steps = _schedule(config.lambda_steps, self.num_levels, 1.0)
        self.min_gradient_norms = _schedule(
            config.min_gradient_norms, self.num_levels, 300.0
        )

    def set_source_frame(self, intensity, depth) -> None:
        I = _to_unit_intensity(intensity)
        D = np.asarray(depth, dtype=np.float64)
        self.pyr_I0 = _build_pyramid(I, self.num_levels, self.blur_sizes, True)
        self.pyr_D0 = _build_pyramid(D, self.num_levels, self.blur_sizes, False)

    def set_target_frame(self, intensity, depth) -> None:
        I = _to_unit_intensity(intensity)
        self.pyr_I1 = _build_pyramid(I, self.num_levels, self.blur_sizes, True)
        self.gx1, self.gy1 = _build_gradient_pyramids(self.pyr_I1, self.grad_scales)

    def _residuals_jacobians(self, level: int):
        """Vectorized ComputeResidualsAndJacobians (…Analytic.h:191-367)."""
        I0 = self.pyr_I0[level]
        D0 = self.pyr_D0[level]
        I1 = self.pyr_I1[level]
        GX = self.gx1[level].ravel()
        GY = self.gy1[level].ravel()
        nR, nC = I0.shape
        fx, fy, _, _ = self._level_intrinsics(level)

        x, y, z, yaw, pitch, roll = self.state
        Rt = pose_matrix(self.state)
        px, py, pz, tx, ty, tz, tc, tr, valid = self._project(level, D0, Rt)

        # verbatim trig temps (…Analytic.h:243-266) — including the temp11
        # slip: cos(pitch)*cos(yaw) + x (a translation leaking into what the
        # Maxima worksheet derived as a pure-rotation term).
        sr, cr = np.sin(roll), np.cos(roll)
        sp, cp = np.sin(pitch), np.cos(pitch)
        sy, cy = np.sin(yaw), np.cos(yaw)
        temp1 = cp * sr
        temp2 = cp * cr
        temp3 = sp
        temp4 = sr * sy + sp * cr * cy
        temp5 = sp * sr * cy - cr * sy
        temp6 = sp * sr * sy + cr * cy
        temp7 = -sp * sr * sy - cr * cy
        temp8 = sr * cy - sp * cr * sy
        temp9 = sp * cr * sy - sr * cy
        temp10 = cp * sr * cy
        temp11 = cp * cy + x  # the slip
        temp12 = cp * cr * cy
        temp13 = sp * cy
        temp14 = cp * sy
        temp15 = cp * cy
        temp16 = sp * sr
        temp17 = sp * cr
        temp18 = cp * sr * sy
        temp19 = cp * cr * sy
        temp20 = sp * sy
        temp21 = cr * sy - sp * sr * cy
        temp22 = cp * cr
        temp23 = cp * sr

        tr_i = _c_round(tr)
        tc_i = _c_round(tc)
        with np.errstate(invalid="ignore"):
            inb = (tr_i >= 0) & (tr_i < nR) & (tc_i >= 0) & (tc_i < nC)
        ok = valid & inb
        okf = ok.ravel()
        i_ok = np.nonzero(okf)[0]  # ascending == row-major pixel order

        pxv, pyv, pzv = px.ravel()[okf], py.ravel()[okf], pz.ravel()[okf]
        with np.errstate(all="ignore"):
            temp25 = 1.0 / (z + pyv * temp1 + pzv * temp2 - pxv * temp3)
        temp26 = temp25 * temp25

        # 2x6 projective+rigid Jacobian, verbatim (…Analytic.h:312-342)
        j = np.zeros((len(i_ok), 2, 6))
        j[:, 0, 0] = fx * temp25
        j[:, 1, 1] = fy * temp25
        j[:, 0, 2] = -fx * (pzv * temp4 + pyv * temp5 + pxv * temp11) * temp26
        j[:, 1, 2] = -fy * (pyv * temp6 + pzv * temp9 + pxv * temp14 + y) * temp26
        j[:, 0, 3] = fx * (pyv * temp7 + pzv * temp8 - pxv * temp14) * temp25
        j[:, 1, 3] = fy * (pzv * temp4 + pyv * temp5 + pxv * temp15) * temp25
        j[:, 0, 4] = (
            fx * (pyv * temp10 + pzv * temp12 - pxv * temp13) * temp25
            - fx
            * (-pyv * temp16 - pzv * temp17 - pxv * cp)
            * (pzv * temp4 + pyv * temp5 + pxv * temp11)
            * temp26
        )
        j[:, 1, 4] = (
            fy * (pyv * temp18 + pzv * temp19 - pxv * temp20) * temp25
            - fy
            * (-pyv * temp16 - pzv * temp17 - pxv * cp)
            * (pyv * temp6 + pzv * temp9 + pxv * temp14 + y)
            * temp26
        )
        j[:, 0, 5] = (
            fx * (pyv * temp4 + pzv * temp21) * temp25
            - fx
            * (pyv * temp22 - pzv * temp23)
            * (pzv * temp4 + pyv * temp5 + pxv * temp11)
            * temp26
        )
        j[:, 1, 5] = (
            fy * (pzv * temp7 + pyv * temp9) * temp25
            - fy
            * (pyv * temp22 - pzv * temp23)
            * (pyv * temp6 + pzv * temp9 + pxv * temp14 + y)
            * temp26
        )

        # chain with the TARGET image gradient at the SOURCE flat index i
        # (…Analytic.h:344-348: target_gradXImg(i) with i = nCols*r + c)
        grad = np.stack([GX[i_ok], GY[i_ok]], axis=1)  # (M, 2)
        rows = np.einsum("mk,mkj->mj", grad, j)

        jac = np.zeros((nR * nC, 6))
        jac[i_ok] = rows

        # scatter residual at the transformed integer pixel (…Analytic.h:358);
        # duplicate scatter targets resolve to the LAST write in row-major
        # pixel order (numpy fancy assignment in index order).
        scatter = (tr_i.ravel()[okf] * nC + tc_i.ravel()[okf]).astype(np.int64)
        pixel1 = I0.ravel()[i_ok]
        pixel2 = I1.ravel()[scatter]
        res = np.zeros(nR * nC)
        res[scatter] = pixel2 - pixel1
        return res, jac

    def optimize(self) -> np.ndarray:
        """The reference Optimize loop (…Analytic.h:500-563)."""
        gradients = np.zeros(6)
        for level in range(self.num_levels - 1, -1, -1):
            max_iters = int(self.max_iterations[level])
            lam = float(self.lambda_steps[level])
            min_gn = float(self.min_gradient_norms[level])
            iteration = 0
            while True:
                if max_iters > 0:
                    res, jac = self._residuals_jacobians(level)
                    gradients = jac.T @ res
                    H = jac.T @ jac
                    self.state = self.state - lam * np.linalg.solve(H, gradients)
                iteration += 1
                # TestTerminationCriteria (…Analytic.h:376-426): max-iters
                # checked BEFORE the gradient norm.
                if iteration >= max_iters:
                    break
                if np.linalg.norm(gradients) < min_gn:
                    break
        return self.state.copy()


# ---------------------------------------------------------------------------
# bi-objective backend
# ---------------------------------------------------------------------------


class BiObjectiveOracle(AnalyticOracle):
    """CPhotoconsistencyOdometryBiObjective re-executed verbatim, including
    the interleaved 2N row indexing whose intensity (index i) and depth
    (index 2i) writes overlap (…BiObjective.h:420-446) and the per-iteration
    depth gain = mean(I1)/mean(D1) (…BiObjective.h:299)."""

    def set_source_frame(self, intensity, depth) -> None:
        super().set_source_frame(intensity, depth)

    def set_target_frame(self, intensity, depth) -> None:
        I = _to_unit_intensity(intensity)
        D = np.asarray(depth, dtype=np.float64)
        self.pyr_I1 = _build_pyramid(I, self.num_levels, self.blur_sizes, True)
        self.pyr_D1 = _build_pyramid(D, self.num_levels, self.blur_sizes, False)
        self.gx1, self.gy1 = _build_gradient_pyramids(self.pyr_I1, self.grad_scales)
        # depth gradients on depth normalized by 1/maxDepth
        # (BuildDepthDerivativesPyramids, …BiObjective.h:213-239)
        norm = [d * (1.0 / self.max_depth) for d in self.pyr_D1]
        self.dgx1, self.dgy1 = _build_gradient_pyramids(norm, self.grad_scales)

    def _residuals_jacobians(self, level: int):
        I0 = self.pyr_I0[level]
        D0 = self.pyr_D0[level]
        I1 = self.pyr_I1[level]
        D1 = self.pyr_D1[level]
        GX = self.gx1[level].ravel()
        GY = self.gy1[level].ravel()
        DGX = self.dgx1[level].ravel()
        DGY = self.dgy1[level].ravel()
        nR, nC = I0.shape
        N = nR * nC
        fx, fy, _, _ = self._level_intrinsics(level)

        yaw, pitch, roll = self.state[3:]
        Rt = pose_matrix(self.state)
        px, py, pz, tx, ty, tz, tc, tr, valid = self._project(level, D0, Rt)
        gain = float(np.mean(I1) / np.mean(D1))  # …BiObjective.h:299

        tr_i = _c_round(tr)
        tc_i = _c_round(tc)
        with np.errstate(invalid="ignore"):
            inb = (tr_i >= 0) & (tr_i < nR) & (tc_i >= 0) & (tc_i < nC)
        ok = valid & inb
        okf = ok.ravel()
        i_ok = np.nonzero(okf)[0]
        M = len(i_ok)

        pxv, pyv, pzv = px.ravel()[okf], py.ravel()[okf], pz.ravel()[okf]
        txv, tyv, tzv = tx.ravel()[okf], ty.ravel()[okf], tz.ravel()[okf]
        with np.errstate(all="ignore"):
            inv_tz = 1.0 / tzv

        # separated Jacobians, verbatim (…BiObjective.h:352-396)
        sy, cy = np.sin(yaw), np.cos(yaw)
        sp, cp = np.sin(pitch), np.cos(pitch)
        sr, cr = np.sin(roll), np.cos(roll)
        jRt = np.zeros((M, 3, 6))
        jRt[:, 0, 0] = 1.0
        jRt[:, 1, 1] = 1.0
        jRt[:, 2, 2] = 1.0
        jRt[:, 0, 3] = (
            pyv * (-sp * sr * sy - cr * cy) + pzv * (sr * cy - sp * cr * sy) - cp * pxv * sy
        )
        jRt[:, 1, 3] = (
            pzv * (sr * sy + sp * cr * cy) + pyv * (sp * sr * cy - cr * sy) + cp * pxv * cy
        )
        jRt[:, 0, 4] = cp * pyv * sr * cy + cp * pzv * cr * cy - sp * pxv * cy
        jRt[:, 1, 4] = cp * pyv * sr * sy + cp * pzv * cr * sy - sp * pxv * sy
        jRt[:, 2, 4] = -sp * pyv * sr - sp * pzv * cr - cp * pxv
        jRt[:, 0, 5] = pyv * (sr * sy + sp * cr * cy) + pzv * (cr * sy - sp * sr * cy)
        jRt[:, 1, 5] = pzv * (-sp * sr * sy - cr * cy) + pyv * (sp * cr * sy - sr * cy)
        jRt[:, 2, 5] = cp * pyv * cr - cp * pzv * sr

        jProy = np.zeros((M, 2, 3))
        jProy[:, 0, 0] = fx * inv_tz
        jProy[:, 1, 1] = fy * inv_tz
        jProy[:, 0, 2] = -(fx * txv) * inv_tz * inv_tz
        jProy[:, 1, 2] = -(fy * tyv) * inv_tz * inv_tz

        jPR = np.einsum("mij,mjk->mik", jProy, jRt)  # (M, 2, 6)
        igrad = np.stack([GX[i_ok], GY[i_ok]], axis=1)
        dgrad = np.stack([DGX[i_ok], DGY[i_ok]], axis=1)
        rows_i = np.einsum("mk,mkj->mj", igrad, jPR)
        rows_d = gain * (np.einsum("mk,mkj->mj", dgrad, jPR) - jRt[:, 2, :])

        # residual values
        scatter = (tr_i.ravel()[okf] * nC + tc_i.ravel()[okf]).astype(np.int64)
        res_i = I1.ravel()[scatter] - I0.ravel()[i_ok]
        res_d = gain * (D1.ravel()[scatter] - D0.ravel()[i_ok])

        # verbatim interleaved writes into the 2N arrays, reproducing the
        # EXACT write order (per pixel: jac[i], res[s], jac[2i], res[2s];
        # pixels in row-major order) so every overlap resolves as the
        # reference resolves it (…BiObjective.h:420-446).
        jac = np.zeros((2 * N, 6))
        jac_idx = np.empty(2 * M, dtype=np.int64)
        jac_idx[0::2] = i_ok
        jac_idx[1::2] = 2 * i_ok
        jac_rows = np.empty((2 * M, 6))
        jac_rows[0::2] = rows_i
        jac_rows[1::2] = rows_d
        jac[jac_idx] = jac_rows

        res = np.zeros(2 * N)
        res_idx = np.empty(2 * M, dtype=np.int64)
        res_idx[0::2] = scatter
        res_idx[1::2] = 2 * scatter
        res_vals = np.empty(2 * M)
        res_vals[0::2] = res_i
        res_vals[1::2] = res_d
        res[res_idx] = res_vals
        return res, jac


# ---------------------------------------------------------------------------
# ceres backend
# ---------------------------------------------------------------------------


def _linear_init_axis(x: np.ndarray, size: int):
    """LinearInitAxis (sample.h:33-50): int truncation, edge clamp with
    dx = 1 outside, and the (-1, 0) extrapolation band verbatim."""
    ix = np.trunc(x).astype(np.int64)
    lo = ix < 0
    hi = ix > size - 2
    mid = ~(lo | hi)
    x1 = np.where(lo, 0, np.where(hi, size - 1, ix))
    x2 = np.where(lo, 0, np.where(hi, size - 1, ix + 1))
    dx = np.where(mid, x2 - x, 1.0)
    return x1, x2, dx


def _sample_linear(images, yy: np.ndarray, xx: np.ndarray):
    """SampleLinear (sample.h:52-99): bilinear at (x-0.5, y-0.5) over each
    image in `images` (shared weights)."""
    H, W = images[0].shape
    x = xx - 0.5
    y = yy - 0.5
    x1, x2, dx = _linear_init_axis(x, W)
    y1, y2, dy = _linear_init_axis(y, H)
    out = []
    for im in images:
        im11 = im[y1, x1]
        im12 = im[y1, x2]
        im21 = im[y2, x1]
        im22 = im[y2, x2]
        out.append(
            dy * (dx * im11 + (1.0 - dx) * im12)
            + (1.0 - dy) * (dx * im21 + (1.0 - dx) * im22)
        )
    return out


class CeresOracle(_OracleBase):
    """CPhotoconsistencyOdometryCeres re-executed in f64.

    The residual functor (…Ceres.h:156-269) is emulated exactly: float
    bounds test, truncation scatter index, bilinear SampleWithDerivative
    value, and the Jacobian the jets produce — [sampled gx, sampled gy] .
    d(tc,tr)/d(state) with the TRUE projection derivatives (jets are exact),
    written at the scattered row.

    The driver emulates Ceres's TrustRegionMinimizer with
    LevenbergMarquardtStrategy under the options the reference sets
    (…Ceres.h:464-477). Documented deviations from a real Ceres run:
      * SPARSE_NORMAL_CHOLESKY vs our dense 6x6 normal-equation solve —
        identical math at 6 parameters, different rounding;
      * Ceres 1.x evaluates the gradient tolerance relative to the initial
        gradient max-norm; we do the same;
      * inner details like Jacobian scaling/preconditioning differ across
        Ceres versions; at 6 well-scaled parameters their effect is far
        below the parity tolerances used in PARITY.md.
    """

    def __init__(self, config=None, min_depth: float = 0.3, max_depth: float = 5.0):
        super().__init__(config, min_depth, max_depth)
        n = self.num_levels
        c = config
        self.function_tolerances = _schedule(c.function_tolerances, n, 1e-6)
        self.gradient_tolerances = _schedule(c.gradient_tolerances, n, 1e-10)
        self.parameter_tolerances = _schedule(c.parameter_tolerances, n, 1e-8)
        self.initial_radii = _schedule(c.initial_trust_region_radii, n, 1e4)
        self.max_radii = _schedule(c.max_trust_region_radii, n, 1e16)
        self.min_radii = _schedule(c.min_trust_region_radii, n, 1e-32)
        self.min_relative_decreases = _schedule(c.min_relative_decreases, n, 1e-3)

    def set_source_frame(self, intensity, depth) -> None:
        I = _to_unit_intensity(intensity)
        D = np.asarray(depth, dtype=np.float64)
        self.pyr_I0 = _build_pyramid(I, self.num_levels, self.blur_sizes, True)
        self.pyr_D0 = _build_pyramid(D, self.num_levels, self.blur_sizes, False)

    def set_target_frame(self, intensity, depth) -> None:
        I = _to_unit_intensity(intensity)
        self.pyr_I1 = _build_pyramid(I, self.num_levels, self.blur_sizes, True)
        self.gx1, self.gy1 = _build_gradient_pyramids(self.pyr_I1, self.grad_scales)

    def _evaluate(self, level: int, state: np.ndarray):
        """One functor evaluation with jets: residual vector (N,), Jacobian
        (N, 6), both scatter-indexed (…Ceres.h:253-263)."""
        I0 = self.pyr_I0[level]
        D0 = self.pyr_D0[level]
        I1 = self.pyr_I1[level]
        GX = self.gx1[level]
        GY = self.gy1[level]
        nR, nC = I0.shape
        fx, fy, ox, oy = self._level_intrinsics(level)

        x, y, z, yaw, pitch, roll = state
        R, dRyaw, dRpitch, dRroll = _rotation_and_partials(yaw, pitch, roll)
        Rt = np.eye(4)
        Rt[:3, :3] = R
        Rt[:3, 3] = (x, y, z)
        px, py, pz, tx, ty, tz, tc, tr, valid = self._project(level, D0, Rt)

        # float-coordinate bounds test (…Ceres.h:249-251), NOT on ints
        with np.errstate(invalid="ignore"):
            inb = (tr >= 0.0) & (tr < nR) & (tc >= 0.0) & (tc < nC)
        ok = (valid & inb).ravel()
        i_ok = np.nonzero(ok)[0]

        pxv = px.ravel()[i_ok]
        pyv = py.ravel()[i_ok]
        pzv = pz.ravel()[i_ok]
        txv, tyv, tzv = tx.ravel()[i_ok], ty.ravel()[i_ok], tz.ravel()[i_ok]
        tcv, trv = tc.ravel()[i_ok], tr.ravel()[i_ok]
        inv_tz = 1.0 / tzv

        # d(transformed point)/d(state): translation = I, rotation = dR/da @ p
        P = np.stack([pxv, pyv, pzv], axis=1)  # (M, 3)
        dT = np.zeros((len(i_ok), 3, 6))
        dT[:, 0, 0] = 1.0
        dT[:, 1, 1] = 1.0
        dT[:, 2, 2] = 1.0
        dT[:, :, 3] = P @ dRyaw.T
        dT[:, :, 4] = P @ dRpitch.T
        dT[:, :, 5] = P @ dRroll.T

        # d(tc, tr)/d(state) via the projection quotient rule
        dtc = fx * (dT[:, 0, :] * inv_tz[:, None] - (txv * inv_tz * inv_tz)[:, None] * dT[:, 2, :])
        dtr = fy * (dT[:, 1, :] * inv_tz[:, None] - (tyv * inv_tz * inv_tz)[:, None] * dT[:, 2, :])

        sample_i, sample_gx, sample_gy = _sample_linear([I1, GX, GY], trv, tcv)
        res_vals = sample_i - I0.ravel()[i_ok]
        rows = sample_gx[:, None] * dtc + sample_gy[:, None] * dtr

        # truncation scatter index from the jet scalar part (…Ceres.h:253-254)
        scatter = (
            np.trunc(trv).astype(np.int64) * nC + np.trunc(tcv).astype(np.int64)
        )
        res = np.zeros(nR * nC)
        jac = np.zeros((nR * nC, 6))
        res[scatter] = res_vals
        jac[scatter] = rows
        return res, jac

    def _solve_level(self, level: int) -> None:
        """Ceres LM trust-region loop under the reference's options."""
        max_iters = int(self.max_iterations[level])
        if max_iters <= 0:
            return
        func_tol = float(self.function_tolerances[level])
        grad_tol = float(self.gradient_tolerances[level])
        param_tol = float(self.parameter_tolerances[level])
        radius = float(self.initial_radii[level])
        max_radius = float(self.max_radii[level])
        min_radius = float(self.min_radii[level])
        min_rel_decrease = float(self.min_relative_decreases[level])

        x = self.state.copy()
        res, jac = self._evaluate(level, x)
        cost = 0.5 * float(res @ res)
        g = jac.T @ res
        g_max0 = float(np.max(np.abs(g))) if np.max(np.abs(g)) > 0 else 1.0
        decrease_factor = 2.0

        for _ in range(max_iters):
            if np.max(np.abs(g)) <= grad_tol * g_max0:
                break
            H = jac.T @ jac
            D = np.clip(np.diag(H), 1e-12, 1e64)  # (min_lm_diagonal^2, max^2)
            try:
                step = np.linalg.solve(H + np.diag(D) / radius, -g)
            except np.linalg.LinAlgError:
                break
            model_cost_change = -(step @ g + 0.5 * step @ (H @ step))
            if not np.isfinite(model_cost_change) or model_cost_change <= 0:
                break  # max_num_consecutive_invalid_steps = 0 (…Ceres.h:477)
            x_new = x + step
            res_new, jac_new = self._evaluate(level, x_new)
            cost_new = 0.5 * float(res_new @ res_new)
            rho = (cost - cost_new) / model_cost_change
            if np.isfinite(cost_new) and rho > min_rel_decrease:
                # accepted (LevenbergMarquardtStrategy::StepAccepted)
                radius = radius / max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                radius = min(radius, max_radius)
                decrease_factor = 2.0
                cost_change = cost - cost_new
                step_norm = float(np.linalg.norm(step))
                x_norm = float(np.linalg.norm(x_new))
                x, res, jac, cost = x_new, res_new, jac_new, cost_new
                g = jac.T @ res
                if abs(cost_change) <= func_tol * cost:
                    break
                if step_norm <= param_tol * (x_norm + param_tol):
                    break
            else:
                radius /= decrease_factor
                decrease_factor *= 2.0
                if radius < min_radius:
                    break
        self.state = x

    def optimize(self) -> np.ndarray:
        for level in range(self.num_levels - 1, -1, -1):
            self._solve_level(level)
        return self.state.copy()


def oracle_for_backend(backend: str, config, **kw):
    """Oracle matching the framework backend name."""
    if backend in ("analytic", "ic", "esm"):
        return AnalyticOracle(config, **kw)
    if backend in ("biobjective", "bi-objective"):
        return BiObjectiveOracle(config, **kw)
    if backend in ("autodiff", "ceres"):
        return CeresOracle(config, **kw)
    raise ValueError(f"no oracle for backend {backend!r}")
