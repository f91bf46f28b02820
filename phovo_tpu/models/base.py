"""Backend-independent alignment API.

Mirrors the reference's abstract optimizer interface — the central API of the
whole library (CPhotoconsistencyOdometry.h:137-179: SetIntrinsicMatrix,
SetSourceFrame, SetTargetFrame, SetInitialStateVector, Optimize,
GetOptimalStateVector, GetOptimalRigidTransformationMatrix) plus
ReadConfigurationFile / SetMinDepth / SetMaxDepth from the concrete backends.

The object API below is a thin host-side wrapper holding frames; the
actual work is one jitted functional `align` per (backend, config, image
shape), cached, that runs pyramids + all pyramid levels + all solver
iterations as a single XLA program. Backend selection is
a runtime string, not a compile-time #define
(cf. PhotoconsistencyVisualOdometry.cpp:34-44).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.utils.config import PhovoConfig, load_config


class AlignmentResult(NamedTuple):
    """Output of one frame-pair alignment, with per-level diagnostics.

    The structured diagnostics replace the reference's conditional stdout
    prints (…Analytic.h:394-423) — returned from the jitted solver and
    loggable host-side without recompilation.
    """

    state: jax.Array  # (6,) [x, y, z, yaw, pitch, roll]
    iterations: jax.Array  # (L,) int32 per level (level 0 first)
    gradient_norm: jax.Array  # (L,) final ||J^T r|| (GN) / inf-norm (LM)
    cost: jax.Array  # (L,) final cost per level
    num_valid: jax.Array  # (L,) valid-pixel count per level

    def transform(self) -> jax.Array:
        return se3.pose_matrix(self.state)


def as_float_intensity(img) -> np.ndarray:
    """Normalize intensity input for the aligners: uint8 passes through
    UNCHANGED (every backend converts u8 -> f32 * 1/255 on device — the
    reference SetSourceFrame conversion, …Analytic.h:470-471 — so the
    host->device transfer stays at storage size, 4x smaller than f32);
    other integer dtypes convert host-side; floats become float32. Device
    arrays pass through untouched (no eager dispatch)."""
    if isinstance(img, jax.Array):
        return img
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.float32) * np.float32(1.0 / 255.0)
    return arr.astype(np.float32)


def device_unit_intensity(img: jax.Array) -> jax.Array:
    """The on-device half of as_float_intensity: uint8 -> float32 * (1/255)
    inside the jitted aligner (the reference SetSourceFrame conversion,
    …Analytic.h:470-471); float inputs pass through. Every backend routes
    its intensity inputs through here so the unit convention lives in one
    place."""
    if img.dtype == jnp.uint8:
        return img.astype(jnp.float32) * (1.0 / 255.0)
    return img


def _as_float_depth(depth) -> np.ndarray:
    if isinstance(depth, jax.Array):
        return depth.astype(jnp.float32)
    return np.asarray(depth, dtype=np.float32)


def align_chain(
    prep_frame, align_prepped, intensities, depths, intr, config,
    warm_start: bool, batched: bool,
):
    """Align all consecutive pairs of a buffered frame segment.

    prep_frame(intensity, depth, intr, config) builds one frame's per-level
    products (pyramids, gradients, packs). It runs ONCE per frame, vmapped
    over the segment: every interior frame is the target of pair k-1 and
    the source of pair k.

    align_prepped(src, tgt, intr, init_state, config) runs the coarse-to-fine
    solve of one pair from two frames' products.

    batched=True solves all pairs as one batch: jax.vmap of align_prepped,
    so every pyramid level advances all pairs in lockstep. A vmapped
    while_loop keeps each pair's own freeze and iteration count and runs
    until the slowest pair stops. batched=False scans the pairs in order
    (lax.scan), which a warm start needs: each pair starts from the
    previous pair's state (the reference always starts from zero, …cpp:224).

    Returns batched results with leading dim B-1 (pair k aligns frame k ->
    k+1)."""
    intensities = device_unit_intensity(intensities).astype(jnp.float32)
    depths = jnp.asarray(depths, jnp.float32)
    prep = jax.vmap(lambda i, d: prep_frame(i, d, intr, config))(
        intensities, depths
    )
    src = jax.tree.map(lambda a: a[:-1], prep)
    tgt = jax.tree.map(lambda a: a[1:], prep)
    zero = jnp.zeros(6, jnp.float32)
    if batched:
        B = intensities.shape[0] - 1
        return jax.vmap(
            lambda s, t, x: align_prepped(s, t, intr, x, config)
        )(src, tgt, jnp.zeros((B, 6), jnp.float32))

    def step(carry, pair):
        s, t = pair
        init = carry if warm_start else zero
        res = align_prepped(s, t, intr, init, config)
        return res.state, res

    _, results = jax.lax.scan(step, zero, (src, tgt))
    return results


def stack_levels(diags) -> AlignmentResult:
    """AlignmentResult from per-level (state, iterations, gradient_norm,
    cost, num_valid) diagnostics, level 0 first; the state is the finest
    level's."""
    return AlignmentResult(
        state=diags[0][0],
        iterations=jnp.stack([jnp.asarray(d[1], jnp.int32) for d in diags]),
        gradient_norm=jnp.stack(
            [jnp.asarray(d[2], jnp.float32) for d in diags]
        ),
        cost=jnp.stack([jnp.asarray(d[3], jnp.float32) for d in diags]),
        num_valid=jnp.stack([jnp.asarray(d[4], jnp.float32) for d in diags]),
    )


def chunk_device_prep(
    carry_intensity, carry_depth, intensities, depths, depth_scale
):
    """Storage-dtype conversion + device-side carry prepend shared by the
    chunked (streaming) sequence entries: per chunk the host transfers only
    the new frames in storage dtype (uint8 intensity, uint16 depth counts),
    the carry frame (last frame of the previous chunk) stays device-resident.
    Returns (I (B+1,H,W) float32, D (B+1,H,W) float32 metric)."""
    if depth_scale is not None and depths.dtype != jnp.float32:
        depths = depths.astype(jnp.float32) * jnp.float32(depth_scale)
    intensities = device_unit_intensity(intensities).astype(jnp.float32)
    carry_f = device_unit_intensity(carry_intensity).astype(jnp.float32)
    I = jnp.concatenate([carry_f[None], intensities])
    D = jnp.concatenate([carry_depth.astype(jnp.float32)[None], depths])
    return I, D


class PhotoconsistencyOdometryBase:
    """Host-side stateful wrapper over the functional aligners."""

    # AlignmentResult.cost convention: GN backends report sum r^2; the
    # trust-region backend overrides this (0.5 * sum r^2, the Ceres
    # convention). Consumers comparing costs across backends (e.g. the
    # keyframe loop-closure gate) must normalize by it.
    COST_IS_HALF_SUM_SQ = False

    def __init__(self, config: PhovoConfig | None = None):
        self.config = config or PhovoConfig()
        self.intrinsics: Intrinsics | None = None
        self._source = None  # (intensity, depth) float32 device arrays
        self._target = None
        self._init_state = jnp.zeros(6, dtype=jnp.float32)
        self._result: AlignmentResult | None = None

    # -- reference API surface ------------------------------------------------
    def read_configuration_file(self, path) -> None:
        self.config = load_config(path)

    def set_intrinsic_matrix(self, K) -> None:
        self.intrinsics = Intrinsics.from_matrix(jnp.asarray(K, dtype=jnp.float32))

    def set_min_depth(self, d: float) -> None:
        import dataclasses

        self.config = dataclasses.replace(self.config, min_depth=float(d))

    def set_max_depth(self, d: float) -> None:
        import dataclasses

        self.config = dataclasses.replace(self.config, max_depth=float(d))

    def set_source_frame(self, intensity, depth) -> None:
        self._source = (as_float_intensity(intensity), _as_float_depth(depth))

    def set_target_frame(self, intensity, depth) -> None:
        self._target = (as_float_intensity(intensity), _as_float_depth(depth))

    def set_initial_state_vector(self, state) -> None:
        self._init_state = jnp.asarray(state, dtype=jnp.float32)

    def optimize(self) -> AlignmentResult:
        if self.intrinsics is None:
            raise RuntimeError("set_intrinsic_matrix must be called before optimize")
        if self._source is None or self._target is None:
            raise RuntimeError("source and target frames must be set before optimize")
        self._result = self.align(
            self._source[0], self._source[1],
            self._target[0], self._target[1],
            self.intrinsics, self._init_state,
        )
        return self._result

    def get_optimal_state_vector(self) -> jax.Array:
        self._require_result()
        return self._result.state

    def get_optimal_rigid_transformation_matrix(self) -> jax.Array:
        self._require_result()
        return se3.pose_matrix(self._result.state)

    def _require_result(self):
        if self._result is None:
            raise RuntimeError("optimize() has not been called")

    # -- functional core (implemented by backends) ----------------------------
    def align(
        self,
        source_intensity: jax.Array,
        source_depth: jax.Array,
        target_intensity: jax.Array,
        target_depth: jax.Array,
        intr: Intrinsics,
        init_state: jax.Array,
    ) -> AlignmentResult:
        raise NotImplementedError
