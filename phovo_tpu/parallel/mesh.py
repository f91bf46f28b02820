"""Device-mesh construction and sharding helpers.

The reference is single-process/single-thread (SURVEY §2: its only
parallelism is compile-time-disabled OpenMP over pixel rows). The
parallelism model replacing it:

  axis "data"  — frame pairs (batched odometry / multi-sequence serving);
                 the DP axis.
  axis "pixel" — image rows of one frame (sharded normal-equation
                 reduction, the analog of the reference's OpenMP
                 row-parallelism); the SP axis. Collectives: one psum of
                 {JtJ (21 unique), Jtr (6), cost, count} per GN iteration —
                 a few hundred bytes (NVLink between the GPUs of a host).

Pose-graph optimization shards constraints over the flattened mesh
(parallel/pose_graph.py). The GPUs of a host are joined all to all, so the
mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
PIXEL_AXIS = "pixel"


def make_mesh(
    n_devices: int | None = None,
    pixel_parallel: int = 1,
    devices=None,
) -> Mesh:
    """Mesh of shape (data, pixel) over the first n devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % pixel_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by pixel_parallel={pixel_parallel}"
        )
    grid = np.asarray(devices[:n_devices]).reshape(
        n_devices // pixel_parallel, pixel_parallel
    )
    return Mesh(grid, (DATA_AXIS, PIXEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a (B, H, W) batch of images: batch over data, rows over pixel."""
    return NamedSharding(mesh, P(DATA_AXIS, PIXEL_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
