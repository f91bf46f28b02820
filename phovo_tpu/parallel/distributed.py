"""Multi-host initialization and mesh construction (SURVEY §5).

The reference has no distributed runtime at all. Here: standard JAX
multi-controller initialization (one process per host, all devices
visible globally after `initialize()`), then meshes spanning every host's
GPUs. Tracking stays device-local (each GPU aligns its own streams /
batch shard with no communication); only pose-graph/bundle-adjustment
reductions cross devices (psum over NVLink within a host, the network
across hosts).

On a single host this degrades to a no-op initialize + local mesh, so the
same program runs everywhere (the driver's dryrun exercises it with
virtual CPU devices).
"""

from __future__ import annotations

import jax

from phovo_tpu.parallel.mesh import make_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed when running multi-process.

    With no arguments, relies on the cluster environment (SLURM /
    manual env vars) exactly like jax.distributed.initialize; a
    single-process run (num_processes in (None, 1) and no coordinator)
    skips initialization entirely.
    """
    if coordinator_address is None and (num_processes in (None, 1)):
        # single-process: nothing to do unless an env-configured cluster
        # exists, in which case the user calls jax.distributed directly.
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(pixel_parallel: int = 1):
    """Mesh over ALL global devices (call after initialize())."""
    return make_mesh(len(jax.devices()), pixel_parallel=pixel_parallel)


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this process's shard of a globally-sharded batch."""
    n = jax.process_count()
    idx = jax.process_index()
    per = global_batch // n
    return idx * per, per
