"""Scaling benchmark: data-parallel alignment throughput vs device count.

Weak scaling: per device count N, a batch of N * pairs_per_device frame
pairs is sharded over the mesh 'data' axis and aligned repeatedly;
efficiency(N) = throughput(N) / (N * throughput(1)). Tracking is
communication-free under data parallelism (each pair lives on one device,
parallel/batch.py), so the efficiency loss is dispatch overhead alone.

    python bench_scaling.py                    # all power-of-2 mesh sizes
    python bench_scaling.py --devices 1,2,4    # specific sizes
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench_scaling.py --shape 96,128  # virtual-mesh validation

The virtual CPU mesh validates the harness and the sharding only: its
devices share the host's cores, so its "efficiency" is not a hardware
measurement. The second mode measures one device's batch-size scaling at
N=1 (how much a single dispatch amortizes with more pairs per batch); the
third, multi-stream serving (make_multi_sequence_server).

Prints the device (platform, kind, count, and the card's name and power
limit) and then one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", default=None,
                   help="comma-separated mesh sizes (default: 1,2,4,... up to all)")
    p.add_argument("--pairs-per-device", type=int, default=4)
    p.add_argument("--shape", default="480,640")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--batch-sizes", default="1,2,4,8,16",
                   help="single-device batch sweep (second mode)")
    p.add_argument("--skip-batch-sweep", action="store_true")
    p.add_argument("--streams", default="1,2,4,8",
                   help="multi-sequence serving sweep: streams per dispatch")
    p.add_argument("--frames-per-stream", type=int, default=16)
    p.add_argument("--skip-serve-sweep", action="store_true")
    return p.parse_args()


def main() -> int:
    args = parse_args()
    import jax

    from phovo_tpu.apps._bootstrap import enable_compilation_cache
    from phovo_tpu.utils.device import print_device

    print_device()
    enable_compilation_cache()
    import jax.numpy as jnp

    from phovo_tpu.ops.camera import TUM_FR1
    from phovo_tpu.parallel.batch import make_data_parallel_aligner
    from phovo_tpu.parallel.mesh import make_mesh
    from phovo_tpu.utils.config import PhovoConfig
    from phovo_tpu.utils.synthetic import make_pair

    H, W = (int(x) for x in args.shape.split(","))
    n_avail = len(jax.devices())
    if args.devices:
        sizes = [int(x) for x in args.devices.split(",")]
    else:
        sizes = []
        n = 1
        while n <= n_avail:
            sizes.append(n)
            n *= 2

    cfg = PhovoConfig(
        num_levels=5,
        blur_filter_sizes=(0,) * 5,
        gradient_scales=(0.0625,) * 5,
        max_iterations=(0, 0, 5, 20, 50),
        lambda_steps=(1.0,) * 5,
        min_gradient_norms=(0.0,) * 5,
        sampling="nearest",
    )
    intr = TUM_FR1 if (H, W) == (480, 640) else None
    if intr is None:
        from phovo_tpu.ops.camera import Intrinsics

        intr = Intrinsics(
            np.float32(W), np.float32(W),
            np.float32(W / 2 - 0.5), np.float32(H / 2 - 0.5),
        )
    I0, D0, I1, D1, _ = make_pair(intr, shape=(H, W))

    def batch_of(n_pairs):
        rep = lambda a: jnp.asarray(np.broadcast_to(a, (n_pairs, H, W)).copy())
        return rep(I0), rep(D0), rep(I1), rep(D1)

    def time_aligner(align, batch, init):
        res = align(*batch, intr, init)
        jax.block_until_ready(res.state)
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            res = align(*batch, intr, init)
        jax.block_until_ready(res.state)
        return (time.perf_counter() - t0) / args.repeats

    # --- weak scaling over mesh sizes -------------------------------------
    results = []
    for n in sizes:
        if n > n_avail:
            print(f"# skipping N={n}: only {n_avail} devices")
            continue
        mesh = make_mesh(n)
        align = make_data_parallel_aligner(mesh, cfg)
        B = n * args.pairs_per_device
        batch = batch_of(B)
        init = jnp.zeros((B, 6), jnp.float32)
        dt = time_aligner(align, batch, init)
        pairs_s = B / dt
        results.append((n, pairs_s))
        # normalize by per-device throughput of the FIRST measurement so an
        # explicit --devices list not starting at 1 still reports correctly
        base_per_dev = results[0][1] / results[0][0]
        eff = (pairs_s / n) / base_per_dev
        print(json.dumps({
            "mode": "weak_scaling", "devices": n, "batch": B,
            "pairs_per_s": round(pairs_s, 2), "efficiency": round(eff, 4),
            "platform": jax.devices()[0].platform,
        }))

    # --- single-device batch-size sweep ------------------------------------
    if not args.skip_batch_sweep:
        mesh = make_mesh(1)
        align = make_data_parallel_aligner(mesh, cfg)
        for B in (int(x) for x in args.batch_sizes.split(",")):
            batch = batch_of(B)
            init = jnp.zeros((B, 6), jnp.float32)
            dt = time_aligner(align, batch, init)
            print(json.dumps({
                "mode": "batch_sweep", "devices": 1, "batch": B,
                "pairs_per_s": round(B / dt, 2),
                "platform": jax.devices()[0].platform,
            }))

    # --- multi-sequence serving sweep ---------------------------------------
    # The production "many cameras per chip" shape: S streams of T frames per
    # dispatch (parallel/batch.py make_multi_sequence_server). Throughput is
    # aligned pairs/s = S*(T-1)/dispatch; each stream also gets its global
    # trajectory integrated on device.
    if not args.skip_serve_sweep:
        import dataclasses

        from phovo_tpu.parallel.batch import make_multi_sequence_server

        T = args.frames_per_stream
        seq_I = jnp.stack(
            [jnp.asarray(I0 if k % 2 == 0 else I1) for k in range(T)]
        )
        seq_D = jnp.stack(
            [jnp.asarray(D0 if k % 2 == 0 else D1) for k in range(T)]
        )
        mesh = make_mesh(1)
        # Both serving methodologies, first-class (VERDICT r2 item 5):
        #   fixed      — min_gradient_norm 0, every pair runs the full 75
        #                iterations (identical work; baseline-comparable)
        #   early_exit — the shipped presets' gradient-norm termination
        #                (min_gradient_norm 300): the DEPLOYMENT semantics.
        # p50/p99 are per-DISPATCH latencies (one dispatch = S streams x
        # T-1 pairs): the serving path's chunk-level latency distribution.
        cfg_ee = dataclasses.replace(cfg, min_gradient_norms=(300.0,) * 5)
        for semantics, c in (("fixed", cfg), ("early_exit", cfg_ee)):
            serve = make_multi_sequence_server(mesh, c)
            for S in (int(x) for x in args.streams.split(",")):
                Is = jnp.asarray(np.broadcast_to(seq_I, (S, T, H, W)).copy())
                Ds = jnp.asarray(np.broadcast_to(seq_D, (S, T, H, W)).copy())
                _, poses = serve(Is, Ds, intr)
                jax.block_until_ready(poses)
                # throughput: pipelined (async dispatch, one final sync) —
                # the steady-state serving rate where dispatch k+1 is
                # issued while k computes
                t0 = time.perf_counter()
                for _ in range(args.repeats):
                    _, poses = serve(Is, Ds, intr)
                jax.block_until_ready(poses)
                dt = (time.perf_counter() - t0) / args.repeats
                # latency: blocking per dispatch — what one chunk of one
                # camera set actually waits start-to-result (includes the
                # host<->device round trip a pipelined loop hides)
                lat = []
                for _ in range(args.repeats):
                    t1 = time.perf_counter()
                    _, poses = serve(Is, Ds, intr)
                    jax.block_until_ready(poses)
                    lat.append(time.perf_counter() - t1)
                lat = np.asarray(lat)
                pairs = S * (T - 1)
                print(json.dumps({
                    "mode": "serve_sweep", "semantics": semantics,
                    "streams": S, "frames_per_stream": T,
                    "pairs_per_s": round(pairs / dt, 2),
                    "per_stream_fps": round((T - 1) / dt, 2),
                    "dispatch_p50_ms": round(
                        float(np.percentile(lat, 50)) * 1e3, 2
                    ),
                    "dispatch_p99_ms": round(
                        float(np.percentile(lat, 99)) * 1e3, 2
                    ),
                    "platform": jax.devices()[0].platform,
                }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
