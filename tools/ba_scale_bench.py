"""Dense-W vs sparse-W Schur bundle adjustment scale bench.

VERDICT r1 item 7's acceptance run: a 50k-observation / 10k-landmark window
must optimize on chip WITHOUT materializing the dense (M, P, 6, 3) W, plus
a dense-vs-sparse crossover table (the analog of pose_graph.py's CG-vs-
dense table).

Usage: python -m tools.ba_scale_bench [--repeats 3] [--out artifacts/ba_scale.json]

Each row: problem size, per-optimize wall (5 LM iterations, warm), the
dense-W footprint that the sparse path avoids, and the device (JAX
platform/kind/count; the card's name and power limit print first). Dense cases that exceed a
footprint guard are skipped rather than risking a device OOM mid-bench.
"""

from __future__ import annotations

import argparse
import json
import time

import jax

from phovo_tpu.apps._bootstrap import enable_compilation_cache

enable_compilation_cache()

import numpy as np

from phovo_tpu.ops.camera import TUM_DEFAULT
from phovo_tpu.parallel.bundle_adjustment import (
    build_schur_pairs, make_synthetic_ba, optimize_bundle,
)

# (n_poses, n_points, obs_per_pose): obs_per_pose=None -> dense visibility
# (K = M*P, every pose sees every landmark — the keyframe-window regime);
# an integer -> SPARSE visibility (each pose observes a random subset — the
# map-scale regime where dense W = M*P*18 floats decouples from K and
# becomes the memory wall the sparse segment-sum path exists to remove).
CASES = [
    (8, 500, None),
    (8, 2000, None),
    (8, 6000, None),
    (5, 10_000, None),   # K = 50k obs / 10k landmarks — the acceptance case
    (8, 10_000, None),
    (64, 20_000, 1000),   # K = 64k sparse; dense W ~184 MB
    (128, 50_000, 800),   # K = 102k sparse; dense W ~922 MB
    (256, 100_000, 500),  # K = 128k sparse; dense W ~3.7 GB -> dense skipped
]
DENSE_W_GUARD = 1.5e9  # skip dense beyond ~1.5 GB of W + WVinv intermediates


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from phovo_tpu.utils.device import print_device

    dev = print_device()
    rows = []
    for M, P, opp in CASES:
        problem, gt_states, _ = make_synthetic_ba(
            n_poses=M, n_points=P, state_noise=0.01, point_noise=0.01,
            obs_per_pose=opp, seed=0,
        )
        K = int(problem.obs_pose.shape[0])
        pa, _ = build_schur_pairs(problem.obs_pose, problem.obs_point)
        dense_w_bytes = 2 * M * P * 18 * 4  # W + WVinv intermediate
        row = {
            "n_poses": M, "n_points": P, "observations": K,
            "visibility": "dense" if opp is None else f"sparse({opp}/pose)",
            "schur_pairs": int(pa.shape[0]),
            "dense_W_MB": round(dense_w_bytes / 1e6, 1),
            "device": dev,
        }
        for mode in ("dense", "sparse"):
            if mode == "dense" and dense_w_bytes > DENSE_W_GUARD:
                row["dense_s"] = None
                row["dense_note"] = "skipped (W footprint over guard)"
                continue
            try:
                s, p, c = optimize_bundle(
                    problem, TUM_DEFAULT, iterations=args.iterations,
                    schur=mode,
                )
                jax.block_until_ready(s)
                t0 = time.perf_counter()
                for _ in range(args.repeats):
                    s, p, c = optimize_bundle(
                        problem, TUM_DEFAULT, iterations=args.iterations,
                        schur=mode,
                    )
                jax.block_until_ready(s)
                dt = (time.perf_counter() - t0) / args.repeats
                err = float(
                    np.linalg.norm(np.asarray(s) - np.asarray(gt_states))
                )
                row[f"{mode}_s"] = round(dt, 4)
                row[f"{mode}_state_err"] = round(err, 5)
            except Exception as e:  # noqa: BLE001 - record and continue
                row[f"{mode}_s"] = None
                row[f"{mode}_note"] = f"{type(e).__name__}: {e}"[:200]
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
