"""CLI: align one RGB-D frame pair (reference app:
apps/PhotoconsistencyFrameAlignment/PhotoconsistencyFrameAlignment.cpp:54-115).

Usage:
    python -m phovo_tpu.apps.phovo_align <config.yml> \
        <source_intensity.png> <source_depth.png> \
        <target_intensity.png> <target_depth.png> \
        [--backend analytic|ceres|biobjective|ic] [--intrinsics default|fr1|fr2|fr3]
        [--depth-scale 0.001] [--save-diff diff.png]

Backend is selected at runtime (the reference requires recompiling with
USE_PHOTOCONSISTENCY_ODOMETRY_METHOD, …FrameAlignment.cpp:34-44). Depth PNGs
are scaled by --depth-scale (reference: 1/1000, …cpp:76-80); default
intrinsics K = [525,0,319.5; 0,525,239.5] (…cpp:68-71).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phovo-align", description="Photoconsistency RGB-D frame alignment"
    )
    p.add_argument("config", help="YAML config (native or reference schema)")
    p.add_argument("source_intensity")
    p.add_argument("source_depth")
    p.add_argument("target_intensity")
    p.add_argument("target_depth")
    p.add_argument("--backend", default="analytic",
                   choices=["analytic", "ceres", "autodiff", "biobjective", "ic"])
    p.add_argument("--intrinsics", default="default",
                   help="named preset (default/fr1/fr2/fr3) or 'fx,fy,cx,cy'")
    p.add_argument("--depth-scale", type=float, default=1.0 / 1000.0,
                   help="meters per depth PNG unit (reference: 1/1000)")
    p.add_argument("--save-diff", default=None,
                   help="write |target - warped source| image here (the "
                        "reference's imshow verification, …cpp:107-112)")
    p.add_argument("--save-diff-dir", default=None,
                   help="with visualizeIterations: true in the config, write "
                        "a per-GN-iteration diff PNG into this directory (the "
                        "reference's per-iteration imshow, …Analytic.h:551-557)")
    return p


def parse_intrinsics(spec: str):
    from phovo_tpu.ops.camera import NAMED_INTRINSICS, Intrinsics

    if spec in NAMED_INTRINSICS:
        return NAMED_INTRINSICS[spec]
    vals = [float(v) for v in spec.split(",")]
    if len(vals) != 4:
        raise ValueError("intrinsics must be a preset name or fx,fy,cx,cy")
    return Intrinsics(*(np.float32(v) for v in vals))


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from phovo_tpu.apps._bootstrap import enable_compilation_cache

    enable_compilation_cache()

    import cv2

    from phovo_tpu.models import BACKENDS
    from phovo_tpu.utils.config import load_config

    cfg = load_config(args.config)
    intr = parse_intrinsics(args.intrinsics)

    src_i = cv2.imread(args.source_intensity, cv2.IMREAD_GRAYSCALE)
    tgt_i = cv2.imread(args.target_intensity, cv2.IMREAD_GRAYSCALE)
    src_d = cv2.imread(args.source_depth, cv2.IMREAD_UNCHANGED)
    tgt_d = cv2.imread(args.target_depth, cv2.IMREAD_UNCHANGED)
    for name, img in [
        ("source intensity", src_i), ("target intensity", tgt_i),
        ("source depth", src_d), ("target depth", tgt_d),
    ]:
        if img is None:
            print(f"error: cannot read {name} image", file=sys.stderr)
            return 1
    src_d = src_d.astype(np.float32) * args.depth_scale
    tgt_d = tgt_d.astype(np.float32) * args.depth_scale

    vo = BACKENDS[args.backend](cfg)
    vo.set_intrinsic_matrix(np.asarray(intr.matrix()))
    vo.set_source_frame(src_i, src_d)
    vo.set_target_frame(tgt_i, tgt_d)
    vo.set_initial_state_vector(np.zeros(6, np.float32))

    t0 = time.perf_counter()
    result = vo.optimize()
    state = np.asarray(result.state)
    print(f"Time = {time.perf_counter() - t0} sec.")

    Rt = np.asarray(vo.get_optimal_rigid_transformation_matrix())
    print("state vector (x y z yaw pitch roll):")
    print(state)
    print("Rt:")
    print(Rt)
    print("per-level iterations:", np.asarray(result.iterations))

    if args.save_diff_dir and cfg.visualize_iterations:
        if args.backend in ("analytic", "biobjective"):
            from phovo_tpu.utils.trace import save_iteration_diffs, trace_alignment

            records = trace_alignment(
                src_i, src_d, tgt_i, tgt_d, intr, cfg, backend=args.backend
            )
            paths = save_iteration_diffs(
                records, src_i, src_d, tgt_i, intr, args.save_diff_dir
            )
            print(f"wrote {len(paths)} per-iteration diff images to "
                  f"{args.save_diff_dir}")
        else:
            print(
                f"note: per-iteration trace not supported for backend "
                f"{args.backend!r}; see per-level diagnostics above",
                file=sys.stderr,
            )
    elif args.save_diff_dir:
        print(
            "note: --save-diff-dir needs visualizeIterations: true (or "
            "visualize_iterations: true) in the config",
            file=sys.stderr,
        )

    if args.save_diff:
        import jax.numpy as jnp

        from phovo_tpu.ops.warp import forward_warp

        warped = np.asarray(
            forward_warp(
                jnp.asarray(src_i.astype(np.float32)),
                jnp.asarray(src_d),
                jnp.asarray(state),
                intr,
            )
        )
        diff = np.abs(tgt_i.astype(np.float32) - warped).astype(np.uint8)
        cv2.imwrite(args.save_diff, diff)
        print(f"wrote difference image to {args.save_diff}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
