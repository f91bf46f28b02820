"""CLI: full-sequence visual odometry over a TUM RGB-D dataset directory
(reference app: apps/PhotoconsistencyVisualOdometry/
PhotoconsistencyVisualOdometry.cpp:119-267).

Usage:
    python -m phovo_tpu.apps.phovo_vo --config cfg.yml --dataset /path/to/tum \
        --output trajectory.txt [--backend analytic] [--intrinsics fr1]
        [--pairing associate|lockstep] [--warm-start] [--max-frames N]
        [--checkpoint ckpt.json] [--resume] [--eval-gt groundtruth.txt]

Writes a TUM-format trajectory ('timestamp tx ty tz qx qy qz qw'). Defaults
mirror the reference: fr1 intrinsics (…cpp:170-173), depth scale 1/5000
(…cpp:163), cold start per pair (…cpp:224). --pairing associate and
--warm-start are improvements the reference lacks; --eval-gt runs the
in-tree ATE/RPE evaluation after the run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phovo-vo", description="Photoconsistency visual odometry (TUM RGB-D)"
    )
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--dataset", "-d", required=True,
                   help="TUM sequence dir containing rgb.txt/depth.txt")
    p.add_argument("--output", "-o", required=True, help="output trajectory file")
    p.add_argument("--backend", default="analytic",
                   choices=["analytic", "ceres", "autodiff", "biobjective", "ic"])
    p.add_argument("--intrinsics", default="fr1",
                   help="named preset (default/fr1/fr2/fr3) or 'fx,fy,cx,cy'")
    p.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
    p.add_argument("--pairing", default="associate", choices=["associate", "lockstep"])
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python", "raw"],
                   help="dataset pipeline: the C++ decode-ahead loader "
                        "(native/libphovo_io.so), the Python/cv2 one, the "
                        "zero-decode raw memmap replay (phovo-convert output; "
                        "auto-detected by meta.json), or auto")
    p.add_argument("--warm-start", action="store_true",
                   help="initialize each pair from the previous relative pose")
    p.add_argument("--mode", default="frame", choices=["frame", "keyframe"],
                   help="frame: reference-style frame-to-frame chaining; "
                        "keyframe: track against keyframes with loop closure "
                        "and a final pose-graph optimization")
    p.add_argument("--chunk", type=int, default=1,
                   help="buffer N frames and align all consecutive pairs in "
                        "one device program (every backend; zero-init pairs "
                        "solve as one batch; in keyframe mode: chunked "
                        "tracking, analytic and ceres) — amortizes the "
                        "per-dispatch latency")
    p.add_argument("--ba-iterations", type=int, default=0,
                   help="keyframe mode: after the pose graph, refine sliding "
                        "keyframe windows with photometric bundle adjustment "
                        "for N Gauss-Newton iterations (0 = off)")
    p.add_argument("--ba-window", type=int, default=8,
                   help="keyframe window size for photometric BA")
    p.add_argument("--ba-scope", default="window",
                   choices=["window", "global"],
                   help="photometric BA scope: sliding windows (dense-Schur "
                        "scale) or ONE joint problem over all keyframes with "
                        "covisibility-limited observations (map scale; the "
                        "auto Schur router flips to the sparse path when "
                        "dense W would not fit)")
    p.add_argument("--ba-covis", type=int, default=6,
                   help="global BA: observations per landmark (nearest "
                        "keyframes by camera center)")
    p.add_argument("--export-map", default=None,
                   help="keyframe mode with --ba-iterations > 0: write the "
                        "BA-refined sparse landmark map as an ASCII PLY "
                        "point cloud (grayscale vertex colors from the "
                        "landmarks' host intensities)")
    p.add_argument("--ba-grid", type=int, default=8,
                   help="landmarks per keyframe = grid*grid (one per cell "
                        "at the cell's highest-gradient valid-depth pixel)")
    p.add_argument("--ba-occlusion-gate", type=float, default=0.3,
                   help="keyframe mode: drop BA observations whose predicted"
                        "-vs-measured depth disagree by more than this many "
                        "meters (the landmark is occluded in that frame — "
                        "its rows are garbage, not noise); 0 disables")
    p.add_argument("--ba-z-robust-delta", type=float, default=0.02,
                   help="keyframe mode: Huber delta (METERS) for the BA "
                        "depth rows (caps heavy-tailed depth-interpolation "
                        "error near edges that survives the occlusion "
                        "gate); 0 disables")
    p.add_argument("--ba-robust-delta", type=float, default=0.1,
                   help="keyframe mode: Huber IRLS delta for the photometric "
                        "BA refinement (caps occluded/edge-contaminated "
                        "observations, which otherwise dominate the "
                        "quadratic cost and corrupt poses; 0 disables)")
    p.add_argument("--pg-solver", default="auto",
                   choices=["auto", "dense", "cg"],
                   help="keyframe mode: pose-graph solver — dense block "
                        "Hessian (exact, right for windows), matrix-free "
                        "block-Jacobi PCG (O(M+K) memory/traffic, right for "
                        "map-scale graphs), or auto (dense for <=192 "
                        "keyframes)")
    p.add_argument("--pg-incremental", type=int, default=0,
                   help="keyframe mode: re-solve the pose graph and rebase "
                        "keyframe poses every N promotions (closures fold "
                        "in as they arrive instead of once at finalize; "
                        "0 = batch-only)")
    p.add_argument("--kf-translation", type=float, default=0.15,
                   help="keyframe mode: promote a new keyframe beyond this "
                        "tracked translation (meters)")
    p.add_argument("--kf-rotation", type=float, default=0.15,
                   help="keyframe mode: promote a new keyframe beyond this "
                        "tracked rotation (radians, euler norm)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--checkpoint", default=None, help="checkpoint JSON path")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--eval-gt", default=None,
                   help="TUM groundtruth.txt to evaluate ATE/RPE against")
    p.add_argument("--metrics", default=None,
                   help="write per-frame JSONL metrics to this file")
    p.add_argument("--save-diff-dir", default=None,
                   help="write per-frame |target - warped source| PNGs here "
                        "(the reference's imshow diagnostic, rendered to disk)")
    p.add_argument("--robust-loss", default=None,
                   choices=["none", "huber", "cauchy", "tukey", "tdist"],
                   help="override the config's robust loss (occlusion/"
                        "dynamic-object outlier handling; ops/robust.py)")
    p.add_argument("--robust-delta", type=float, default=None,
                   help="override the config's robust loss delta "
                        "(residual units, intensity 0..1)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


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

    from pathlib import Path

    from phovo_tpu.apps.phovo_align import parse_intrinsics
    from phovo_tpu.datasets.tum import TUMSequence, prefetch
    from phovo_tpu.models import BACKENDS
    from phovo_tpu.models.sequence import Checkpoint, VisualOdometryPipeline
    from phovo_tpu.utils.config import load_config
    from phovo_tpu.utils.trajectory import (
        TrajectoryWriter,
        absolute_trajectory_error,
        read_trajectory,
        relative_pose_error,
    )

    from phovo_tpu.utils.config import override_config

    cfg = override_config(
        load_config(args.config),
        robust_loss=args.robust_loss, robust_delta=args.robust_delta,
    )
    intr = parse_intrinsics(args.intrinsics)

    from phovo_tpu.datasets import native_loader
    from phovo_tpu.datasets import raw as raw_ds

    use_raw = args.loader == "raw" or (
        args.loader == "auto" and raw_ds.is_raw_dir(args.dataset)
    )
    use_native = not use_raw and (
        args.loader == "native"
        or (args.loader == "auto" and native_loader.available())
    )
    if use_raw:
        seq = raw_ds.RawSequence(args.dataset)
        # the raw layout bakes depth scale and pairing in at conversion time
        if abs(seq.depth_scale - args.depth_scale) > 1e-12:
            print(
                f"note: raw replay uses depth scale {seq.depth_scale} from "
                f"meta.json (--depth-scale {args.depth_scale} ignored; "
                "re-run phovo-convert to change it)",
                file=sys.stderr,
            )
        if seq.meta.get("pairing", args.pairing) != args.pairing:
            print(
                f"note: raw replay was converted with "
                f"pairing={seq.meta.get('pairing')} (--pairing ignored)",
                file=sys.stderr,
            )
    elif use_native:
        if not native_loader.available():
            print(
                "error: native loader requested but native/libphovo_io.so is "
                "not built (run `make -C native`)",
                file=sys.stderr,
            )
            return 1
        import os

        seq = native_loader.NativeTUMSequence(
            args.dataset, depth_scale=args.depth_scale, pairing=args.pairing,
            prefetch=max(8, 2 * args.chunk + 2),
            threads=min(8, max(2, (os.cpu_count() or 4) - 2)),
        )
    else:
        seq = TUMSequence(
            args.dataset, depth_scale=args.depth_scale, pairing=args.pairing
        )
    if len(seq) < 2:
        print("error: fewer than 2 paired frames in dataset", file=sys.stderr)
        return 1

    vo = BACKENDS[args.backend](cfg)
    vo.set_intrinsic_matrix(np.asarray(intr.matrix()))

    if args.mode == "keyframe":
        return _run_keyframe_mode(args, vo, seq)
    if args.chunk > 1:
        return _run_chunked(args, cfg, intr, seq)

    pipeline = VisualOdometryPipeline(
        vo, warm_start=args.warm_start, checkpoint_path=args.checkpoint
    )
    if args.resume and args.checkpoint and Path(args.checkpoint).is_file():
        pipeline.resume(Checkpoint.load(args.checkpoint))
        if not args.quiet:
            print(f"resumed at frame {pipeline.frame_index}")

    metrics = None
    if args.metrics:
        from phovo_tpu.utils.profiling import MetricsLogger

        metrics = MetricsLogger(args.metrics)
    diff_dir = None
    if args.save_diff_dir:
        diff_dir = Path(args.save_diff_dir)
        diff_dir.mkdir(parents=True, exist_ok=True)

    # tee the stream so diagnostics can reference the frame pair just aligned
    window: dict = {}

    def tee(stream):
        prev = None
        for f in stream:
            window["prev"], window["cur"] = prev, f
            prev = f
            yield f

    frames = tee(prefetch(iter(seq)))
    n_done = 0
    with TrajectoryWriter(args.output) as out:
        for fr in pipeline.run(frames):
            out.write(fr.timestamp, fr.global_pose)
            n_done += 1
            if not args.quiet:
                print(
                    f"frame {pipeline.frame_index}: {fr.align_seconds:.4f} s, "
                    f"iters {fr.iterations.tolist()}"
                )
            if metrics is not None:
                metrics.log(
                    frame=pipeline.frame_index,
                    timestamp=fr.timestamp,
                    align_seconds=fr.align_seconds,
                    iterations=fr.iterations,
                    relative_state=fr.relative_state,
                )
            if diff_dir is not None and window.get("prev") is not None:
                from phovo_tpu.utils.viz import alignment_diff, save_image

                diff = alignment_diff(
                    window["prev"].intensity, window["prev"].depth,
                    window["cur"].intensity, fr.relative_state, intr,
                )
                # diff inherits the frames' range: u8 storage -> 0..255
                save_image(
                    diff_dir / f"diff_{pipeline.frame_index:06d}.png", diff,
                    unit_range=(
                        np.asarray(window["prev"].intensity).dtype != np.uint8
                        and float(np.asarray(
                            window["prev"].intensity).max()) <= 1.5
                    ),
                )
            if args.max_frames is not None and n_done >= args.max_frames:
                break
    if metrics is not None:
        metrics.close()
    if not args.quiet:
        print(f"wrote {n_done} poses to {args.output}")

    _maybe_eval(args)
    return 0


def _maybe_eval(args) -> None:
    if not args.eval_gt:
        return
    from phovo_tpu.utils.trajectory import (
        absolute_trajectory_error,
        read_trajectory,
        relative_pose_error,
    )

    est = read_trajectory(args.output)
    gt = read_trajectory(args.eval_gt)
    ate = absolute_trajectory_error(est, gt)
    rpe = relative_pose_error(est, gt)
    print(f"ATE rmse: {ate['rmse']:.4f} m (over {ate['num_pairs']} pairs)")
    print(f"RPE rmse: {rpe['trans_rmse']:.4f} m / {rpe['rot_rmse_deg']:.3f} deg")


def _run_chunked(args, cfg, intr, seq) -> int:
    """Buffered sequence processing: chunks of N frames aligned per device
    dispatch via align_sequence_chunk.

    The carry frame (last frame of each chunk) stays DEVICE-resident between
    chunks and chunk assembly happens on device, so per chunk the host moves
    only the new frames, in storage dtype (uint8 intensity, uint16 depth
    counts from the raw format). Pose integration for chunk k runs while
    chunk k+1's transfer+alignment is already dispatched (JAX async
    dispatch) — host work and device work overlap one chunk deep."""
    import time as _time

    import numpy as np_

    from phovo_tpu.datasets.tum import prefetch
    from phovo_tpu.models.analytic import align_sequence_chunk
    from phovo_tpu.models.autodiff import align_sequence_chunk_autodiff
    from phovo_tpu.models.biobjective import align_sequence_chunk_biobjective
    from phovo_tpu.models.ic import align_sequence_chunk_ic
    from phovo_tpu.ops import se3
    from phovo_tpu.utils.trajectory import TrajectoryWriter

    import jax.numpy as jnp

    from pathlib import Path as _Path

    from phovo_tpu.models.sequence import Checkpoint

    if args.save_diff_dir:
        print(
            "note: --save-diff-dir is not supported with --chunk (frames "
            "stream through the device in storage dtype); use --chunk 1",
            file=sys.stderr,
        )

    pose = np_.eye(4)
    n_done = 0
    skip = 0
    if args.resume and args.checkpoint and _Path(args.checkpoint).is_file():
        ck = Checkpoint.load(args.checkpoint)
        pose = np_.asarray(ck.global_pose, np_.float64)
        n_done = skip = int(ck.frame_index)
        out_path = _Path(args.output)
        if out_path.is_file():
            # keep exactly the checkpoint's poses: a crash between the
            # per-chunk checkpoint saves can leave the trajectory up to one
            # chunk ahead, which would duplicate lines after the append
            lines = out_path.read_text().splitlines()
            kept, n_pose = [], 0
            for ln in lines:
                if ln.strip() and not ln.lstrip().startswith("#"):
                    if n_pose >= skip:
                        continue
                    n_pose += 1
                kept.append(ln)
            out_path.write_text("\n".join(kept) + ("\n" if kept else ""))
        if not args.quiet:
            print(f"resumed at frame {n_done}")

    metrics = None
    if args.metrics:
        from phovo_tpu.utils.profiling import MetricsLogger

        metrics = MetricsLogger(args.metrics)

    def integrate(states, timestamps, out, dt):
        nonlocal pose, n_done
        m = len(states)
        for k in range(m):
            Rt = se3.pose_matrix_np(states[k])
            pose = pose @ np_.linalg.inv(Rt)
            out.write(timestamps[k], pose)
            n_done += 1
            if metrics is not None:
                metrics.log(
                    frame=n_done,
                    timestamp=timestamps[k],
                    align_seconds=dt / m,
                    relative_state=states[k],
                )
            if args.max_frames is not None and n_done >= args.max_frames:
                if args.checkpoint:
                    Checkpoint(n_done, pose, np_.asarray(states[k])).save(
                        args.checkpoint
                    )
                return True
        if args.checkpoint:
            Checkpoint(n_done, pose, np_.asarray(states[-1])).save(
                args.checkpoint
            )
        if not args.quiet:
            print(
                f"chunk of {m} pairs: {dt:.4f} s "
                f"({m / dt:.1f} pairs/s)"
            )
        return False

    depth_scale = None  # depth already metric float32 unless the seq says so
    if getattr(seq, "depth_dtype", np_.float32) == np_.uint16:
        depth_scale = float(seq.depth_scale)

    def chunk_stream():
        """Yield (I_new (m,H,W) storage dtype, D_new, timestamps (m,)).

        On --resume, `skip` already-processed frames are discarded first so
        the priming (carry) frame is the last frame the checkpoint covered.
        """
        if hasattr(seq, "read_chunk"):
            if hasattr(seq, "height"):  # random-access (raw replay)
                H, W = seq.height, seq.width
                left = skip
                while left > 0:
                    Ii, _, _ = seq.read_chunk(min(left, args.chunk), H, W)
                    if len(Ii) == 0:
                        return
                    left -= len(Ii)
                Ii, Dd, ts = seq.read_chunk(1, H, W)
                if len(Ii) == 0:
                    return
                yield (Ii, Dd, None)  # priming frame
            else:  # streaming (native decode pool): prime by iteration
                # (native frames carry metric float32 depth — only the raw
                # replay stores uint16 counts, and it is random-access)
                it = iter(seq)
                first = None
                for _ in range(skip + 1):
                    first = next(it, None)
                    if first is None:
                        return
                H, W = first.intensity.shape
                yield (first.intensity[None], first.depth[None], None)
            while True:
                Ii, Dd, ts = seq.read_chunk(args.chunk, H, W)
                if len(Ii) == 0:
                    return
                yield (Ii, Dd, ts)
        else:
            frames = prefetch(iter(seq))
            first = None
            for _ in range(skip + 1):
                first = next(frames, None)
                if first is None:
                    return
            yield (
                np_.asarray(first.intensity)[None],
                np_.asarray(first.depth, np_.float32)[None],
                None,
            )
            while True:
                chunk = []
                for fr in frames:
                    chunk.append(fr)
                    if len(chunk) >= args.chunk:
                        break
                if not chunk:
                    return
                yield (
                    np_.stack([np_.asarray(f.intensity) for f in chunk]),
                    np_.stack([np_.asarray(f.depth, np_.float32) for f in chunk]),
                    [f.timestamp for f in chunk],
                )

    with TrajectoryWriter(args.output, append=skip > 0) as out:
        stream = chunk_stream()
        prime = next(stream, None)
        if prime is None:
            return 0
        I0, D0, _ = prime
        carry_i = jnp.asarray(I0[0]).astype(jnp.float32)
        if I0.dtype == np_.uint8:
            carry_i = carry_i * (1.0 / 255.0)
        carry_d = jnp.asarray(D0[0]).astype(jnp.float32)
        if depth_scale is not None and D0.dtype == np_.uint16:
            carry_d = carry_d * jnp.float32(depth_scale)
        pending = None  # (device states, timestamps, t_start)
        # every backend ships a chunked sequence entry; they share the
        # (carry_i, carry_d, I, D, intr, cfg, <backend static>, warm_start,
        # depth_scale) signature, with the backend-specific static defaulted
        # here ('ceres'/'autodiff' uses its production linearizer mode)
        chunk_fn = {
            "analytic": align_sequence_chunk,
            "ic": align_sequence_chunk_ic,
            "ceres": align_sequence_chunk_autodiff,
            "autodiff": align_sequence_chunk_autodiff,
            "biobjective": align_sequence_chunk_biobjective,
        }[args.backend]
        backend_static = (
            ("linearizer",) if args.backend in ("ceres", "autodiff") else ()
        )
        try:
            for Ii, Dd, ts in stream:
                t0 = _time.perf_counter()
                m = len(Ii)
                if m < args.chunk:
                    # pad the short trailing chunk by repeating its last
                    # frame: the padded batch reuses the already-compiled
                    # chunk-size program (a second compile for the odd size
                    # costs more than aligning the whole chunk);
                    # the padding pairs align identical frames and their
                    # states are discarded below
                    reps = args.chunk - m
                    Ii = np_.concatenate([Ii, np_.repeat(Ii[-1:], reps, 0)])
                    Dd = np_.concatenate([Dd, np_.repeat(Dd[-1:], reps, 0)])
                res, carry_i, carry_d = chunk_fn(
                    carry_i, carry_d, jnp.asarray(Ii), jnp.asarray(Dd),
                    intr, cfg, *backend_static, args.warm_start,
                    depth_scale if Dd.dtype == np_.uint16 else None,
                )
                if pending is not None:
                    p_res, p_m, p_ts, p_t0 = pending
                    pending = None
                    if integrate(np_.asarray(p_res.state[:p_m]), p_ts, out,
                                 t0 - p_t0):
                        break
                pending = (res, m, ts, t0)
        finally:
            # flush the chunk already aligned even if a later chunk's IO or
            # dispatch raises — the trajectory stays truncated, not holey
            if pending is not None:
                p_res, p_m, p_ts, p_t0 = pending
                integrate(np_.asarray(p_res.state[:p_m]), p_ts, out,
                          _time.perf_counter() - p_t0)
    if metrics is not None:
        metrics.close()
    if not args.quiet:
        print(f"wrote {n_done} poses to {args.output}")
    _maybe_eval(args)
    return 0


def _run_keyframe_mode(args, vo, seq) -> int:
    from phovo_tpu.datasets.tum import prefetch
    from phovo_tpu.models.keyframe import KeyframeVisualOdometry
    from phovo_tpu.utils.trajectory import TrajectoryWriter

    ignored = [
        name for name, on in [
            ("--warm-start", args.warm_start),
            ("--checkpoint", bool(args.checkpoint)),
            ("--metrics", bool(args.metrics)),
            ("--save-diff-dir", bool(args.save_diff_dir)),
        ] if on
    ]
    chunked = args.chunk > 1
    if chunked and args.backend not in ("analytic", "ceres", "autodiff"):
        ignored.append("--chunk")
        chunked = False
    if ignored:
        print(
            f"note: {', '.join(ignored)} not supported in keyframe mode "
            "(tracking is per-frame against the current keyframe; the "
            "back-end state lives in memory until finalize; chunked "
            "tracking needs --backend analytic or ceres)",
            file=sys.stderr,
        )

    import time as _time

    kvo = KeyframeVisualOdometry(
        vo,
        kf_translation=args.kf_translation,
        kf_rotation=args.kf_rotation,
        pg_solver=args.pg_solver,
        pg_incremental=args.pg_incremental,
    )
    # raw replay + chunked tracking: stream STORAGE-dtype frames (uint8
    # intensity, uint16 depth counts as memmap views) and let the tracking
    # dispatch convert on device — halves the host->device depth transfer
    # and removes all host per-pixel work (keyframe-mode analog of the
    # frame-chunked raw path)
    raw_storage = (
        chunked
        and hasattr(seq, "read_chunk")
        and hasattr(seq, "height")
        and getattr(seq, "depth_dtype", np.float32) == np.uint16
    )
    if raw_storage:
        from phovo_tpu.datasets.tum import RGBDFrame

        def storage_stream():
            H, W = seq.height, seq.width
            while True:
                Ii, Dd, ts = seq.read_chunk(args.chunk, H, W)
                if len(Ii) == 0:
                    return
                for k in range(len(Ii)):
                    yield RGBDFrame(
                        timestamp=float(ts[k]),
                        depth_timestamp=float(ts[k]),
                        intensity=Ii[k],
                        depth=Dd[k],
                    )

        stream = kvo.run_chunked(
            storage_stream(), chunk=args.chunk,
            depth_scale=float(seq.depth_scale),
        )
    else:
        stream = (
            kvo.run_chunked(prefetch(iter(seq)), chunk=args.chunk)
            if chunked
            else kvo.run(prefetch(iter(seq)))
        )
    n = 0
    t0 = _time.perf_counter()
    for tf in stream:
        n += 1
        if not args.quiet:
            print(
                f"frame {tf.frame_index}: kf {tf.keyframe_index}, "
                f"iters {tf.align_iterations.tolist()}"
            )
        if args.max_frames is not None and n >= args.max_frames:
            break
    t_track = _time.perf_counter() - t0
    tracked = kvo.finalize(
        ba_iterations=args.ba_iterations,
        ba_window=args.ba_window,
        ba_grid=args.ba_grid,
        ba_robust_delta=args.ba_robust_delta,
        ba_scope=args.ba_scope,
        ba_covis=args.ba_covis,
        ba_occ_gate=args.ba_occlusion_gate,
        ba_z_robust_delta=args.ba_z_robust_delta,
    )
    t_finalize = _time.perf_counter() - t0 - t_track
    ft = getattr(kvo, "finalize_timings", {})
    items = "".join(f", {k} {v:.1f} s" for k, v in ft.items())
    print(
        f"keyframe wall: track {t_track:.1f} s "
        f"({n / max(t_track, 1e-9):.1f} frames/s), "
        f"finalize {t_finalize:.1f} s{items}"
    )
    if kvo.incremental_latencies:
        lat = np.asarray(kvo.incremental_latencies)
        bd = np.asarray(kvo.incremental_breakdown)
        print(
            f"incremental: {len(lat)} solves, per-promotion latency "
            f"min {lat.min():.3f} s / mean {lat.mean():.3f} s / "
            f"p90 {np.percentile(lat, 90):.3f} s "
            f"/ max {lat.max():.3f} s (first {lat[0]:.3f} s); "
            f"breakdown mean build {bd[:, 0].mean():.3f} s "
            f"solve {bd[:, 1].mean():.3f} s rebase {bd[:, 2].mean():.3f} s; "
            f"min build {bd[:, 0].min():.3f} s solve {bd[:, 1].min():.3f} s"
        )
    with TrajectoryWriter(args.output) as out:
        for tf in tracked:
            out.write(tf.timestamp, tf.pose)
    if args.export_map:
        if kvo.map_points is None:
            print(
                "note: --export-map needs --ba-iterations > 0 (the map "
                "landmarks come from the photometric BA); no map written",
                file=sys.stderr,
            )
        else:
            from phovo_tpu.utils.viz import save_ply

            save_ply(args.export_map, kvo.map_points, kvo.map_intensity)
            print(
                f"wrote {len(kvo.map_points)} map landmarks to "
                f"{args.export_map}"
            )
    # one-line run summary, printed even under -q (the driver-facing
    # record of what the back-end actually built)
    print(
        f"wrote {len(tracked)} poses ({len(kvo.keyframes)} keyframes, "
        f"{len(kvo.loop_closures)} loop closures) to {args.output}"
    )
    _maybe_eval(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
