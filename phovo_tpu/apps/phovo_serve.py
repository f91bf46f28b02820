"""CLI: multi-camera visual odometry serving — S RGB-D streams, one device
program per round.

The production deployment shape the single-sequence reference app
(apps/PhotoconsistencyVisualOdometry/PhotoconsistencyVisualOdometry.cpp)
has no counterpart for: every round, a chunk of B frames from EACH of the S
streams is aligned in one dispatch (streams sharded over the mesh 'data'
axis, parallel/batch.py make_chunked_sequence_server), chunk poses are
integrated on device, and the host advances each stream's global pose with
one 4x4 multiply per frame. Writes one TUM-format trajectory per stream.

Usage:
    python -m phovo_tpu.apps.phovo_serve --config cfg.yml \
        --dataset seqA --dataset seqB [...] --out-dir out/ \
        [--chunk 16] [--devices auto] [--intrinsics fr1] [--warm-start]

Streams may have different lengths: exhausted (or short trailing) chunks are
padded by repeating the stream's last frame — padding pairs align identical
frames (a no-op for the solver) and their poses are discarded.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phovo-serve",
        description="Multi-camera photoconsistency VO serving (TUM RGB-D)",
    )
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--dataset", "-d", action="append", required=True,
                   help="TUM sequence dir (or phovo-convert raw dir); repeat "
                        "once per camera stream")
    p.add_argument("--out-dir", "-o", required=True,
                   help="one <stream-name>.txt trajectory per stream")
    p.add_argument("--intrinsics", default="fr1",
                   help="named preset (default/fr1/fr2/fr3) or 'fx,fy,cx,cy' "
                        "(shared by all streams)")
    p.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
    p.add_argument("--pairing", default="associate",
                   choices=["associate", "lockstep"])
    p.add_argument("--chunk", type=int, default=16,
                   help="frames ingested per stream per dispatch")
    p.add_argument("--devices", default="auto",
                   help="mesh data-axis size ('auto': largest divisor of the "
                        "stream count that fits the attached devices)")
    p.add_argument("--warm-start", action="store_true")
    p.add_argument("--max-frames", type=int, default=None,
                   help="cap on aligned pairs per stream")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def _open_stream(path: str, depth_scale: float, pairing: str):
    from phovo_tpu.datasets import raw as raw_ds
    from phovo_tpu.datasets.tum import TUMSequence

    if raw_ds.is_raw_dir(path):
        return raw_ds.RawSequence(path)
    return TUMSequence(path, depth_scale=depth_scale, pairing=pairing)


def _stream_names(paths: list[str]) -> list[str]:
    """Basenames, deduplicated with an index suffix."""
    from pathlib import Path

    names = [Path(p).name or Path(p).resolve().name for p in paths]
    out = []
    for i, n in enumerate(names):
        out.append(f"{i}_{n}" if names.count(n) > 1 else n)
    return out


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (FileNotFoundError, ValueError, IOError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.dataset) < 1:
        print("error: at least one --dataset required", file=sys.stderr)
        return 1

    from phovo_tpu.apps._bootstrap import enable_compilation_cache

    enable_compilation_cache()

    import time as _time
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    from phovo_tpu.apps.phovo_align import parse_intrinsics
    from phovo_tpu.datasets.tum import prefetch
    from phovo_tpu.parallel.batch import make_chunked_sequence_server
    from phovo_tpu.parallel.mesh import make_mesh
    from phovo_tpu.utils.config import load_config
    from phovo_tpu.utils.trajectory import TrajectoryWriter

    cfg = load_config(args.config)
    intr = parse_intrinsics(args.intrinsics)
    S = len(args.dataset)

    seqs = [
        _open_stream(d, args.depth_scale, args.pairing) for d in args.dataset
    ]
    for d, s in zip(args.dataset, seqs):
        if len(s) < 2:
            print(f"error: fewer than 2 paired frames in {d}", file=sys.stderr)
            return 1

    if args.devices == "auto":
        n_dev = len(jax.devices())
        n_data = max(k for k in range(1, min(S, n_dev) + 1) if S % k == 0)
    else:
        n_data = int(args.devices)
        if S % n_data != 0:
            print(
                f"error: {S} streams not divisible by --devices {n_data}",
                file=sys.stderr,
            )
            return 1
    mesh = make_mesh(n_data, pixel_parallel=1)
    serve = make_chunked_sequence_server(mesh, cfg, warm_start=args.warm_start)

    streams = [prefetch(iter(s)) for s in seqs]
    names = _stream_names(args.dataset)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # prime: the first frame of each stream becomes the carry
    first = [next(st, None) for st in streams]
    if any(f is None for f in first):
        print("error: empty stream", file=sys.stderr)
        return 1
    shapes = {f.intensity.shape for f in first}
    if len(shapes) != 1:
        print(f"error: streams disagree on frame size: {shapes}",
              file=sys.stderr)
        return 1
    H, W = shapes.pop()

    carry_i = jnp.asarray(
        np.stack([np.asarray(f.intensity) for f in first])
    )
    carry_d = jnp.asarray(
        np.stack([np.asarray(f.depth, np.float32) for f in first])
    )
    last = [
        (np.asarray(f.intensity), np.asarray(f.depth, np.float32))
        for f in first
    ]
    G = [np.eye(4) for _ in range(S)]
    n_done = [0] * S  # pairs written (lags ingestion by one pending round)
    n_taken = [0] * S  # pairs ingested
    B = args.chunk

    def next_chunk(s: int):
        """(I (B,H,W), D, timestamps list, n_real) — padded to B frames."""
        Ii, Dd, ts = [], [], []
        for fr in streams[s]:
            Ii.append(np.asarray(fr.intensity))
            Dd.append(np.asarray(fr.depth, np.float32))
            ts.append(fr.timestamp)
            if len(Ii) >= B or (
                args.max_frames is not None
                and n_taken[s] + len(Ii) >= args.max_frames
            ):
                break
        m = len(Ii)
        n_taken[s] += m
        if m:
            last[s] = (Ii[-1], Dd[-1])
        while len(Ii) < B:
            Ii.append(last[s][0])
            Dd.append(last[s][1])
        return np.stack(Ii), np.stack(Dd), ts, m

    writers = [TrajectoryWriter(out_dir / f"{n}.txt") for n in names]
    pending = None  # (host-side chunk poses future, per-stream ts, t0)
    t_start = _time.perf_counter()
    total_pairs = 0

    def flush(p):
        nonlocal total_pairs
        poses, ts_all, t0 = p
        poses = np.asarray(poses)  # blocks
        dt = _time.perf_counter() - t0
        m_round = 0
        for s in range(S):
            ts = ts_all[s]
            for k, t in enumerate(ts):
                Gk = G[s] @ poses[s, k]
                writers[s].write(t, Gk)
            if ts:
                G[s] = G[s] @ poses[s, len(ts) - 1]
                n_done[s] += len(ts)
                m_round += len(ts)
        total_pairs += m_round
        if not args.quiet and m_round:
            print(f"round: {m_round} pairs in {dt:.4f} s "
                  f"({m_round / dt:.1f} pairs/s)")

    try:
        while True:
            capped = args.max_frames is not None and all(
                n >= args.max_frames for n in n_taken
            )
            chunks = None
            if not capped:
                chunks = [next_chunk(s) for s in range(S)]
                if all(c[3] == 0 for c in chunks):
                    chunks = None
            if chunks is None:
                break
            t0 = _time.perf_counter()
            Ii = jnp.asarray(np.stack([c[0] for c in chunks]))
            Dd = jnp.asarray(np.stack([c[1] for c in chunks]))
            _, poses, carry_i, carry_d = serve(carry_i, carry_d, Ii, Dd, intr)
            if pending is not None:
                flush(pending)
            pending = (poses, [c[2] for c in chunks], t0)
    finally:
        if pending is not None:
            flush(pending)
        for w in writers:
            w.close()

    if not args.quiet:
        dt = _time.perf_counter() - t_start
        print(
            f"served {S} streams, {total_pairs} pairs in {dt:.2f} s "
            f"({total_pairs / max(dt, 1e-9):.1f} pairs/s aggregate); "
            f"trajectories in {out_dir}/"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
