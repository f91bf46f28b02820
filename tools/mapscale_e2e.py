"""Map-scale end-to-end drive: the REAL keyframe pipeline at back-end scale.

VERDICT r2 item 1: the map-scale solvers (CG pose graph, sparse/auto Schur
BA) had only ever been benchmarked on synthetic-standalone problems; the
actual pipeline had produced at most 13 keyframes / 9 closures. This tool
scales the reference's sequence loop
(/root/reference/apps/PhotoconsistencyVisualOdometry/
PhotoconsistencyVisualOdometry.cpp:212-259) for real: a multi-lap VGA
sequence long enough to yield 150+ keyframes and dozens-to-hundreds of loop
closures, driven through `phovo-vo --mode keyframe --loader raw
--pg-solver cg --ba-iterations N` — the full production path (zero-decode
raw streaming with storage-dtype device conversion, chunked keyframe
tracking, deferred batched closures, bucketed CG pose graph, windowed
auto-Schur photometric BA) on the accelerator. The parent renders the data
with numpy only; the phovo-vo child owns the card.

The trajectory is `--laps` laps of a circle in the plane-scene world: every
lap revisits the previous laps' keyframe positions, so closures accumulate
lap over lap (the promotion spacing ~0.15 m keeps same-lap neighbors just
outside the 0.6 m closure radius — cross-lap closures only).

Usage:
    python -m tools.mapscale_e2e [--frames 1200] [--chunk 32] [--ba 3]
        [--cross-check]   # also run --pg-solver dense and compare ATE

Writes artifacts/mapscale.json.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from phovo_tpu.ops import se3
from phovo_tpu.ops.camera import TUM_FR1
from phovo_tpu.utils.synthetic import render_plane
from phovo_tpu.utils.device import gpu_name_and_power_limit
from phovo_tpu.utils.trajectory import format_pose_line

TMP = Path(tempfile.gettempdir())
ROOT = TMP / "phovo_mapscale_raw"
SHAPE = (480, 640)


def _lap_state(k: int, n: int, laps: float) -> np.ndarray:
    """Camera state (cam-from-world [x y z yaw pitch roll]) at frame k:
    `laps` laps of a radius-2.4 m circle in the plane's x-y, with gentle
    depth and yaw modulation. Path length = laps * 15.1 m -> a keyframe
    every ~5 frames at the default 0.15 m promotion threshold."""
    R = 2.4
    th = 2.0 * np.pi * laps * k / n
    return np.array(
        [
            R * np.sin(th),
            R * (1.0 - np.cos(th)),
            0.08 * np.sin(3.0 * th),
            0.06 * np.sin(2.0 * th),
            0.03 * np.sin(5.0 * th),
            0.0,
        ],
        dtype=np.float64,
    )


def build_raw(root: Path, n: int, laps: float) -> None:
    """Render the sequence STRAIGHT into the raw v2 memmap layout (no PNG
    round trip: at 1,200 VGA frames the PNG encode+decode would dominate
    the whole experiment)."""
    meta_file = root / "meta.json"
    if meta_file.is_file():
        meta = json.loads(meta_file.read_text())
        if meta.get("n") == n and meta.get("laps") == laps:
            return
    root.mkdir(parents=True, exist_ok=True)
    H, W = SHAPE
    scale = 1.0 / 5000.0
    i_mm = np.lib.format.open_memmap(
        root / "intensity.u8.npy", mode="w+", dtype=np.uint8, shape=(n, H, W)
    )
    d_mm = np.lib.format.open_memmap(
        root / "depth.u16.npy", mode="w+", dtype=np.uint16, shape=(n, H, W)
    )
    ts = 1000.0 + 0.05 * np.arange(n)
    gt_lines = []
    t0 = time.time()
    for k in range(n):
        T = se3.pose_matrix_np(_lap_state(k, n, laps))
        I, D = render_plane(TUM_FR1, SHAPE, T)
        i_mm[k] = np.clip(I * 255.0 + 0.5, 0, 255).astype(np.uint8)
        d_mm[k] = np.clip(D / scale + 0.5, 0, 65535).astype(np.uint16)
        gt_lines.append(format_pose_line(ts[k], np.linalg.inv(T)))
        if k % 200 == 0:
            print(f"  render {k}/{n} ({time.time() - t0:.0f}s)")
    i_mm.flush()
    d_mm.flush()
    np.save(root / "timestamps.f64.npy", ts)
    np.save(root / "depth_timestamps.f64.npy", ts)
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    (root / "meta.json").write_text(
        json.dumps(
            {
                "format_version": 2,
                "n": n,
                "height": H,
                "width": W,
                "depth_scale": scale,
                "pairing": "associate",
                "source": "tools/mapscale_e2e.py synthetic multi-lap",
                "laps": laps,
            },
            indent=2,
        )
        + "\n"
    )
    print(f"  rendered {n} frames in {time.time() - t0:.0f}s")


def run_pipeline(args, pg_solver: str, out: str) -> dict:
    cmd = [
        sys.executable, "-m", "phovo_tpu.apps.phovo_vo",
        "--config",
        "phovo_tpu/configs/config_5_level_optimization_analytic.yml",
        "--dataset", str(ROOT), "--intrinsics", "fr1",
        "--loader", "raw", "--mode", "keyframe",
        "--chunk", str(args.chunk), "--pg-solver", pg_solver,
        "--ba-iterations", str(args.ba),
        "--ba-scope", args.ba_scope, "--ba-covis", str(args.ba_covis),
        "--eval-gt", str(ROOT / "groundtruth.txt"),
        "--output", out, "-q",
    ]
    if getattr(args, "pg_incremental", 0):
        cmd += ["--pg-incremental", str(args.pg_incremental)]
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    wall = time.time() - t0
    if p.returncode != 0:
        print(p.stdout[-2000:])
        print(p.stderr[-4000:])
        raise SystemExit(f"pipeline failed ({p.returncode})")
    res = {"pg_solver": pg_solver, "wall_s": round(wall, 1)}
    pats = {
        "track_s": r"track ([\d.]+) s",
        "track_fps": r"\(([\d.]+) frames/s\)",
        "finalize_s": r"finalize ([\d.]+) s",
        "pose_graph_s": r"pose_graph ([\d.]+) s",
        "photometric_ba_s": r"photometric_ba ([\d.]+) s",
        "ate_m": r"ATE rmse: ([\d.]+) m",
        "rpe_m": r"RPE rmse: ([\d.]+) m",
        "rpe_deg": r"/ ([\d.]+) deg",
        "incr_solves": r"incremental: (\d+) solves",
        "incr_min_s": r"latency min ([\d.]+) s",
        "incr_mean_s": r"mean ([\d.]+) s / p90",
        "incr_p90_s": r"p90 ([\d.]+) s",
        "incr_max_s": r"max ([\d.]+) s",
        "incr_first_s": r"first ([\d.]+) s",
    }
    for key, pat in pats.items():
        m = re.search(pat, p.stdout)
        if m:
            res[key] = float(m.group(1))
    # keyframe/closure counts come from the trajectory-summary line, which
    # -q suppresses — recover them from the written trajectory + a rerun of
    # the promotion bookkeeping is overkill; instead phovo-vo's keyframe
    # wall line is unconditional and the counts are parsed from stderr-free
    # stdout when present
    m = re.search(r"\((\d+) keyframes, (\d+) loop closures\)", p.stdout)
    if m:
        res["keyframes"] = int(m.group(1))
        res["loop_closures"] = int(m.group(2))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--laps", type=float, default=2.5)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--ba", type=int, default=3)
    ap.add_argument("--ba-scope", default="window",
                    choices=["window", "global"])
    ap.add_argument("--ba-covis", type=int, default=6)
    ap.add_argument("--cross-check", action="store_true",
                    help="also run --pg-solver dense and compare")
    ap.add_argument("--pg-incremental", type=int, default=0,
                    help="re-solve the pose graph every N promotions "
                         "(per-promotion latency recorded)")
    ap.add_argument("--out", default="artifacts/mapscale.json")
    args = ap.parse_args()

    print(f"building {args.frames}-frame raw dataset ({args.laps} laps) ...")
    build_raw(ROOT, args.frames, args.laps)

    rows = [run_pipeline(args, "cg", str(TMP / "mapscale_traj_cg.txt"))]
    print(json.dumps(rows[0]))
    if args.cross_check:
        rows.append(run_pipeline(args, "dense", str(TMP / "mapscale_traj_dense.txt")))
        print(json.dumps(rows[1]))
        # trajectory agreement between the two back-end solvers on the
        # SAME data (tracking is deterministic, so differences isolate the
        # pose-graph solver)
        from phovo_tpu.utils.trajectory import (
            absolute_trajectory_error, read_trajectory,
        )

        est_cg = read_trajectory(str(TMP / "mapscale_traj_cg.txt"))
        est_d = read_trajectory(str(TMP / "mapscale_traj_dense.txt"))
        cross = absolute_trajectory_error(est_cg, est_d)
        rows.append({"cg_vs_dense_ate_m": cross["rmse"]})
        print(json.dumps(rows[-1]))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        {"gpu": gpu_name_and_power_limit(),
         "frames": args.frames, "laps": args.laps, "chunk": args.chunk,
         "ba_iterations": args.ba, "runs": rows}, indent=2) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
