"""Per-preset trajectory parity: framework vs the reference-exact oracle.

Runs the SAME synthetic RGB-D sequence through (a) the f64 reference oracle
(tools/reference_oracle.py — bug-for-bug emulation of the reference
backends) and (b) this framework's corresponding backend, for every shipped
preset, using the reference VO app's loop semantics (zero init per pair,
pose <- pose @ Rt^-1, PhotoconsistencyVisualOdometry.cpp:224,233-234).
Reports the ATE between the two trajectories — the blueprint's "match the
reference trajectory within its ATE bound per preset" target, measured —
plus each trajectory's ATE against exact ground truth for context.

Usage:
    python -m tools.parity_harness --frames 20 --shape 480 640 \
        --out-md PARITY_TABLE.md --out-json parity.json
    (add --presets name1,name2 to subset; --motion-scale to stress)

Real TUM sequences are unreachable from this container (zero egress), so
the sequence is synthetic (utils/synthetic.make_sequence); the harness
accepts --scene plane|cluttered|rotation (cluttered = occluding boxes +
depth noise + exposure drift, see utils/synthetic.render_cluttered;
rotation = rotation-dominant trajectory, utils/synthetic
.rotation_trajectory) to show parity holds beyond the easy scene.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from phovo_tpu.apps._bootstrap import enable_compilation_cache
from phovo_tpu.utils.device import jax_devices

enable_compilation_cache()


def _framework_backend(name: str, config):
    if name == "analytic":
        from phovo_tpu.models.analytic import PhotoconsistencyOdometryAnalytic

        return PhotoconsistencyOdometryAnalytic(config)
    if name == "biobjective":
        from phovo_tpu.models.biobjective import PhotoconsistencyOdometryBiObjective

        return PhotoconsistencyOdometryBiObjective(config)
    if name == "autodiff":
        from phovo_tpu.models.autodiff import PhotoconsistencyOdometryAutodiff

        return PhotoconsistencyOdometryAutodiff(config)
    raise ValueError(name)


def _oracle_backend(name: str, config):
    from tools import reference_oracle as ro

    return ro.oracle_for_backend(name, config)


def run_vo(model, intensities, depths, K, pose_matrix_fn) -> np.ndarray:
    """Reference VO loop: per consecutive pair, optimize from zero init and
    integrate pose <- pose @ Rt^-1. Returns (N, 4, 4) world_from_cam."""
    model.set_intrinsic_matrix(K)
    poses = [np.eye(4)]
    states = []
    for k in range(len(intensities) - 1):
        model.set_source_frame(intensities[k], depths[k])
        model.set_target_frame(intensities[k + 1], depths[k + 1])
        model.set_initial_state_vector(np.zeros(6))
        out = model.optimize()
        state = np.asarray(getattr(out, "state", out), dtype=np.float64)
        states.append(state)
        Rt = np.asarray(pose_matrix_fn(state), dtype=np.float64)
        poses.append(poses[-1] @ np.linalg.inv(Rt))
    return np.stack(poses), np.stack(states)


def ate_rmse(poses_a: np.ndarray, poses_b: np.ndarray) -> float:
    """ATE RMSE between two pose arrays (Horn alignment, TUM semantics)."""
    from phovo_tpu.utils.trajectory import horn_align

    P = poses_a[:, :3, 3]
    Q = poses_b[:, :3, 3]
    R, t = horn_align(P, Q)
    err = (P @ R.T + t) - Q
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


# preset -> backends to compare under it. Bi-objective shares the analytic
# GN schema (…BiObjective.h:671-697), so it runs under the analytic presets.
def preset_plan(preset_names):
    plan = []
    for name in preset_names:
        if "analytic" in name:
            plan.append((name, "analytic"))
            if "only_level" not in name:
                plan.append((name, "biobjective"))
        else:
            plan.append((name, "autodiff"))
    return plan


ALL_PRESETS = [
    "config_4_level_optimization_analytic",
    "config_5_level_optimization_analytic",
    "config_6_level_optimization_analytic",
    "config_only_level_0_analytic",
    "config_3_level_optimization_ceres",
    "config_4_level_optimization_ceres",
    "config_5_level_optimization_ceres",
    "config_only_level_0_ceres",
    "config_only_level_1_ceres",
    "config_only_level_2_ceres",
    "config_only_level_3_ceres",
    "config_only_level_4_ceres",
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--shape", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--motion-scale", type=float, default=1.0)
    ap.add_argument("--scene", default="plane",
                    choices=("plane", "cluttered", "rotation"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--presets", default="all")
    ap.add_argument("--out-md", default=None)
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    from phovo_tpu.ops import se3
    from phovo_tpu.ops.camera import Intrinsics
    from phovo_tpu.utils import synthetic
    from phovo_tpu.utils.config import load_builtin
    from tools import reference_oracle

    H, W = args.shape
    fx = 525.0 * W / 640.0
    K = np.array([[fx, 0, (W - 1) / 2], [0, fx, (H - 1) / 2], [0, 0, 1.0]])
    intr = Intrinsics(
        np.float32(fx), np.float32(fx), np.float32((W - 1) / 2), np.float32((H - 1) / 2)
    )
    if args.scene == "plane":
        I, D, gts, _ = synthetic.make_sequence(
            intr, (H, W), args.frames, args.motion_scale, args.seed
        )
    elif args.scene == "rotation":
        # rotation-dominant plane scene: stresses the Jacobian rotation
        # columns (VERDICT r2 item 6)
        I, D, gts, _ = synthetic.make_sequence(
            intr, (H, W), args.frames, args.motion_scale, args.seed,
            trajectory="rotation",
        )
    else:
        I, D, gts, _ = synthetic.make_cluttered_sequence(
            intr, (H, W), args.frames, args.motion_scale, args.seed
        )
    I_u8 = [(img * 255).astype(np.uint8) for img in I]
    D64 = [d.astype(np.float64) for d in D]
    gt_poses = np.stack(gts)

    names = ALL_PRESETS if args.presets == "all" else args.presets.split(",")
    rows = []
    for preset, backend in preset_plan(names):
        cfg = load_builtin(preset)
        t0 = time.time()
        oracle = _oracle_backend(backend, cfg)
        o_poses, o_states = run_vo(oracle, I_u8, D64, K, reference_oracle.pose_matrix)
        t_oracle = time.time() - t0
        t0 = time.time()
        model = _framework_backend(backend, cfg)
        f_poses, f_states = run_vo(
            model, I_u8, D, K, lambda s: se3.pose_matrix(s.astype(np.float64))
        )
        t_fw = time.time() - t0
        row = {
            "preset": preset,
            "backend": backend,
            "ate_fw_vs_oracle": ate_rmse(f_poses, o_poses),
            "ate_oracle_vs_gt": ate_rmse(o_poses, gt_poses),
            "ate_fw_vs_gt": ate_rmse(f_poses, gt_poses),
            "max_state_delta": float(
                np.max(np.linalg.norm(f_states - o_states, axis=1))
            ),
            "oracle_seconds": round(t_oracle, 2),
            "framework_seconds": round(t_fw, 2),
        }
        rows.append(row)
        print(
            f"{preset:40s} {backend:12s} fw-vs-oracle ATE {row['ate_fw_vs_oracle']:.5f} "
            f"(oracle-vs-gt {row['ate_oracle_vs_gt']:.5f}, fw-vs-gt {row['ate_fw_vs_gt']:.5f})",
            flush=True,
        )

    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(
                {
                    "device": jax_devices(),
                    "frames": args.frames,
                    "shape": list(args.shape),
                    "scene": args.scene,
                    "motion_scale": args.motion_scale,
                    "rows": rows,
                },
                f,
                indent=1,
            )
    if args.out_md:
        lines = [
            "| preset | backend | ATE fw vs oracle (m) | ATE oracle vs GT | ATE fw vs GT | max state delta |",
            "|---|---|---|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['preset']} | {r['backend']} | {r['ate_fw_vs_oracle']:.5f} "
                f"| {r['ate_oracle_vs_gt']:.5f} | {r['ate_fw_vs_gt']:.5f} "
                f"| {r['max_state_delta']:.5f} |"
            )
        with open(args.out_md, "w") as f:
            f.write("\n".join(lines) + "\n")
    return rows


if __name__ == "__main__":
    main()
