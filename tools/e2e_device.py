"""Full-system device drive: synthetic TUM dataset -> phovo-vo CLI on the
accelerator.

    python tools/e2e_device.py

The parent process only renders the datasets, on the CPU; every phovo-vo
run is a child process that owns the card (one JAX process per card).
"""
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # the phovo-vo children own the card

from phovo_tpu.ops import se3  # noqa: E402
from phovo_tpu.ops.camera import TUM_FR1  # noqa: E402
from phovo_tpu.utils.synthetic import render_plane  # noqa: E402
from phovo_tpu.utils.device import gpu_name_and_power_limit  # noqa: E402
from phovo_tpu.utils.trajectory import format_pose_line  # noqa: E402

TMP = Path(tempfile.gettempdir())
ROOT = TMP / "phovo_e2e_seq"
LOOP_ROOT = TMP / "phovo_e2e_loop"
CLUTTER_ROOT = TMP / "phovo_e2e_clutter"
N = 120
SHAPE = (480, 640)


def _forward_state(k):
    return np.array(
        [0.012 * k, -0.008 * k, 0.006 * k, 0.005 * k, -0.003 * k, 0.004 * k],
        dtype=np.float64,
    )


def _loop_state(k):
    """Out along +x with yaw, then back to the start (loop closure)."""
    half = N // 2
    reach = 0.9
    x = reach * (k / half if k <= half else (N - k) / (N - half))
    return np.array(
        [x, 0.05 * np.sin(0.1 * k), 0.0, 0.12 * x, 0.0, 0.0],
        dtype=np.float64,
    )


def _build(root, state_fn):
    if (root / "rgb.txt").exists():
        return
    import cv2

    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for k in range(N):
        T = se3.pose_matrix_np(state_fn(k))
        I, D = render_plane(TUM_FR1, SHAPE, T)
        ts = 1000.0 + 0.05 * k
        cv2.imwrite(str(root / "rgb" / f"{ts:.6f}.png"), (I * 255).astype(np.uint8))
        cv2.imwrite(str(root / "depth" / f"{ts:.6f}.png"),
                    np.clip(D * 5000.0, 0, 65535).astype(np.uint16))
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_lines.append(f"{ts:.6f} depth/{ts:.6f}.png")
        gt_lines.append(format_pose_line(ts, np.linalg.inv(T)))
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")


def _build_cluttered(root):
    """Adversarial TUM-format dataset: occluding multi-object scene, depth
    noise/holes/quantization, exposure drift (utils/synthetic
    make_cluttered_sequence) — the photometric-violation regime real TUM
    data lives in (VERDICT r1 item 2)."""
    if (root / "rgb.txt").exists():
        return
    import cv2

    from phovo_tpu.utils.synthetic import make_cluttered_sequence

    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    I, D, gts, _ = make_cluttered_sequence(
        TUM_FR1, SHAPE, n_frames=N, motion_scale=1.0, seed=0
    )
    rgb_lines, depth_lines, gt_lines = [], [], []
    for k in range(N):
        ts = 1000.0 + 0.05 * k
        cv2.imwrite(
            str(root / "rgb" / f"{ts:.6f}.png"),
            (I[k] * 255).astype(np.uint8),
        )
        cv2.imwrite(
            str(root / "depth" / f"{ts:.6f}.png"),
            np.clip(D[k] * 5000.0, 0, 65535).astype(np.uint16),
        )
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_lines.append(f"{ts:.6f} depth/{ts:.6f}.png")
        gt_lines.append(format_pose_line(ts, gts[k]))
    (root / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")


def build_dataset():
    _build(ROOT, _forward_state)
    _build(LOOP_ROOT, _loop_state)
    _build_cluttered(CLUTTER_ROOT)


def run(label, args, root=ROOT):
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "phovo_tpu.apps.phovo_vo",
                        "--config",
                        "phovo_tpu/configs/config_5_level_optimization_analytic.yml",
                        "--dataset", str(root), "--intrinsics", "fr1",
                        "--eval-gt", str(root / "groundtruth.txt"),
                        *args],
                       capture_output=True, text=True, cwd=REPO)
    dt = time.time() - t0
    tail = [ln for ln in p.stdout.splitlines() if "ATE" in ln or "RPE" in ln
            or "frames" in ln.lower() or "pairs" in ln.lower()
            or "closure" in ln.lower()]
    print(f"--- {label} (exit {p.returncode}, {dt:.0f}s wall) ---")
    for ln in tail[-6:]:
        print("   ", ln)
    if p.returncode != 0:
        print(p.stderr[-2000:])
    return p.returncode


def main():
    # the phovo-vo children run on JAX's default backend: the card
    print("\n".join(gpu_name_and_power_limit()) or "no nvidia-smi", flush=True)
    build_dataset()
    rc = 0
    rc |= run("analytic chunk=64", [
        "--output", str(TMP / "e2e_traj_a.txt"), "--chunk", "64"])
    rc |= run("ic backend chunk=64", [
        "--output", str(TMP / "e2e_traj_ic.txt"), "--backend", "ic", "--chunk", "64"])
    rc |= run("biobjective chunk=64", [
        "--output", str(TMP / "e2e_traj_bi.txt"), "--backend", "biobjective",
        "--chunk", "64"])
    rc |= run("ceres backend", [
        "--output", str(TMP / "e2e_traj_c.txt"), "--backend", "ceres"])
    rc |= run("keyframe + pose graph + photometric BA", [
        "--output", str(TMP / "e2e_traj_kf.txt"), "--mode", "keyframe",
        "--ba-iterations", "3"])
    rc |= run("loop-closure sequence (frame mode — keyframe-wall denominator)", [
        "--output", str(TMP / "e2e_traj_loop_frame.txt"), "--chunk", "16"],
        root=LOOP_ROOT)
    rc |= run("loop-closure sequence (keyframe mode)", [
        "--output", str(TMP / "e2e_traj_loop.txt"), "--mode", "keyframe",
        "--chunk", "16", "--ba-iterations", "3"], root=LOOP_ROOT)
    rc |= run("cluttered+degraded sequence (robust chunked)", [
        "--output", str(TMP / "e2e_traj_clutter.txt"), "--chunk", "64",
        "--robust-loss", "huber"], root=CLUTTER_ROOT)
    rc |= run("cluttered+degraded sequence (keyframe mode)", [
        "--output", str(TMP / "e2e_traj_clutter_kf.txt"), "--mode", "keyframe",
        "--chunk", "16", "--ba-iterations", "3",
        "--robust-loss", "huber"], root=CLUTTER_ROOT)
    print("ALL OK" if rc == 0 else "FAILURES")
    return rc


if __name__ == "__main__":
    sys.exit(main())
