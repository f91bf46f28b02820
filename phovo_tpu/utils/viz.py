"""Visualization / diagnostic image utilities.

The reference verifies alignment by eye: cv::imshow of |target - warped
source| per frame and optionally per iteration
(PhotoconsistencyFrameAlignment.cpp:107-112,
CPhotoconsistencyOdometryAnalytic.h:551-557, visualizeIterations config
key). There is no display on a headless server; the equivalent here renders the
same diagnostics to PNG files (or returns arrays for notebooks).
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from phovo_tpu.ops.camera import Intrinsics
from phovo_tpu.ops.warp import forward_warp


def alignment_diff(
    source_intensity: np.ndarray,
    source_depth: np.ndarray,
    target_intensity: np.ndarray,
    state: np.ndarray,
    intr: Intrinsics,
) -> np.ndarray:
    """|target - forward-warped source| in the input intensity range.

    A converged alignment yields a near-black image (the reference's manual
    oracle, SURVEY §4)."""
    src = np.asarray(source_intensity, dtype=np.float32)
    warped = np.asarray(
        forward_warp(
            jnp.asarray(src), jnp.asarray(source_depth, dtype=np.float32),
            jnp.asarray(state, dtype=np.float32), intr,
        )
    )
    return np.abs(np.asarray(target_intensity, dtype=np.float32) - warped)


def save_image(
    path: str | Path, img: np.ndarray, unit_range: bool | None = None
) -> None:
    """Write a grayscale image (float arrays are clipped to [0, 255]).

    unit_range says whether a float input is in [0, 1] (scaled by 255) or
    already in [0, 255]. Pass it explicitly when you know the convention: a
    data-range guess inverts the "near-black means converged" oracle for
    well-converged u8-range diff images (every |diff| <= 1.5 gray levels
    would be mistaken for unit range and rendered at full brightness)."""
    import cv2

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        if unit_range is None:
            unit_range = arr.max() <= 1.5  # last-resort guess
        if unit_range:
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    cv2.imwrite(str(path), arr)


def side_by_side(*images: np.ndarray, pad: int = 4) -> np.ndarray:
    """Horizontal mosaic with padding (all images same height)."""
    imgs = [np.asarray(i, dtype=np.float32) for i in images]
    H = max(i.shape[0] for i in imgs)
    sep = np.full((H, pad), 255.0, np.float32)
    cols = []
    for k, im in enumerate(imgs):
        if im.shape[0] < H:
            im = np.pad(im, ((0, H - im.shape[0]), (0, 0)))
        if k:
            cols.append(sep)
        cols.append(im)
    return np.concatenate(cols, axis=1)


def save_ply(path, points, intensity=None) -> None:
    """Write a sparse landmark map as an ASCII PLY point cloud.

    points (N, 3) world coordinates; intensity (N,) in 0..1 rendered as a
    grayscale vertex color (standard viewers: meshlab/CloudCompare/open3d).
    The reference has no map output at all (its only persistent artifact is
    the trajectory file, PhotoconsistencyVisualOdometry.cpp:240-243); the
    keyframe back-end's BA landmarks make a map export natural."""
    import numpy as np

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(pts)
    if intensity is not None:
        g = np.clip(np.asarray(intensity, np.float64).reshape(-1), 0.0, 1.0)
        g = (g * 255.0 + 0.5).astype(np.uint8)
    lines = [
        "ply",
        "format ascii 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if intensity is not None:
        lines += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    lines.append("end_header")
    for k in range(n):
        row = f"{pts[k, 0]:.6f} {pts[k, 1]:.6f} {pts[k, 2]:.6f}"
        if intensity is not None:
            row += f" {g[k]} {g[k]} {g[k]}"
        lines.append(row)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
