"""Image pyramids, Gaussian blur, and Scharr gradients as banded matmuls.

Reference behavior being matched (not translated):
  - BuildPyramid (CPhotoconsistencyOdometryAnalytic.h:115-163): level k is the
    ORIGINAL image resized by factor 1/2^k with cv::resize INTER_LINEAR, then
    (intensity only) blurred TWICE with cv::GaussianBlur(ksize=blurFilterSize,
    sigma=3) when blurFilterSize > 0.
  - BuildDerivativesPyramids (…Analytic.h:165-189): per level, cv::Scharr
    d/dx and d/dy with per-level scale factor, BORDER_REFLECT_101.
  - Depth-gradient pyramids (…BiObjective.h:213-239): depth normalized by
    1/maxDepth before Scharr.

Design: every one of these linear operations is expressed as a pair
of small banded matrices applied as  A_rows @ image @ A_cols^T.  The matrices
are built once per (shape, params) on the host (numpy), cached, and closed
over by the jitted function, so the whole pyramid build compiles to a chain of
small matmuls — no gathers, no dynamic shapes. Bilinear resize, reflect-101
borders, and Scharr taps are all exactly representable this way, so results
match OpenCV to float tolerance (verified in tests/test_pyramid.py against
cv2 itself).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "resize_matrix",
    "gaussian_matrix",
    "scharr_matrices",
    "resize_bilinear",
    "gaussian_blur",
    "scharr",
    "level_shape",
    "build_pyramid",
    "build_gradient_pyramid",
]


def level_shape(shape: tuple[int, int], level: int) -> tuple[int, int]:
    """Output (H, W) of cv::resize(src, Size(0,0), f, f) with f = 1/2^level.

    OpenCV computes dsize = Size(round(fx*cols), round(fy*rows)) with
    round-half-away-from-zero (cvRound on a positive .5 product of exact
    binary fractions is exact in practice for our sizes).
    """
    f = 1.0 / (2.0**level)
    return (int(round(shape[0] * f)), int(round(shape[1] * f)))


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear-interpolation operator along one axis.

    Uses OpenCV INTER_LINEAR coordinate convention:
        src = (dst + 0.5) * (n_in / n_out) - 0.5
    with edge clamping. Two nonzeros per row.
    """
    A = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for d in range(n_out):
        s = (d + 0.5) * scale - 0.5
        s0 = math.floor(s)
        w1 = s - s0
        i0 = min(max(s0, 0), n_in - 1)
        i1 = min(max(s0 + 1, 0), n_in - 1)
        A[d, i0] += 1.0 - w1
        A[d, i1] += w1
    return A


def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: exp(-(i-c)^2 / (2 sigma^2)), normalized."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((i - c) ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _border_conv_matrix(n: int, kernel: np.ndarray) -> np.ndarray:
    """(n, n) operator: 1-D correlation with `kernel`, BORDER_REFLECT_101.

    reflect_101 index map: -1 -> 1, -2 -> 2, n -> n-2, ... (no edge repeat),
    matching OpenCV's default border for GaussianBlur/Scharr.
    """
    ksize = len(kernel)
    half = ksize // 2
    A = np.zeros((n, n), dtype=np.float32)
    for r in range(n):
        for j in range(ksize):
            src = r + j - half
            # reflect-101
            while src < 0 or src >= n:
                if src < 0:
                    src = -src
                if src >= n:
                    src = 2 * (n - 1) - src
            A[r, src] += kernel[j]
    return A


@functools.lru_cache(maxsize=None)
def gaussian_matrix(n: int, ksize: int, sigma: float = 3.0) -> np.ndarray:
    return _border_conv_matrix(n, _gaussian_kernel_1d(ksize, sigma))


@functools.lru_cache(maxsize=None)
def scharr_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(deriv, smooth) (n, n) operators for the Scharr filter.

    cv::Scharr(dx=1): separable [-1,0,1] (derivative axis) x [3,10,3]
    (smoothing axis). Caller applies per-level scale.
    """
    deriv = _border_conv_matrix(n, np.array([-1.0, 0.0, 1.0], dtype=np.float32))
    smooth = _border_conv_matrix(n, np.array([3.0, 10.0, 3.0], dtype=np.float32))
    return deriv, smooth


# ---------------------------------------------------------------------------
# jit-friendly functional ops (operators closed over as constants)
# ---------------------------------------------------------------------------


def _pow2_factor(n_in: int, n_out: int) -> int | None:
    """k such that n_in == n_out * 2^k (exact power-of-two downscale)."""
    if n_out <= 0 or n_in % n_out:
        return None
    q = n_in // n_out
    return q.bit_length() - 1 if q & (q - 1) == 0 and q > 1 else None


def resize_bilinear(img: jax.Array, out_shape: tuple[int, int]) -> jax.Array:
    """Bilinear resize of (..., H, W) to (..., H', W'), OpenCV INTER_LINEAR
    coordinate convention.

    Fast path: for an exact 1/2^k downscale the source coordinate
    (d + 0.5) * 2^k - 0.5 always has fractional part 0.5, so every output is
    the average of exactly two adjacent pixels at stride 2^k — a strided
    slice + add (fusable VPU work) instead of a dense matmul. This covers
    every pyramid level of even-sized frames (e.g. all of VGA); other shapes
    fall back to the banded-matmul path.
    """
    H, W = img.shape[-2:]
    Ho, Wo = out_shape
    if (H, W) == (Ho, Wo):
        return img
    kr = _pow2_factor(H, Ho)
    kc = _pow2_factor(W, Wo)
    if kr is not None and kc is not None:
        sr, sc = 1 << kr, 1 << kc
        offr, offc = sr // 2 - 1, sc // 2 - 1
        rows_a = img[..., offr::sr, :][..., :Ho, :]
        rows_b = img[..., offr + 1 :: sr, :][..., :Ho, :]
        rows = 0.5 * (rows_a + rows_b)
        cols_a = rows[..., offc::sc][..., :Wo]
        cols_b = rows[..., offc + 1 :: sc][..., :Wo]
        return 0.5 * (cols_a + cols_b)
    Ar = jnp.asarray(resize_matrix(H, Ho))
    Ac = jnp.asarray(resize_matrix(W, Wo))
    return jnp.einsum(
        "ij,...jk,lk->...il", Ar, img, Ac, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST
    )


def _sep_filter(img: jax.Array, kr, kc) -> jax.Array:
    """Separable correlation with reflect-101 borders via shifted adds
    (pure fusable VPU work; jnp.pad mode='reflect' IS reflect-101).

    Anchor follows OpenCV's default ksize//2 (centered for odd kernels,
    one-right-of-center for even — cv::blur accepts even sizes)."""
    ar, ac = len(kr) // 2, len(kc) // 2
    out = img
    if len(kr) > 1:
        p = jnp.pad(
            out,
            [(0, 0)] * (out.ndim - 2) + [(ar, len(kr) - 1 - ar), (0, 0)],
            mode="reflect",
        )
        H = img.shape[-2]
        out = sum(
            float(kr[t]) * jax.lax.slice_in_dim(p, t, t + H, axis=-2)
            for t in range(len(kr))
        )
    if len(kc) > 1:
        p = jnp.pad(
            out,
            [(0, 0)] * (out.ndim - 2) + [(0, 0), (ac, len(kc) - 1 - ac)],
            mode="reflect",
        )
        W = img.shape[-1]
        out = sum(
            float(kc[t]) * jax.lax.slice_in_dim(p, t, t + W, axis=-1)
            for t in range(len(kc))
        )
    return out


def gaussian_blur(img: jax.Array, ksize: int, sigma: float = 3.0) -> jax.Array:
    """Separable Gaussian blur with reflect-101 borders (one pass)."""
    if ksize <= 0:
        return img
    k = _gaussian_kernel_1d(ksize, sigma)
    return _sep_filter(img, k, k)


def box_blur(img: jax.Array, ksize: int) -> jax.Array:
    """Separable normalized box filter with reflect-101 borders — cv::blur
    semantics, the reference's alternate pyramid smoothing compile path
    (ENABLE_BOX_FILTER_BLUR, CPhotoconsistencyOdometryAnalytic.h:38,149-155)."""
    if ksize <= 0:
        return img
    k = np.full(ksize, 1.0 / ksize, dtype=np.float64)
    return _sep_filter(img, k, k)


def scharr(img: jax.Array, axis: str, scale: float = 1.0) -> jax.Array:
    """Scharr gradient of (..., H, W). axis='x' for d/dcol, 'y' for d/drow."""
    deriv = [-1.0, 0.0, 1.0]
    smooth = [3.0, 10.0, 3.0]
    if axis == "x":
        out = _sep_filter(img, smooth, deriv)
    elif axis == "y":
        out = _sep_filter(img, deriv, smooth)
    else:
        raise ValueError(f"axis must be 'x' or 'y', got {axis!r}")
    return out * jnp.asarray(scale, dtype=out.dtype)


def build_pyramid(
    img: jax.Array,
    num_levels: int,
    blur_filter_sizes: tuple[int, ...] | None = None,
    blur_sigma: float = 3.0,
    blur_type: str = "gaussian",
) -> list[jax.Array]:
    """List of per-level images, level 0 = full resolution.

    Each level is resized from the ORIGINAL image (reference semantics,
    CPhotoconsistencyOdometryAnalytic.h:125-161: factor = 1/2^level applied
    to `img`, not to the previous level), then blurred twice when a positive
    blur size is configured for that level. blur_type selects the
    reference's compile-time smoothing variant: 'gaussian'
    (ENABLE_GAUSSIAN_BLUR, double GaussianBlur sigma=3, …Analytic.h:143-148)
    or 'box' (ENABLE_BOX_FILTER_BLUR, double cv::blur, …Analytic.h:149-155).
    """
    if blur_type not in ("gaussian", "box"):
        raise ValueError(f"blur_type={blur_type!r}; expected 'gaussian' or 'box'")
    base_shape = img.shape[-2:]
    pyramid = []
    for level in range(num_levels):
        lvl = resize_bilinear(img, level_shape(base_shape, level))
        if blur_filter_sizes is not None:
            k = int(blur_filter_sizes[level])
            if k > 0:
                if blur_type == "box":
                    lvl = box_blur(box_blur(lvl, k), k)
                else:
                    lvl = gaussian_blur(gaussian_blur(lvl, k, blur_sigma), k, blur_sigma)
        pyramid.append(lvl)
    return pyramid


def build_gradient_pyramid(
    pyramid: list[jax.Array],
    scales: tuple[float, ...],
) -> tuple[list[jax.Array], list[jax.Array]]:
    """Per-level (d/dx, d/dy) Scharr gradients with per-level scaling."""
    gx = [scharr(img, "x", scales[i]) for i, img in enumerate(pyramid)]
    gy = [scharr(img, "y", scales[i]) for i, img in enumerate(pyramid)]
    return gx, gy
