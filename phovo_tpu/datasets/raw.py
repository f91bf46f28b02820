"""Raw memory-mapped sequence format: decode once, stream at memcpy speed.

The TUM layout stores every frame as a PNG, so sequence throughput is bounded
by inflate speed, well below what the device side of the pipeline consumes.
For production replay/serving, `convert_to_raw` decodes a
sequence ONCE into flat memory-mapped arrays:

    <out>/meta.json            {"n", "height", "width", "depth_scale", ...}
    <out>/intensity.u8.npy     (n, H, W) uint8, C-order
    <out>/depth.u16.npy        (n, H, W) uint16 raw counts (x depth_scale = m)
    <out>/timestamps.f64.npy   (n,) float64

`RawSequence` then streams frames or whole chunks as zero-decode memmap
slices — the only per-pixel host work left in the pipeline is one memcpy
into the device transfer buffer (u8 intensity and u16 depth counts stay in
their storage dtypes end-to-end; the jitted aligner converts both on device,
models/analytic.py align_sequence_chunk — this also halves the bytes moved
per frame vs float32 depth).

No counterpart exists in the reference (its CCameraRecord re-decodes PNGs
every run, CCameraRecord.h:74-108); this is the production replay path.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from phovo_tpu.datasets.tum import RGBDFrame, TUM_DEPTH_SCALE

META_NAME = "meta.json"
FORMAT_VERSION = 2


def is_raw_dir(path: str | Path) -> bool:
    return (Path(path) / META_NAME).is_file()


def convert_to_raw(
    dataset_dir: str | Path,
    out_dir: str | Path,
    depth_scale: float = TUM_DEPTH_SCALE,
    pairing: str = "associate",
    loader: str = "auto",
    max_frames: int | None = None,
) -> Path:
    """Decode a TUM PNG sequence into the raw memmap layout. Returns out_dir.

    Uses the native C++ decode pool when built (loader='auto'/'native'),
    falling back to the Python/cv2 reader."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    from phovo_tpu.datasets import native_loader

    use_native = loader == "native" or (loader == "auto" and native_loader.available())
    if use_native and not native_loader.available():
        raise IOError(
            "native loader requested but native/libphovo_io.so is not built"
        )
    if use_native:
        seq = native_loader.NativeTUMSequence(
            dataset_dir, depth_scale=depth_scale, pairing=pairing
        )
    else:
        from phovo_tpu.datasets.tum import TUMSequence

        seq = TUMSequence(dataset_dir, depth_scale=depth_scale, pairing=pairing)

    n_total = len(seq)
    if max_frames is not None:
        n_total = min(n_total, max_frames)
    if n_total == 0:
        raise ValueError(f"no paired frames found in {dataset_dir}")

    it = iter(seq)
    first = next(it)
    H, W = first.intensity.shape

    i_mm = np.lib.format.open_memmap(
        out / "intensity.u8.npy", mode="w+", dtype=np.uint8, shape=(n_total, H, W)
    )
    d_mm = np.lib.format.open_memmap(
        out / "depth.u16.npy", mode="w+", dtype=np.uint16, shape=(n_total, H, W)
    )
    ts = np.empty(n_total, dtype=np.float64)
    ts_d = np.empty(n_total, dtype=np.float64)

    def store(k: int, fr: RGBDFrame) -> None:
        inten = np.asarray(fr.intensity)
        if inten.dtype != np.uint8:
            inten = np.clip(inten * 255.0 + 0.5, 0, 255).astype(np.uint8)
        i_mm[k] = inten
        # frames carry metric float depth; counts = depth / scale recovers
        # the original PNG u16 exactly (they were produced as count * scale)
        d_mm[k] = np.clip(
            np.asarray(fr.depth, np.float64) / depth_scale + 0.5, 0, 65535
        ).astype(np.uint16)
        ts[k] = fr.timestamp
        ts_d[k] = getattr(fr, "depth_timestamp", fr.timestamp)

    store(0, first)
    n = 1
    for fr in it:
        if n >= n_total:
            break
        store(n, fr)
        n += 1
    i_mm.flush()
    d_mm.flush()
    np.save(out / "timestamps.f64.npy", ts[:n])
    np.save(out / "depth_timestamps.f64.npy", ts_d[:n])

    meta = {
        "format_version": FORMAT_VERSION,
        "n": int(n),
        "height": int(H),
        "width": int(W),
        "depth_scale": float(depth_scale),
        "pairing": pairing,
        "source": str(dataset_dir),
    }
    (out / META_NAME).write_text(json.dumps(meta, indent=2) + "\n")
    return out


class RawSequence:
    """Zero-decode streaming over a raw-converted sequence directory.

    API-compatible with NativeTUMSequence: len(), iteration yielding
    RGBDFrame (uint8 intensity, float32 metric depth), and read_chunk for
    the buffered device pipeline."""

    def __init__(self, path: str | Path):
        self.root = Path(path)
        meta_file = self.root / META_NAME
        if not meta_file.is_file():
            raise FileNotFoundError(
                f"{meta_file} not found — convert with phovo-convert first"
            )
        self.meta = json.loads(meta_file.read_text())
        version = self.meta.get("format_version")
        if version not in (1, 2):
            raise ValueError(f"unsupported raw format version {version}")
        self._n = int(self.meta["n"])
        self.height = int(self.meta["height"])
        self.width = int(self.meta["width"])
        self.depth_scale = float(self.meta["depth_scale"])
        self._intensity = np.load(self.root / "intensity.u8.npy", mmap_mode="r")
        if version == 1:  # legacy float32 metric depth
            self._depth = np.load(self.root / "depth.f32.npy", mmap_mode="r")
            self.depth_dtype = np.float32
        else:
            self._depth = np.load(self.root / "depth.u16.npy", mmap_mode="r")
            self.depth_dtype = np.uint16
        self._timestamps = np.load(self.root / "timestamps.f64.npy")
        dts = self.root / "depth_timestamps.f64.npy"
        self._depth_timestamps = (
            np.load(dts) if dts.is_file() else self._timestamps
        )
        self._cursor = 0

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[RGBDFrame]:
        # restartable random-access iteration (unlike the streaming native
        # loader); the chunk cursor below is independent — the chunked
        # pipeline primes via read_chunk(1), never via iteration
        for k in range(self._n):
            depth = self._depth[k]
            if depth.dtype != np.float32:  # frame mode wants metric float
                depth = depth.astype(np.float32) * np.float32(self.depth_scale)
            yield RGBDFrame(
                timestamp=float(self._timestamps[k]),
                depth_timestamp=float(self._depth_timestamps[k]),
                intensity=self._intensity[k],
                depth=depth,
            )

    def read_chunk(self, n: int, H: int, W: int):
        """Next up-to-n frames as contiguous (m,H,W) slices (m==0 at end).

        Returns views of the memmaps in STORAGE dtype (uint8 intensity,
        uint16 depth counts for v2) — jnp.asarray copies them straight into
        the transfer buffer and the jitted aligner converts on device; no
        Python-side pixel work. Callers scale v2 depth by self.depth_scale
        (v1 files return float32 metric depth directly)."""
        if (H, W) != (self.height, self.width):
            raise IOError(
                f"sequence is {self.height}x{self.width}, expected {H}x{W}"
            )
        k0 = self._cursor
        k1 = min(k0 + n, self._n)
        self._cursor = k1
        return (
            self._intensity[k0:k1],
            self._depth[k0:k1],
            self._timestamps[k0:k1],
        )

    def close(self) -> None:
        pass
