"""TUM RGB-D dataset streaming.

Re-design of the reference's data-source stack (L3 in SURVEY §1):
CCameraRecord index-file parsing (CCameraRecord.h:63-113),
CImageReader grayscale/16-bit decode (CImageReader.h:43-83), and
CMultiSensorDataSource lockstep pairing (CMultiSensorDataSource.h:74-91)
— collapsed into plain Python iterators plus an optional timestamp
associator (the reference pairs strictly line-by-line with no timestamp
matching; TUM rgb/depth streams are NOT aligned, so association is the
correct default for real sequences and lockstep remains for parity).

Decode happens host-side (cv2); `prefetch_to_device` overlaps decode with
device compute via a background thread, the analog of the
reference's pull-based Start()/GetData() streaming.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator, NamedTuple

import numpy as np

# Depth scaling: TUM depth PNGs store depth * 5000 (reference:
# PhotoconsistencyVisualOdometry.cpp:163), frame-alignment app uses 1/1000
# (PhotoconsistencyFrameAlignment.cpp:76-80).
TUM_DEPTH_SCALE = 1.0 / 5000.0


class IndexEntry(NamedTuple):
    timestamp: float
    path: Path


@dataclasses.dataclass
class RGBDFrame:
    timestamp: float  # intensity timestamp (reference writes this one)
    depth_timestamp: float
    intensity: np.ndarray  # (H, W) uint8 grayscale
    depth: np.ndarray  # (H, W) float32 meters (0 = invalid)


def read_index(index_file: str | Path) -> list[IndexEntry]:
    """Parse a TUM index file: lines of 'timestamp filename', '#' comments
    skipped, paths resolved relative to the index file's directory
    (reference parsing: CCameraRecord.h:77-100)."""
    index_file = Path(index_file)
    if not index_file.is_file():
        raise FileNotFoundError(f"cannot open record file {index_file}")
    base = index_file.parent
    entries = []
    for line in index_file.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        entries.append(IndexEntry(float(parts[0]), base / parts[1]))
    return entries


def associate(
    a: list[IndexEntry], b: list[IndexEntry], max_dt: float = 0.02
) -> list[tuple[IndexEntry, IndexEntry]]:
    """Greedy nearest-timestamp association (standard TUM associate.py
    algorithm): all |ta - tb| <= max_dt candidate pairs sorted by distance,
    claimed greedily. Delegates to the shared vectorized implementation
    (utils/trajectory.py associate_timestamps) — the naive double loop cost
    tens of seconds of startup on real ~3000-frame sequences."""
    from phovo_tpu.utils.trajectory import associate_timestamps

    ia, ib = associate_timestamps(
        np.asarray([e.timestamp for e in a], np.float64),
        np.asarray([e.timestamp for e in b], np.float64),
        max_dt,
    )
    return [(a[i], b[j]) for i, j in zip(ia, ib)]


def _load_intensity(path: Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)  # reference flag 0
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img


def _load_depth(path: Path, depth_scale: float) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)  # reference flag -1
    if img is None:
        raise IOError(f"cannot read image {path}")
    return img.astype(np.float32) * depth_scale


class TUMSequence:
    """Iterable of RGBDFrame over a TUM sequence directory.

    pairing='lockstep' reproduces the reference's line-by-line pairing
    (CMultiSensorDataSource.h:74-91: stop at the end of ANY stream);
    pairing='associate' does nearest-timestamp matching.
    """

    def __init__(
        self,
        root: str | Path,
        rgb_index: str = "rgb.txt",
        depth_index: str = "depth.txt",
        depth_scale: float = TUM_DEPTH_SCALE,
        pairing: str = "associate",
        max_dt: float = 0.02,
    ):
        root = Path(root)
        self.rgb_entries = read_index(root / rgb_index)
        self.depth_entries = read_index(root / depth_index)
        self.depth_scale = depth_scale
        if pairing == "lockstep":
            n = min(len(self.rgb_entries), len(self.depth_entries))
            self.pairs = list(zip(self.rgb_entries[:n], self.depth_entries[:n]))
        elif pairing == "associate":
            self.pairs = associate(self.rgb_entries, self.depth_entries, max_dt)
        else:
            raise ValueError(f"unknown pairing {pairing!r}")

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self) -> Iterator[RGBDFrame]:
        for rgb, dep in self.pairs:
            yield RGBDFrame(
                timestamp=rgb.timestamp,
                depth_timestamp=dep.timestamp,
                intensity=_load_intensity(rgb.path),
                depth=_load_depth(dep.path, self.depth_scale),
            )


def prefetch(frames: Iterable[RGBDFrame], depth: int = 2) -> Iterator[RGBDFrame]:
    """Background-thread prefetch: decode frame k+1..k+depth while the
    device aligns frame k."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for f in frames:
                q.put(f)
        except BaseException as e:  # propagate decode errors to consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
