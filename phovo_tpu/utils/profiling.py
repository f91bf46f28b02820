"""Tracing / profiling / metrics utilities (SURVEY §5).

The reference's only instrumentation is cv::TickMeter wall-clock prints
(PhotoconsistencyFrameAlignment.cpp:99-102) and per-iteration timing behind a
compile-time define (CPhotoconsistencyOdometryAnalytic.h:40,512-514).
Equivalents provided here:

  - `Stopwatch`: host wall-clock with device synchronization — stop(*arrays)
    blocks on the arrays you pass, so measured intervals are real device
    time; `timer(...)`: labeled wall-clock context manager (dispatch time
    for pure jitted work — see its docstring);
  - `trace(...)`: context manager around jax.profiler for full XLA traces
    viewable in TensorBoard/Perfetto;
  - `MetricsLogger`: structured JSONL per-frame metrics (the replacement for
    the reference's stdout prints) — one line per frame with timings,
    per-level iterations, convergence diagnostics.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import jax
import numpy as np


class Stopwatch:
    """Accumulating wall-clock timer that syncs the device before reading."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, *sync_arrays):
        for a in sync_arrays:
            jax.block_until_ready(a)
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


@contextlib.contextmanager
def timer(label: str, *, sync: bool = True, out=print):
    """with timer("align"): ... — prints '<label>: X ms' on exit.

    CAVEAT: a context manager cannot see the arrays produced inside it, so
    it cannot block on them — for PURE jitted work this measures dispatch
    time, not device time (jax.effects_barrier only waits for computations
    with side effects, e.g. jax.debug prints/callbacks). To time device
    work, call jax.block_until_ready(result) inside the block, or use
    Stopwatch.stop(*arrays), which blocks on the arrays you pass it."""
    t0 = time.perf_counter()
    yield
    if sync:
        # Completes outstanding SIDE-EFFECTING dispatches only (see above).
        jax.effects_barrier()
    out(f"{label}: {(time.perf_counter() - t0) * 1e3:.3f} ms")


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """XLA profiler trace (open in TensorBoard's profile plugin or Perfetto)."""
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _to_jsonable(v):
    if isinstance(v, (np.ndarray, jax.Array)):
        arr = np.asarray(v)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str | Path):
        self._f = open(path, "a")

    def log(self, **fields) -> None:
        record = {k: _to_jsonable(v) for k, v in fields.items()}
        record.setdefault("time", time.time())
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
