"""Headline benchmark: RGB-D frame-chain alignment throughput on one GPU.

    python bench.py               # timings; the last line is one JSON object
    python bench.py --trace DIR   # profiler trace of the batched window,
                                  # reduced to device idle share, top ops,
                                  # busy time by kind, iteration runs

Workload: a buffered VGA (640x480) segment of 257 synthetic frames (256
consecutive pairs, utils/synthetic.py make_pair, alternating) aligned in
one dispatch by `align_sequence` — pyramids, Scharr gradients and
coarse-to-fine Gauss-Newton with the reference preset's 5-level schedule
(iterations [0,0,5,20,50], nearest sampling).

Reported, each in its own key:
  value / vs_baseline — FIXED-iteration throughput (min_gradient_norm 0:
    75 GN iterations per pair, identical work every run), frames/s, and
    its ratio to the reference's C++ CPU implementation measured by
    native/baseline_bench (native/baseline_cpu.json);
  early_exit_pairs_per_s — the shipped presets' gradient-norm termination
    (min_gradient_norm 300): what deployment actually serves;
  serial_scan_fps / serial_scan_early_exit_pairs_per_s — the same two
    workloads through the serial per-pair scan (models/base.py
    align_chain with batched=False), the comparison for the batched path.

The lines before the JSON name the device (JAX platform, device kind,
count) and the card's name and power limit. Without a GPU the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

import jax
import numpy as np

REPO = Path(__file__).resolve().parent
BASELINE_JSON = REPO / "native" / "baseline_cpu.json"

H, W = 480, 640
FRAMES = 257
REPEATS = 20
SERIAL_REPEATS = 3
TRACE_CALLS = 3


def bench_config(min_gradient_norm: float = 0.0):
    from phovo_tpu.utils.config import PhovoConfig

    return PhovoConfig(
        num_levels=5,
        blur_filter_sizes=(0, 0, 0, 0, 0),
        gradient_scales=(0.0625,) * 5,
        max_iterations=(0, 0, 5, 20, 50),
        lambda_steps=(1.0,) * 5,
        # 0 never fires (fixed work per align, the headline methodology);
        # 300 is the shipped presets' termination (deployment semantics)
        min_gradient_norms=(min_gradient_norm,) * 5,
        sampling="nearest",
    )


def bench_frames(n: int = FRAMES):
    """(intensities (n, H, W), depths) of alternating synthetic VGA frames,
    on the device."""
    import jax.numpy as jnp

    from phovo_tpu.ops.camera import TUM_FR1
    from phovo_tpu.utils.synthetic import make_pair

    I0, D0, I1, D1, _ = make_pair(TUM_FR1, shape=(H, W))
    reps = (n + 1) // 2
    return (
        jnp.asarray(np.stack([I0, I1] * reps)[:n]),
        jnp.asarray(np.stack([D0, D1] * reps)[:n]),
    )


@functools.partial(jax.jit, static_argnames=("config",))
def serial_chain(intensities, depths, intr, config):
    """The serial per-pair scan over the same segment (zero init)."""
    from phovo_tpu.models.analytic import align_prepped, prep_frame_analytic
    from phovo_tpu.models.base import align_chain

    return align_chain(
        prep_frame_analytic, align_prepped, intensities, depths, intr,
        config, warm_start=False, batched=False,
    )


def reference_cpu_fps() -> float | None:
    if BASELINE_JSON.is_file():
        return float(json.loads(BASELINE_JSON.read_text())["frames_per_second"])
    return None


def _timed(fn, repeats: int) -> float:
    """Seconds per call after two warm-up calls (compile + first run)."""
    for _ in range(2):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / repeats


def union_ns(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def op_kind(name: str) -> str:
    """Coarse kind of a device operation, for the split of busy time."""
    n = name.lower()
    if "gemm" in n:
        return "gemm"
    if "memcpy" in n or n.startswith("copy"):
        return "copy"
    if "dot" in n:
        return "dot"
    if "transpose" in n or "concatenate" in n:
        return "transpose/concatenate"
    if "fusion" in n:
        return "other fusion"
    return "other"


def iteration_runs(events, rel: float = 0.25) -> list[dict]:
    """The window's while-loop iterations, grouped into runs.

    Every while-loop iteration ends in a MemcpyD2H of its predicate to the
    host. Segment k holds the device events after copy k-1, up to and
    including copy k: its busy time is the union of their intervals, its
    gap the idle time between copy k-1's end and its first event.
    Consecutive segments whose busy times lie within `rel` of their run's
    first one make one run (one pyramid level's iterations; prep and level
    changes form runs of their own). Each run: n segments, median busy
    and median gap in microseconds."""
    segments, cur, prev_end = [], [], None
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        cur.append((s, e))
        if name == "MemcpyD2H":
            gap = (min(a for a, _ in cur) - prev_end) if prev_end else None
            segments.append((union_ns(cur), gap))
            cur, prev_end = [], e
    runs: list[list] = []
    for busy, gap in segments:
        if runs and abs(busy - runs[-1][0][0]) <= rel * runs[-1][0][0]:
            runs[-1].append((busy, gap))
        else:
            runs.append([(busy, gap)])
    out = []
    for run in runs:
        gaps = [g for _, g in run if g is not None]
        out.append({
            "n": len(run),
            "busy_us": float(np.median([b for b, _ in run])) / 1e3,
            "gap_us": float(np.median(gaps)) / 1e3 if gaps else None,
        })
    return out


def trace_summary(xplane_path: str, window_name: str, top: int = 12) -> dict:
    """Device busy/idle share, top operations, busy time by kind of
    operation and the while-loop iteration runs of a jax.profiler trace.

    The window is the host span named `window_name`
    (jax.profiler.TraceAnnotation); device events are those on the GPU
    planes' stream lines. Busy is the union of the device events' intervals
    inside the window; idle share is 1 - busy / window. The kind shares sum
    event durations (op_kind), so they are shares of summed kernel time."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    win = None
    events = []
    for plane in pd.planes:
        gpu = plane.name.startswith("/device:GPU")
        for line in plane.lines:
            if gpu and line.name.startswith("Stream"):
                events += [
                    (e.name, e.start_ns, e.start_ns + e.duration_ns)
                    for e in line.events
                ]
            elif not gpu:
                for e in line.events:
                    if e.name == window_name:
                        win = (e.start_ns, e.start_ns + e.duration_ns)
    if win is None and events:
        win = (min(e[1] for e in events), max(e[2] for e in events))
    inside = [
        (n, max(s, win[0]), min(e, win[1])) for n, s, e in events
        if e > win[0] and s < win[1]
    ] if win else []
    busy = union_ns([(s, e) for _, s, e in inside])
    by_name: dict[str, float] = {}
    by_kind: dict[str, float] = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        by_kind[op_kind(n)] = by_kind.get(op_kind(n), 0.0) + (e - s)
    total = sum(by_kind.values())
    span = (win[1] - win[0]) if win else 0.0
    return {
        "window_ns": span,
        "device_busy_ns": busy,
        "device_idle_share": (1.0 - busy / span) if span else None,
        "device_events": len(inside),
        "top_ops_ns": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "kind_share": {k: v / total for k, v in sorted(by_kind.items())},
        "iteration_runs": iteration_runs(inside),
    }


def run_trace(trace_dir: str) -> int:
    import glob

    from phovo_tpu.models.analytic import align_sequence
    from phovo_tpu.ops.camera import TUM_FR1

    cfg = bench_config()
    Is, Ds = bench_frames()
    for _ in range(2):
        jax.block_until_ready(align_sequence(Is, Ds, TUM_FR1, cfg).state)
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation("bench_window"):
            for _ in range(TRACE_CALLS):
                out = align_sequence(Is, Ds, TUM_FR1, cfg)
            jax.block_until_ready(out.state)
    paths = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    summary = trace_summary(paths[-1], "bench_window")
    summary["calls"] = TRACE_CALLS
    summary["trace"] = paths[-1]
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="trace the batched fixed-iteration window into DIR "
                         "and print its device idle share, top ops, busy "
                         "time by kind and while-loop iteration runs")
    args = ap.parse_args(argv)

    from phovo_tpu.apps._bootstrap import enable_compilation_cache
    from phovo_tpu.utils.device import (
        gpu_name_and_power_limit,
        print_device,
        require_gpu,
    )

    dev = print_device(require_gpu())
    enable_compilation_cache()
    if args.trace:
        return run_trace(args.trace)

    from phovo_tpu.models.analytic import align_sequence
    from phovo_tpu.ops.camera import TUM_FR1

    Is, Ds = bench_frames()
    n_pairs = FRAMES - 1
    out = {}
    for key, cfg in (("fixed", bench_config()), ("early_exit", bench_config(300.0))):
        out[key] = _timed(
            lambda: align_sequence(Is, Ds, TUM_FR1, cfg).state, REPEATS
        )
        out["serial_" + key] = _timed(
            lambda: serial_chain(Is, Ds, TUM_FR1, cfg).state, SERIAL_REPEATS
        )
    fps = n_pairs / out["fixed"]
    base = reference_cpu_fps()
    print(
        json.dumps(
            {
                "metric": "frame_alignment_throughput",
                "value": fps,
                "unit": "frames/s (640x480, 5-level, 75 GN iters)",
                "vs_baseline": (fps / base) if base else None,
                "early_exit_pairs_per_s": n_pairs / out["early_exit"],
                "serial_scan_fps": n_pairs / out["serial_fixed"],
                "serial_scan_early_exit_pairs_per_s": (
                    n_pairs / out["serial_early_exit"]
                ),
                "device": dev,
                "gpu": gpu_name_and_power_limit(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
