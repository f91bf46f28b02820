"""Keyframe-tracking throughput bench: batched shared-keyframe tracking vs
the serial warm-start scan and the frame chain.

The analytic and trust-region keyframe trackers (models/keyframe.py
track_chunk, one keyframe shared by a chunk of tracked frames) against the
frame-chain batched path (align_sequence) and the serial warm-start track.
VGA, 256-frame chunks, the headline 5-level schedule. Prints the device
(platform, kind, count, the card's name and power limit) and one JSON line
per path.

Usage:  python -m tools.track_bench [--chunk 256] [--repeats 10]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from phovo_tpu.apps._bootstrap import enable_compilation_cache
    from phovo_tpu.models.analytic import align_prepped, align_sequence
    from phovo_tpu.models.autodiff import align_prepped_tr
    from phovo_tpu.models.keyframe import prep_keyframe, track_chunk
    from phovo_tpu.ops.camera import TUM_FR1
    from phovo_tpu.utils.config import PhovoConfig
    from phovo_tpu.utils.device import print_device
    from phovo_tpu.utils.synthetic import make_pair

    dev = print_device()
    enable_compilation_cache()
    H, W = 480, 640
    B = args.chunk
    REP = args.repeats

    def gn_cfg(mg):
        return PhovoConfig(
            num_levels=5, blur_filter_sizes=(0,) * 5,
            gradient_scales=(0.0625,) * 5, max_iterations=(0, 0, 5, 20, 50),
            lambda_steps=(1.0,) * 5, min_gradient_norms=(mg,) * 5,
            sampling="nearest",
        )

    tr_cfg = PhovoConfig(
        num_levels=5, blur_filter_sizes=(0,) * 5,
        gradient_scales=(0.0625,) * 5, max_iterations=(0, 0, 5, 10, 50),
        function_tolerances=(1e-4,) * 5, gradient_tolerances=(1e-3,) * 5,
        parameter_tolerances=(1e-6,) * 5,
        initial_trust_region_radii=(1e4,) * 5,
        max_trust_region_radii=(1e8,) * 5,
        min_trust_region_radii=(1e-32,) * 5,
        min_relative_decreases=(1e-3,) * 5,
        sampling="bilinear",
    )

    I0, D0, I1, D1, _ = make_pair(TUM_FR1, shape=(H, W))
    Is = jnp.asarray(np.stack([I0, I1] * (B // 2)))
    Is2 = jnp.asarray(np.stack([I0, I1] * ((B + 2) // 2))[: B + 1])
    Ds2 = jnp.asarray(np.stack([D0, D1] * ((B + 2) // 2))[: B + 1])
    kfI, kfD = jnp.asarray(I0), jnp.asarray(D0)
    inits = jnp.zeros((B, 6), jnp.float32)

    def timed(label, fn):
        fn()
        fn()
        t0 = time.perf_counter()
        for _ in range(REP):
            out = fn()
        jax.block_until_ready(out)
        print(json.dumps(
            {"path": label,
             "pairs_per_s": REP * B / (time.perf_counter() - t0),
             "device": dev}
        ))

    for name, mg in (("fixed-75", 0.0), ("early-exit", 300.0)):
        cfg = gn_cfg(mg)
        kf = prep_keyframe(kfI, kfD, TUM_FR1, cfg)
        timed(
            f"analytic track batched {name}",
            lambda: track_chunk(
                kf, Is, TUM_FR1, inits, cfg, align_prepped, False
            ).state,
        )
        timed(
            f"analytic frame chain {name}",
            lambda: align_sequence(Is2, Ds2, TUM_FR1, cfg).state,
        )
        timed(
            f"analytic track serial scan {name}",
            lambda: track_chunk(
                kf, Is, TUM_FR1, inits, cfg, align_prepped, True
            ).state,
        )
    kf_tr = prep_keyframe(kfI, kfD, TUM_FR1, tr_cfg)
    timed(
        "tr track batched",
        lambda: track_chunk(
            kf_tr, Is, TUM_FR1, inits, tr_cfg, align_prepped_tr, False
        ).state,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
