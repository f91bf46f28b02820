"""Smoke run of the whole system on one GPU, at full VGA width.

    python chip_smoke.py              # every phase, one card
    python chip_smoke.py --devices 4  # only the four-card phase

Everything runs in this one process, so one JAX process holds the card.
Phases, in order; any failure ends the run with a non-zero exit:

  device   JAX must see a GPU (no CPU fallback); prints its kind, the
           device count, and the card's name and power limit (nvidia-smi,
           in a child process that does not use JAX).
  compile  compiles the benchmark's chunk program (bench.py: 257 VGA frames,
           5-level schedule) and prints its memory analysis.
  parity   at 480x640: packed-gather normal equations against the reference
           residual path; the batched level-major chain against the serial
           per-pair scan for every backend, at a fixed schedule and with
           early exit (bench.py's own early-exit workload among them);
           ground-truth pose recovery.
  vo/serve phovo-vo frame mode --chunk 32 with each backend, keyframe mode
           --chunk with analytic and ceres, phovo-serve with 4 streams; each
           trajectory scored by phovo-eval against the synthetic ground
           truth under an ATE bound. The shipped analytic preset (early
           exit) through --chunk 32 against the per-frame path.
  gpu tests  the `gpu`-marked tests (tests/test_gpu_device.py).

--devices 4 runs only the path users spread over cards: phovo-serve
--devices 4 against --devices 1 on the same streams, and the sharded pose
graph and bundle adjustment against a 1-device mesh, on a (data, pixel)
mesh over jax.devices()[:4].

Frames are synthetic, rendered from a seed (utils/synthetic.py) and written
in the raw memmap layout (datasets/raw.py) with numpy only. The last line
of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
H, W = 480, 640
SEED = 0
VO_FRAMES = 65  # two --chunk 32 dispatches after the priming frame
SERVE_STREAMS = 4

# ATE bound for every trajectory of the vo/serve phase. The synthetic
# sequence moves ~1.3 cm and ~0.3 deg per frame over a textured plane
# (utils/synthetic.py smooth_trajectory). A motionless estimate scores
# 0.128 m ATE on it; the configs below recover each pair to ~1e-3 or
# better, so 65 frames of integrated drift stay well under 2 cm.
ATE_BOUND_M = 0.02

# The Gauss-Newton backends (analytic, bi-objective, IC) run the shipped
# 5-level schedule to convergence: bilinear sampling, gradient-norm exit
# effectively off. The shipped preset's exit (min_gradient_norm 300) stops
# after one iteration per level on these frames and drifts ~3 cm over the
# sequence, which no bound can tell apart from a subtle fault.
SMOKE_GN_YAML = """\
%YAML:1.0
# 5-level schedule of config_5_level_optimization_analytic, run to convergence
numOptimizationLevels: 5
blurFilterSize (at each level): [0, 0, 0, 0, 0]
imageGradientsScalingFactor (at each level): [0.0625, 0.0625, 0.0625, 0.0625, 0.0625]
lambda_optimization_step (at each level): [1, 1, 1, 1, 1]
max_num_iterations (at each level): [0, 0, 5, 20, 50]
min_gradient_norm (at each level): [1e-9, 1e-9, 1e-9, 1e-9, 1e-9]
sampling: 'bilinear'
"""


def phase(name: str) -> float:
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name: str, t0: float) -> None:
    print(f"== {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


# -- device -------------------------------------------------------------------


def phase_device() -> dict:
    t0 = phase("device")
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"error: JAX found no GPU (platform {devs[0].platform!r}); "
            "chip_smoke runs on the card only"
        )
    sys.path.insert(0, str(REPO))
    from phovo_tpu.apps._bootstrap import enable_compilation_cache
    from phovo_tpu.utils.device import print_device

    dev = print_device()
    print(f"compile cache: {enable_compilation_cache()}")
    done("device", t0)
    return dev


# -- compile ------------------------------------------------------------------


def phase_compile() -> None:
    t0 = phase("compile")
    import jax.numpy as jnp

    import bench
    from phovo_tpu.models.analytic import align_sequence
    from phovo_tpu.ops.camera import TUM_FR1

    spec = jnp.zeros((bench.FRAMES, H, W), jnp.float32)
    compiled = align_sequence.lower(
        spec, spec, TUM_FR1, config=bench.bench_config()
    ).compile()
    print(compiled.memory_analysis())
    done("compile", t0)


# -- parity -------------------------------------------------------------------


def _check(what: str, got, want, atol: float, rtol: float = 0.0) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) - rtol * np.abs(want)))
    print(f"  {what}: max excess error {err:.3e} (atol {atol:g}, rtol {rtol:g})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _chain_configs():
    """(backend, prep_frame, align_prepped, config) for the batched-vs-serial
    parity, each backend with its shipped 5-level preset at fixed
    iterations (gradient-norm and tolerance exits off: every pair runs the
    whole schedule, so the two orders do identical work) and bilinear
    sampling. With nearest sampling the cost is piecewise constant and 75
    fixed iterations wander between neighbouring pixels, so last-bit
    differences between the two reduction orders grow to centimetres; with
    bilinear sampling the iteration settles and the orders agree to ~1e-7
    (XLA's CPU backend, 640x480)."""
    import dataclasses

    from phovo_tpu.models.analytic import align_prepped, prep_frame_analytic
    from phovo_tpu.models.autodiff import align_prepped_tr
    from phovo_tpu.models.biobjective import (
        align_prepped_biobjective,
        prep_frame_biobjective,
    )
    from phovo_tpu.models.ic import align_prepped_ic, prep_frame_ic
    from phovo_tpu.utils.config import load_builtin

    gn = load_builtin("config_5_level_optimization_analytic")
    gn = dataclasses.replace(
        gn, min_gradient_norms=(0.0,) * gn.num_levels, sampling="bilinear"
    )
    tr = load_builtin("config_5_level_optimization_ceres")
    tr = dataclasses.replace(
        tr,
        function_tolerances=(0.0,) * tr.num_levels,
        gradient_tolerances=(0.0,) * tr.num_levels,
        parameter_tolerances=(0.0,) * tr.num_levels,
    )
    return [
        ("analytic", prep_frame_analytic, align_prepped, gn),
        ("ceres", prep_frame_analytic, align_prepped_tr, tr),
        ("biobjective", prep_frame_biobjective, align_prepped_biobjective, gn),
        ("ic", prep_frame_ic, align_prepped_ic, gn),
    ]


def _early_exit_configs():
    """(label, prep_frame, align_prepped, config, same_iterations) for the
    early-exit parity: each pair leaves the vmapped while_loop on its own
    and is frozen there while the batch runs on.

    - bench: bench.py's early-exit workload (nearest sampling,
      min_gradient_norm 300), run below through align_sequence and
      bench.serial_chain themselves;
    - analytic-bilinear-3: the same schedule with bilinear sampling and
      min_gradient_norm 3, where the pairs stop after different iteration
      counts (2-5 per level on XLA's CPU backend);
    - biobjective, ic, ceres: each backend's shipped 5-level preset as it
      ships (its own sampling and exits).

    same_iterations: the gradient-norm exit of the GN backends compares
    ||J^T r|| with its threshold; on these frames no pair's norm lies
    within reassociation noise of it, so both orders stop at the same
    iteration. The
    trust-region preset stops on relative changes of 1e-4..1e-6 of the
    cost and the parameters; near convergence those changes are float32
    rounding, so the stopping iteration moves with the reduction order
    (up to 17 iterations at the finest level on XLA's CPU backend) while
    the states agree to ~2e-7. Its iteration counts are not compared."""
    import dataclasses

    import bench
    from phovo_tpu.models.analytic import align_prepped, prep_frame_analytic
    from phovo_tpu.models.autodiff import align_prepped_tr
    from phovo_tpu.models.biobjective import (
        align_prepped_biobjective,
        prep_frame_biobjective,
    )
    from phovo_tpu.models.ic import align_prepped_ic, prep_frame_ic
    from phovo_tpu.utils.config import load_builtin

    gn = load_builtin("config_5_level_optimization_analytic")
    varied = dataclasses.replace(bench.bench_config(3.0), sampling="bilinear")
    return [
        ("bench", prep_frame_analytic, align_prepped, bench.bench_config(300.0),
         True),
        ("analytic-bilinear-3", prep_frame_analytic, align_prepped, varied,
         True),
        ("biobjective", prep_frame_biobjective, align_prepped_biobjective, gn,
         True),
        ("ic", prep_frame_ic, align_prepped_ic, gn, True),
        ("ceres", prep_frame_analytic, align_prepped_tr,
         load_builtin("config_5_level_optimization_ceres"), False),
    ]


def phase_parity() -> None:
    t0 = phase("parity (480x640)")
    import functools

    import jax
    import jax.numpy as jnp

    from phovo_tpu.models.analytic import align_analytic
    from phovo_tpu.models.base import align_chain
    from phovo_tpu.ops import fused, pyramid
    from phovo_tpu.ops.camera import TUM_FR1
    from phovo_tpu.ops.residuals import (
        normal_equations,
        photometric_residual_jacobian,
    )
    from phovo_tpu.utils.synthetic import make_pair, make_sequence

    I0, D0, I1, D1, gt = map(jnp.asarray, make_pair(TUM_FR1, shape=(H, W)))

    # 1. packed gather vs the reference residual path (separate gathers).
    # Both sum 307,200 float32 terms per entry in different orders, so the
    # sums agree to a few parts in 1e5 of their magnitude; the valid-pixel
    # sets are the same predicate on the same coordinates (exact).
    gx = pyramid.scharr(I1, "x", 0.0625)
    gy = pyramid.scharr(I1, "y", 0.0625)
    state = jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.008, 0.012], jnp.float32)
    for sampling in ("nearest", "bilinear"):
        ne = jax.jit(fused.packed_normal_equations, static_argnums=(5, 6, 7))(
            I0, D0, fused.pack_target(I1, gx, gy), state, TUM_FR1,
            0.3, 5.0, sampling,
        )
        r, J, v = photometric_residual_jacobian(
            I0, D0, I1, gx, gy, state, TUM_FR1, sampling=sampling
        )
        ref = normal_equations(r, J, v)
        _check(f"packed JtJ ({sampling})", ne.JtJ, ref.JtJ,
               atol=5e-5 * float(jnp.abs(ref.JtJ).max()))
        _check(f"packed Jtr ({sampling})", ne.Jtr, ref.Jtr,
               atol=5e-5 * float(jnp.abs(ref.Jtr).max()))
        _check(f"packed cost ({sampling})", ne.cost, ref.cost, 0.0, rtol=5e-5)
        _check(f"packed num_valid ({sampling})", ne.num_valid, ref.num_valid, 0.0)

    # 2. batched level-major chain vs the serial per-pair scan, per backend,
    # on 9 frames (8 pairs). Every pair runs the full fixed schedule in
    # both orders; only the reduction order inside each linearization
    # differs (batched vs single reductions). 1e-4 (0.1 mm, 0.006 deg) is
    # far above that reassociation noise and far below any misrouted pair.
    I, D, _, _ = make_sequence(TUM_FR1, (H, W), n_frames=9, seed=SEED)
    Is, Ds = jnp.asarray(np.stack(I)), jnp.asarray(np.stack(D))
    for backend, prep, align, cfg in _chain_configs():
        chain = jax.jit(
            functools.partial(align_chain, prep, align),
            static_argnames=("config", "warm_start", "batched"),
        )
        batched = chain(Is, Ds, TUM_FR1, config=cfg, warm_start=False, batched=True)
        serial = chain(Is, Ds, TUM_FR1, config=cfg, warm_start=False, batched=False)
        np.testing.assert_array_equal(
            np.asarray(batched.iterations), np.asarray(serial.iterations),
            err_msg=f"{backend} iterations",
        )
        _check(f"{backend} batched vs serial states", batched.state,
               serial.state, atol=1e-4)
        assert np.all(np.isfinite(np.asarray(batched.state)))

    # 3. early exit: every pair stops on its own (see _early_exit_configs).
    # The bench case runs bench.py's own entry points. At least one pair
    # must stop before its level's max_iterations, or the case would not
    # test the freeze; same 1e-4 state bound as above.
    import bench
    from phovo_tpu.models.analytic import align_sequence

    for label, prep, align, cfg, same_its in _early_exit_configs():
        if label == "bench":
            batched = align_sequence(Is, Ds, TUM_FR1, cfg)
            serial = bench.serial_chain(Is, Ds, TUM_FR1, cfg)
        else:
            chain = jax.jit(
                functools.partial(align_chain, prep, align),
                static_argnames=("config", "warm_start", "batched"),
            )
            batched = chain(Is, Ds, TUM_FR1, config=cfg, warm_start=False,
                            batched=True)
            serial = chain(Is, Ds, TUM_FR1, config=cfg, warm_start=False,
                           batched=False)
        its = np.asarray(batched.iterations)
        full = np.asarray(cfg.max_iterations)
        active = full > 0
        print(f"  {label} early exit: iterations per level, pair 0..7: "
              f"{its[:, active].tolist()}")
        if same_its:
            np.testing.assert_array_equal(
                its, np.asarray(serial.iterations),
                err_msg=f"{label} early-exit iterations",
            )
        if not (its[:, active] < full[active]).any():
            raise RuntimeError(f"{label}: no pair stopped early ({its})")
        if label == "analytic-bilinear-3" and len({tuple(r) for r in its}) < 2:
            raise RuntimeError(f"{label}: every pair stopped alike ({its})")
        _check(f"{label} early exit batched vs serial states", batched.state,
               serial.state, atol=1e-4)
        assert np.all(np.isfinite(np.asarray(batched.state)))

    # 4. ground-truth recovery: the 5-level schedule run to convergence
    # (bilinear, no early exit) recovers the synthetic relative pose to
    # ~1e-4 on XLA's CPU backend; 2e-3 (2 mm, 0.11 deg) leaves room for
    # the card's reduction order and catches any wrong convention.
    res = align_analytic(I0, D0, I1, D1, TUM_FR1, jnp.zeros(6),
                         _chain_configs()[0][3])
    _check("ground-truth pose", res.state, gt, atol=2e-3)
    done("parity", t0)


# -- vo / serve ---------------------------------------------------------------


def write_raw_sequence(root: Path, n: int, seed: int) -> Path:
    """A synthetic VGA sequence in the raw memmap layout of datasets/raw.py
    (uint8 intensity, uint16 depth counts, timestamps, meta.json) plus its
    TUM-format groundtruth.txt — numpy only, no image codec."""
    from phovo_tpu.ops.camera import TUM_FR1
    from phovo_tpu.utils.synthetic import make_sequence
    from phovo_tpu.utils.trajectory import format_pose_line

    scale = 1.0 / 5000.0
    I, D, gts, ts = make_sequence(TUM_FR1, (H, W), n_frames=n, seed=seed)
    root.mkdir(parents=True, exist_ok=True)
    np.save(root / "intensity.u8.npy",
            np.clip(np.stack(I) * 255.0 + 0.5, 0, 255).astype(np.uint8))
    np.save(root / "depth.u16.npy",
            np.clip(np.stack(D) / scale + 0.5, 0, 65535).astype(np.uint16))
    np.save(root / "timestamps.f64.npy", ts)
    np.save(root / "depth_timestamps.f64.npy", ts)
    (root / "groundtruth.txt").write_text(
        "\n".join(format_pose_line(t, g) for t, g in zip(ts, gts)) + "\n"
    )
    (root / "meta.json").write_text(json.dumps({
        "format_version": 2, "n": n, "height": H, "width": W,
        "depth_scale": scale, "pairing": "associate",
        "source": f"utils/synthetic.py make_sequence seed={seed}",
    }))
    return root


def score(gt: Path, traj: Path, label: str) -> float:
    """ATE rmse of `traj` by phovo-eval; fails above ATE_BOUND_M."""
    from phovo_tpu.apps import phovo_eval

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = phovo_eval.main([str(gt), str(traj), "--mode", "ate", "--json"])
    if rc != 0:
        raise RuntimeError(f"{label}: phovo-eval exited {rc}")
    ate = json.loads(buf.getvalue())["ate"]
    print(f"  {label}: ATE rmse {ate['rmse']:.6f} m over {ate['num_pairs']} "
          f"poses (bound {ATE_BOUND_M} m)", flush=True)
    if not (ate["rmse"] <= ATE_BOUND_M and ate["num_pairs"] >= 8):
        raise RuntimeError(f"{label}: ATE {ate} outside the bound")
    return ate["rmse"]


def serve_argv(cfg: Path, out_dir: Path, devices: int, seqs) -> list[str]:
    """phovo-serve arguments: one stream per raw sequence, 16-frame chunks."""
    argv = ["--config", str(cfg), "--intrinsics", "fr1", "--out-dir",
            str(out_dir), "--quiet", "--chunk", "16", "--devices", str(devices)]
    for s in seqs:
        argv += ["--dataset", str(s)]
    return argv


def run_cli(main, argv: list[str], label: str) -> float:
    t0 = time.perf_counter()
    rc = main(argv)
    dt = time.perf_counter() - t0
    print(f"  {label}: exit {rc}, {dt:.1f} s (compile included)", flush=True)
    if rc != 0:
        raise RuntimeError(f"{label}: exit {rc}")
    return dt


def phase_vo_serve(work: Path) -> None:
    t0 = phase("vo / serve")
    from phovo_tpu.apps import phovo_serve, phovo_vo
    from phovo_tpu.utils.config import builtin_config_dir
    from phovo_tpu.utils.trajectory import read_trajectory

    seqs = [write_raw_sequence(work / f"seq{s}", VO_FRAMES, SEED + s)
            for s in range(SERVE_STREAMS)]
    gt = seqs[0] / "groundtruth.txt"
    gn_cfg = work / "smoke_gn.yml"
    gn_cfg.write_text(SMOKE_GN_YAML)
    configs = {
        "analytic": gn_cfg,
        "ceres": builtin_config_dir() / "config_5_level_optimization_ceres.yml",
        "biobjective": gn_cfg,
        "ic": gn_cfg,
    }

    runs = [(b, "frame", "32") for b in ("analytic", "ceres", "biobjective", "ic")]
    runs += [(b, "keyframe", "8") for b in ("analytic", "ceres")]
    for backend, mode, chunk in runs:
        label = f"phovo-vo {backend} --mode {mode} --chunk {chunk}"
        out = work / f"vo_{backend}_{mode}.txt"
        argv = [
            "--config", str(configs[backend]),
            "--dataset", str(seqs[0]), "--intrinsics", "fr1",
            "--backend", backend, "--mode", mode, "--chunk", chunk,
            "--output", str(out), "--quiet",
        ]
        run_cli(phovo_vo.main, argv, label)
        score(gt, out, label)

    # The shipped analytic preset as it ships (nearest sampling, gradient-
    # norm exit 300: ~1 iteration per level): the batched --chunk 32 path
    # against the per-frame path (--chunk 1: one pair per dispatch, the
    # reference's loop), pose by pose. Each relative pose agrees to ~1e-6
    # (parity phase, bench case); positions integrate 64 of them.
    shipped = builtin_config_dir() / "config_5_level_optimization_analytic.yml"
    trajs = {}
    for chunk in ("32", "1"):
        label = f"phovo-vo analytic shipped preset --chunk {chunk}"
        out = work / f"vo_shipped_{chunk}.txt"
        run_cli(phovo_vo.main, [
            "--config", str(shipped), "--dataset", str(seqs[0]),
            "--intrinsics", "fr1", "--backend", "analytic", "--chunk", chunk,
            "--output", str(out), "--quiet",
        ], label)
        trajs[chunk] = read_trajectory(out)
    _check("shipped preset --chunk 32 vs --chunk 1 positions",
           trajs["32"].positions, trajs["1"].positions, atol=1e-4)

    serve_dir = work / "serve"
    run_cli(phovo_serve.main, serve_argv(gn_cfg, serve_dir, 1, seqs),
            f"phovo-serve {SERVE_STREAMS} streams")
    for s in seqs:
        score(s / "groundtruth.txt", serve_dir / f"{s.name}.txt",
              f"phovo-serve {s.name}")
    done("vo / serve", t0)


# -- gpu tests ----------------------------------------------------------------


def phase_gpu_tests() -> None:
    t0 = phase("gpu tests")
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    count = Count()
    rc = pytest.main(
        [str(REPO / "tests" / "test_gpu_device.py"), "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "--rootdir", str(REPO)],
        plugins=[count],
    )
    print(f"  gpu tests: exit {int(rc)}, {count.passed} passed", flush=True)
    if int(rc) != 0 or count.passed == 0:
        raise RuntimeError(f"gpu tests failed (exit {int(rc)})")
    done("gpu tests", t0)


# -- four cards ---------------------------------------------------------------


def phase_four_devices(work: Path, n: int) -> None:
    t0 = phase(f"{n} devices")
    import jax
    import jax.numpy as jnp

    from phovo_tpu.apps import phovo_serve
    from phovo_tpu.ops.camera import TUM_FR1
    from phovo_tpu.parallel.bundle_adjustment import (
        make_synthetic_ba,
        optimize_bundle,
    )
    from phovo_tpu.parallel.mesh import make_mesh
    from phovo_tpu.parallel.pose_graph import chain_to_graph, optimize_pose_graph
    from phovo_tpu.utils.trajectory import read_trajectory

    if len(jax.devices()) < n:
        raise SystemExit(f"error: --devices {n} needs {n} GPUs, JAX sees "
                         f"{len(jax.devices())}")
    seqs = [write_raw_sequence(work / f"seq{s}", VO_FRAMES, SEED + s)
            for s in range(n)]
    cfg = work / "smoke_gn.yml"
    cfg.write_text(SMOKE_GN_YAML)
    trajs = {}
    for d in (n, 1):
        out = work / f"serve_{d}"
        run_cli(phovo_serve.main, serve_argv(cfg, out, d, seqs),
                f"phovo-serve --devices {d}")
        trajs[d] = [read_trajectory(out / f"{s.name}.txt") for s in seqs]
    for s, a, b in zip(seqs, trajs[n], trajs[1]):
        # each stream runs the same program on its own card in both layouts;
        # positions integrate 64 poses, so 1e-5 m covers reassociation only
        _check(f"serve {s.name} --devices {n} vs 1", a.positions, b.positions,
               atol=1e-5)
        score(s / "groundtruth.txt", work / f"serve_{n}" / f"{s.name}.txt",
              f"phovo-serve --devices {n} {s.name}")

    mesh = make_mesh(n, pixel_parallel=2 if n % 2 == 0 else 1,
                     devices=jax.devices()[:n])
    mesh1 = make_mesh(1, pixel_parallel=1, devices=jax.devices()[:1])
    rng = np.random.default_rng(SEED)
    graph = chain_to_graph(
        jnp.asarray(0.05 * rng.standard_normal((63, 6)).astype(np.float32)),
        [(0, 63, np.zeros(6, np.float32))], loop_weight=10.0,
    )
    s_n, c_n = optimize_pose_graph(graph, mesh=mesh, iterations=5)
    s_1, c_1 = optimize_pose_graph(graph, mesh=mesh1, iterations=5)
    # constraint sums over a different shard split reassociate (float32)
    _check("pose graph states", s_n, s_1, atol=1e-4)
    _check("pose graph cost", c_n, c_1, atol=1e-6, rtol=1e-4)
    problem, _, _ = make_synthetic_ba(n_poses=8, n_points=2000, seed=SEED)
    ba_n = optimize_bundle(problem, TUM_FR1, mesh=mesh, iterations=5)
    ba_1 = optimize_bundle(problem, TUM_FR1, mesh=mesh1, iterations=5)
    _check("BA poses", ba_n[0], ba_1[0], atol=1e-4)
    _check("BA points", ba_n[1], ba_1[1], atol=1e-3)
    done(f"{n} devices", t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the multi-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    dev = phase_device()
    with tempfile.TemporaryDirectory(prefix="phovo_smoke_") as tmp:
        work = Path(tmp)
        if args.devices > 1:
            phase_four_devices(work, args.devices)
        else:
            phase_compile()
            phase_parity()
            phase_vo_serve(work)
            phase_gpu_tests()
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
