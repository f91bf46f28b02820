"""Measurement entry points, compile-cache placement, the YAML-free config
loader, and the packages the main path may not need."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from phovo_tpu.utils.config import (
    builtin_config_dir,
    config_from_dict,
    load_builtin,
    load_config,
    parse_flat_yaml,
)

REPO = Path(__file__).resolve().parents[1]
PRESETS = sorted(p.stem for p in builtin_config_dir().glob("*.yml"))


def _run(args, cwd=REPO, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _import_repo_module(name):
    sys.path.insert(0, str(REPO))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO))


# -- the card or nothing --------------------------------------------------------


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_measurement_scripts_refuse_the_cpu(script):
    """Without a GPU, bench.py and chip_smoke.py exit non-zero and print no
    result line."""
    p = _run([script])
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert "{" not in p.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"PYTHONPATH": ""})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_require_gpu_refuses_the_cpu():
    from phovo_tpu.utils.device import jax_devices, require_gpu

    assert jax_devices()["platform"] == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_gpu_line_empty_without_nvidia_smi(monkeypatch):
    from phovo_tpu.utils import device

    monkeypatch.setattr(device.shutil, "which", lambda name: None)
    assert device.gpu_name_and_power_limit() == []


# -- trace reduction ---------------------------------------------------------


@pytest.mark.parametrize(
    "intervals,total",
    [([], 0.0), ([(0, 10), (5, 15), (20, 30)], 25.0),
     ([(3, 4), (0, 10), (10, 12)], 12.0)],
)
def test_union_of_device_intervals(intervals, total):
    bench = _import_repo_module("bench")
    assert bench.union_ns(intervals) == total


def test_trace_summary_reads_a_recorded_trace(tmp_path):
    """The bench's trace reduction on a trace recorded here: the window is
    found, and with no GPU plane the device is idle throughout."""
    import glob

    import jax
    import jax.numpy as jnp

    bench = _import_repo_module("bench")
    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        with jax.profiler.TraceAnnotation("bench_window"):
            f(x).block_until_ready()
    path = glob.glob(f"{tmp_path}/**/*.xplane.pb", recursive=True)[0]
    s = bench.trace_summary(path, "bench_window")
    assert s["window_ns"] > 0
    assert s["device_events"] == 0 and s["device_idle_share"] == 1.0
    assert s["kind_share"] == {} and s["iteration_runs"] == []


@pytest.mark.parametrize(
    "name,kind",
    [("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8", "gemm"),
     ("MemcpyD2H", "copy"), ("wrapped_dot_1", "dot"),
     ("loop_transpose_fusion_1", "transpose/concatenate"),
     ("input_concatenate_fusion_3", "transpose/concatenate"),
     ("input_reduce_select_fusion_4", "other fusion"),
     ("cub_sort", "other")],
)
def test_op_kind(name, kind):
    assert _import_repo_module("bench").op_kind(name) == kind


def test_iteration_runs_split_at_predicate_copies():
    """Two levels of a while loop: 3 iterations of 100 ns busy, then 2 of
    400 ns, each ending in its predicate copy and followed by a 50 ns gap;
    a 30 ns prep before the first copy."""
    bench = _import_repo_module("bench")
    events, t = [("prep_fusion", 0, 20), ("MemcpyD2H", 20, 30)], 30
    for busy in (100, 100, 100, 400, 400):
        t += 50
        events += [("fusion", t, t + busy - 10),
                   ("MemcpyD2H", t + busy - 10, t + busy)]
        t += busy
    runs = bench.iteration_runs(events)
    assert [r["n"] for r in runs] == [1, 3, 2]
    assert [r["busy_us"] for r in runs] == [0.03, 0.1, 0.4]
    assert runs[0]["gap_us"] is None
    assert runs[1]["gap_us"] == runs[2]["gap_us"] == 0.05


# -- compile cache -------------------------------------------------------------


@pytest.fixture
def cache_calls(monkeypatch):
    import jax

    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    return calls


def test_compile_cache_env_is_the_only_directory(monkeypatch, cache_calls):
    from phovo_tpu.apps._bootstrap import enable_compilation_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert enable_compilation_cache() == "/some/cache"
    assert cache_calls == {}


def test_compile_cache_off_on_the_cpu(monkeypatch, cache_calls):
    from phovo_tpu.apps._bootstrap import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compilation_cache() is None
    assert cache_calls == {}


def test_compile_cache_in_the_checkout(monkeypatch, cache_calls):
    import jax

    from phovo_tpu.apps import _bootstrap

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    path = Path(_bootstrap.enable_compilation_cache())
    assert cache_calls["jax_compilation_cache_dir"] == str(path)
    assert path.parent == REPO
    assert f"{path.name}/" in (REPO / ".gitignore").read_text().split()


# -- YAML-free config loader ------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_flat_yaml_loads_every_preset(preset, monkeypatch):
    """Every shipped preset parses with no YAML library: each `key:` line
    becomes one entry, lists become lists of numbers, and the config
    validates."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    text = (builtin_config_dir() / f"{preset}.yml").read_text()
    data = parse_flat_yaml(text)
    keys = [
        ln.split(":")[0].strip() for ln in text.splitlines()
        if ln.strip() and not ln.lstrip().startswith(("#", "%"))
    ]
    assert list(data) == keys
    for v in data.values():
        if isinstance(v, list):
            assert all(isinstance(x, (int, float, str)) for x in v)
            assert all(not isinstance(x, str) or float(x) for x in v)
    cfg = load_builtin(preset)
    assert cfg == config_from_dict(data)
    assert len(cfg.max_iterations) == cfg.num_levels


def test_flat_yaml_reference_schema():
    text = textwrap.dedent("""\
        %YAML:1.0
        ---
        # comment line
        numOptimizationLevels: 3   # trailing comment
        blurFilterSize (at each level): [0, 5, 3]
        function_tolerance (at each level): ['1e-4', "1e-5", 1e-6]
        visualizeIterations: 0
        minimizer_progress_to_stdout: true
        sampling: bilinear
        label: 'a # not a comment'
        empty: []
    """)
    assert parse_flat_yaml(text) == {
        "numOptimizationLevels": 3,
        "blurFilterSize (at each level)": [0, 5, 3],
        "function_tolerance (at each level)": ["1e-4", "1e-5", 1e-6],
        "visualizeIterations": 0,
        "minimizer_progress_to_stdout": True,
        "sampling": "bilinear",
        "label": "a # not a comment",
        "empty": [],
    }


@pytest.mark.parametrize(
    "text",
    ["levels:\n  nested: 1\n", "max_iterations:\n- 1\n- 2\n",
     "max_iterations: [1, 2\n", "just text\n"],
    ids=["nested", "block-list", "unterminated", "no-key"],
)
def test_flat_yaml_rejects_other_syntax(text, tmp_path):
    p = tmp_path / "bad.yml"
    p.write_text(text)
    with pytest.raises(ValueError):
        load_config(p)


def test_main_path_without_yaml_or_cv2(tmp_path):
    """`import phovo_tpu` and a phovo-vo chunked run over a raw sequence
    work with neither yaml nor cv2 importable."""
    from phovo_tpu.ops.camera import Intrinsics
    from phovo_tpu.utils.synthetic import make_sequence

    intr = Intrinsics(64.0, 64.0, 31.5, 23.5)
    I, D, _, ts = make_sequence(intr, (48, 64), n_frames=4, seed=0)
    raw = tmp_path / "raw"
    raw.mkdir()
    np.save(raw / "intensity.u8.npy",
            (np.stack(I) * 255 + 0.5).astype(np.uint8))
    np.save(raw / "depth.u16.npy",
            (np.stack(D) * 5000 + 0.5).astype(np.uint16))
    np.save(raw / "timestamps.f64.npy", ts)
    (raw / "meta.json").write_text(json.dumps({
        "format_version": 2, "n": 4, "height": 48, "width": 64,
        "depth_scale": 1 / 5000, "pairing": "associate",
    }))
    cfg = tmp_path / "cfg.yml"
    cfg.write_text("num_levels: 2\nmax_iterations: [3, 3]\n"
                   "min_gradient_norms: [1e-9, 1e-9]\nsampling: bilinear\n")
    out = tmp_path / "traj.txt"
    code = textwrap.dedent(f"""\
        import sys
        sys.modules["yaml"] = None
        sys.modules["cv2"] = None
        import phovo_tpu
        from phovo_tpu.apps import phovo_vo
        sys.exit(phovo_vo.main([
            "--config", {str(cfg)!r}, "--dataset", {str(raw)!r},
            "--intrinsics", "64,64,31.5,23.5", "--chunk", "2",
            "--output", {str(out)!r}, "--quiet",
        ]))
    """)
    p = _run(["-c", code])
    assert p.returncode == 0, p.stderr[-2000:]
    from phovo_tpu.utils.trajectory import read_trajectory

    assert len(read_trajectory(out)) == 3


def test_raw_sequence_writer_round_trip(tmp_path):
    """chip_smoke's numpy-only raw writer produces what RawSequence reads."""
    from phovo_tpu.datasets.raw import RawSequence
    from phovo_tpu.utils.trajectory import read_trajectory

    smoke = _import_repo_module("chip_smoke")
    root = smoke.write_raw_sequence(tmp_path / "seq", 3, seed=0)
    seq = RawSequence(root)
    assert len(seq) == 3 and (seq.height, seq.width) == (smoke.H, smoke.W)
    frames = list(seq)
    assert frames[0].intensity.dtype == np.uint8
    assert 0.3 < float(np.median(frames[0].depth)) < 10.0
    assert len(read_trajectory(root / "groundtruth.txt")) == 3
