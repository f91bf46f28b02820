import textwrap

import pytest

from phovo_tpu.utils.config import (
    PhovoConfig,
    builtin_config_dir,
    load_builtin,
    load_config,
)


def test_all_builtin_presets_load():
    presets = sorted(p.stem for p in builtin_config_dir().glob("*.yml"))
    assert len(presets) == 12
    for name in presets:
        cfg = load_builtin(name)
        assert cfg.num_levels >= 1
        assert len(cfg.max_iterations) == cfg.num_levels


def test_reference_schema_parses(tmp_path):
    """The reference's OpenCV FileStorage YAML schema must load unmodified
    (key names from CPhotoconsistencyOdometryAnalytic.h:586-606)."""
    text = textwrap.dedent("""\
        %YAML:1.0
        numOptimizationLevels: 4
        blurFilterSize (at each level): [0, 0, 0, 0]
        imageGradientsScalingFactor (at each level): [0.0625, 0.0625, 0.0625, 0.0625]
        lambda_optimization_step (at each level): [1,1,1,1]
        max_num_iterations (at each level): [0, 0, 20, 50]
        min_gradient_norm (at each level): [300,300,300,300]
        visualizeIterations: 0
    """)
    p = tmp_path / "ref.yml"
    p.write_text(text)
    cfg = load_config(p)
    assert cfg.num_levels == 4
    assert cfg.max_iterations == (0, 0, 20, 50)
    assert cfg.lambda_steps == (1.0, 1.0, 1.0, 1.0)
    assert cfg.min_gradient_norms == (300.0,) * 4
    assert cfg.visualize_iterations is False


def test_reference_ceres_schema_parses(tmp_path):
    text = textwrap.dedent("""\
        %YAML:1.0
        numOptimizationLevels: 2
        blurFilterSize (at each level): [0, 5, 3]
        imageGradientsScalingFactor (at each level): [0.5, 0.5, 0.0625]
        max_num_iterations (at each level): [0, 40, 0]
        function_tolerance (at each level): [1e-4, 1e-4, 1e-4]
        gradient_tolerance (at each level): [1e-3, 1e-3, 1e-3]
        parameter_tolerance (at each level): [1e-4, 1e-4, 1e-6]
        initial_trust_region_radius (at each level): [1e8, 1e4, 1e4]
        max_trust_region_radius (at each level): [1e8, 1e8, 1e8]
        min_trust_region_radius (at each level): [1e-32,1e-32,1e-32]
        min_relative_decrease (at each level): [1e-1,1e-1,1e-3]
        num_threads: 2
        num_linear_solver_threads: 2
        minimizer_progress_to_stdout: 0
        visualizeIterations: 0
    """)
    p = tmp_path / "ceres.yml"
    p.write_text(text)
    cfg = load_config(p)
    # arrays truncated to num_levels like the reference's level indexing
    assert cfg.num_levels == 2
    assert cfg.max_iterations == (0, 40)
    assert cfg.function_tolerances == (1e-4, 1e-4)
    opts = cfg.trust_region_options(1)
    assert opts.max_iterations == 40
    assert opts.initial_trust_region_radius == 1e4
    assert opts.min_relative_decrease == 1e-1


def test_schedule_padding(tmp_path):
    p = tmp_path / "short.yml"
    p.write_text("num_levels: 4\nmax_iterations: [5, 10]\n")
    cfg = load_config(p)
    assert cfg.max_iterations == (5, 10, 10, 10)


def test_validation_rejects_bad_lengths():
    with pytest.raises(ValueError):
        PhovoConfig(num_levels=3, max_iterations=(1, 2)).validate()
