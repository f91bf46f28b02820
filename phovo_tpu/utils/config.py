"""Configuration system: reference-schema YAML + native dataclass config.

The reference reads per-level parameter arrays from OpenCV FileStorage YAML
(ReadConfigurationFile, CPhotoconsistencyOdometryAnalytic.h:581-607 and
CPhotoconsistencyOdometryCeres.h:526-576) with keys like
"blurFilterSize (at each level)", under an OpenCV-specific `%YAML:1.0`
directive. Config files use a small flat subset of YAML, which
`parse_flat_yaml` reads with no YAML library: one `key: value` per line,
scalars or inline `[a, b, ...]` lists, quoted or bare, and `#` comments.
All 12 reference presets ship under phovo_tpu/configs/ and parse through
this module.

A "setting schedule" is a list indexed by pyramid level; levels with
max_num_iterations == 0 are skipped entirely (state passes through), exactly
like the reference (…Analytic.h:526, config_only_level_0_analytic.yml).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from phovo_tpu.solvers.trust_region import TROptions

# reference key -> (our field, element type)
_KEYMAP = {
    "numOptimizationLevels": ("num_levels", int),
    "blurFilterSize (at each level)": ("blur_filter_sizes", int),
    "imageGradientsScalingFactor (at each level)": ("gradient_scales", float),
    "lambda_optimization_step (at each level)": ("lambda_steps", float),
    "max_num_iterations (at each level)": ("max_iterations", int),
    "min_gradient_norm (at each level)": ("min_gradient_norms", float),
    "visualizeIterations": ("visualize_iterations", bool),
    "function_tolerance (at each level)": ("function_tolerances", float),
    "gradient_tolerance (at each level)": ("gradient_tolerances", float),
    "parameter_tolerance (at each level)": ("parameter_tolerances", float),
    "initial_trust_region_radius (at each level)": ("initial_trust_region_radii", float),
    "max_trust_region_radius (at each level)": ("max_trust_region_radii", float),
    "min_trust_region_radius (at each level)": ("min_trust_region_radii", float),
    "min_relative_decrease (at each level)": ("min_relative_decreases", float),
    "num_threads": ("num_threads", int),
    "num_linear_solver_threads": ("num_linear_solver_threads", int),
    "minimizer_progress_to_stdout": ("progress_to_stdout", bool),
}


@dataclasses.dataclass(frozen=True)
class PhovoConfig:
    """Per-level setting schedule for any backend.

    Fields are tuples of length num_levels (static at trace time so each
    level jit-compiles once with static shapes). Gauss-Newton fields cover
    the analytic/bi-objective backends; trust-region fields cover the
    autodiff ("ceres") backend. Unused fields for a given backend are
    ignored, mirroring the two YAML schemas sharing one reader style.
    """

    num_levels: int = 5
    blur_filter_sizes: tuple[int, ...] = (0, 0, 0, 0, 0)
    # Pyramid smoothing variant — the reference's compile-time switch
    # (ENABLE_GAUSSIAN_BLUR / ENABLE_BOX_FILTER_BLUR,
    # CPhotoconsistencyOdometryAnalytic.h:37-38,143-155), runtime here:
    # 'gaussian' (double GaussianBlur sigma=3) | 'box' (double cv::blur)
    blur_type: str = "gaussian"
    gradient_scales: tuple[float, ...] = (0.0625,) * 5
    max_iterations: tuple[int, ...] = (0, 0, 5, 20, 50)
    visualize_iterations: bool = False
    min_depth: float = 0.3
    max_depth: float = 5.0
    # Gauss-Newton (analytic / bi-objective)
    lambda_steps: tuple[float, ...] = (1.0,) * 5
    min_gradient_norms: tuple[float, ...] = (300.0,) * 5
    # Trust-region (autodiff / "ceres")
    function_tolerances: tuple[float, ...] | None = None
    gradient_tolerances: tuple[float, ...] | None = None
    parameter_tolerances: tuple[float, ...] | None = None
    initial_trust_region_radii: tuple[float, ...] | None = None
    max_trust_region_radii: tuple[float, ...] | None = None
    min_trust_region_radii: tuple[float, ...] | None = None
    min_relative_decreases: tuple[float, ...] | None = None
    num_threads: int = 1
    num_linear_solver_threads: int = 1
    progress_to_stdout: bool = False
    # Kernel options (no reference analog; see ops/residuals.py docstring):
    # gradient_at 'warped' (consistent linearization, default) | 'source'
    # (the reference analytic kernel's convention) | 'esm' (Efficient
    # Second-order Minimization: mean of warped target and source gradients,
    # second-order convergence from first derivatives — typically converges
    # in fewer iterations and tolerates larger initial motion)
    sampling: str = "nearest"
    gradient_at: str = "warped"
    # Robust loss (no reference analog — the reference cost is purely
    # quadratic; see ops/robust.py): 'none' | 'huber' | 'cauchy' | 'tukey'
    # | 'tdist'; delta in residual units (intensity is 0..1, so 0.1 ~ 25
    # gray levels). 'tdist' is the DVO Student-t weighting (Kerl et al.
    # 2013): the scale is re-estimated from the residuals every GN
    # iteration and robust_delta only seeds it (photometric GN backends)
    robust_loss: str = "none"
    robust_delta: float = 0.1

    def trust_region_options(self, level: int) -> TROptions:
        def get(field, default):
            v = getattr(self, field)
            return default if v is None else v[level]

        return TROptions(
            max_iterations=self.max_iterations[level],
            function_tolerance=get("function_tolerances", 1e-6),
            gradient_tolerance=get("gradient_tolerances", 1e-10),
            parameter_tolerance=get("parameter_tolerances", 1e-8),
            initial_trust_region_radius=get("initial_trust_region_radii", 1e4),
            max_trust_region_radius=get("max_trust_region_radii", 1e16),
            min_trust_region_radius=get("min_trust_region_radii", 1e-32),
            min_relative_decrease=get("min_relative_decreases", 1e-3),
        )

    def validate(self) -> "PhovoConfig":
        for f in (
            "blur_filter_sizes",
            "gradient_scales",
            "max_iterations",
            "lambda_steps",
            "min_gradient_norms",
        ):
            v = getattr(self, f)
            if v is not None and len(v) != self.num_levels:
                raise ValueError(
                    f"{f} has {len(v)} entries, expected num_levels={self.num_levels}"
                )
        from phovo_tpu.ops.robust import LOSSES

        if self.robust_loss not in LOSSES:
            raise ValueError(
                f"robust_loss={self.robust_loss!r}; expected one of {LOSSES}"
            )
        if self.sampling not in ("nearest", "bilinear"):
            raise ValueError(
                f"sampling={self.sampling!r}; expected 'nearest' or "
                "'bilinear'"
            )
        if self.gradient_at not in ("warped", "source", "esm"):
            raise ValueError(
                f"gradient_at={self.gradient_at!r}; expected 'warped', "
                "'source' or 'esm'"
            )
        if self.blur_type not in ("gaussian", "box"):
            raise ValueError(
                f"blur_type={self.blur_type!r}; expected 'gaussian' or 'box'"
            )
        return self


def _strip_comment(line: str) -> str:
    """Drop a '#' comment that is not inside quotes."""
    quote = None
    for k, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#":
            return line[:k]
    return line


def _parse_scalar(text: str):
    """A bare or quoted YAML scalar: quoted text stays a string; bare text
    becomes an int, a float, a bool (true/false/yes/no/on/off), None
    (null, ~, empty) or, failing those, a string."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    low = t.lower()
    if low in ("", "null", "~"):
        return None
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    return t


def parse_flat_yaml(text: str) -> dict:
    """Parse the flat YAML subset config files use (module docstring).

    The OpenCV `%YAML:1.0` directive and `---` document markers are
    skipped. Anything else outside the subset — indented (nested) lines,
    block lists, lines without a `key:` — raises ValueError."""
    out: dict = {}
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.startswith(("%YAML", "---")):
            continue
        key, sep, value = line.partition(":")
        if not sep or line[0].isspace() or not key.strip():
            raise ValueError(f"line {n}: unsupported config syntax: {raw!r}")
        value = value.strip()
        if value.startswith("["):
            if not value.endswith("]"):
                raise ValueError(f"line {n}: unterminated list: {raw!r}")
            inner = value[1:-1].strip()
            out[key.strip()] = (
                [_parse_scalar(v) for v in inner.split(",")] if inner else []
            )
        else:
            out[key.strip()] = _parse_scalar(value)
    return out


def load_config(path: str | Path) -> PhovoConfig:
    """Load a reference-schema (or native-schema) YAML config file."""
    data = parse_flat_yaml(Path(path).read_text())
    if not data:
        raise ValueError(f"config {path} holds no settings")
    return config_from_dict(data)


# element type for native-schema fields (quoted numbers such as '1e-4'
# arrive as strings, so coerce explicitly)
_FIELD_TYPES = {
    "num_levels": int,
    "blur_filter_sizes": int,
    "blur_type": None,
    "gradient_scales": float,
    "max_iterations": int,
    "visualize_iterations": bool,
    "min_depth": float,
    "max_depth": float,
    "lambda_steps": float,
    "min_gradient_norms": float,
    "function_tolerances": float,
    "gradient_tolerances": float,
    "parameter_tolerances": float,
    "initial_trust_region_radii": float,
    "max_trust_region_radii": float,
    "min_trust_region_radii": float,
    "min_relative_decreases": float,
    "num_threads": int,
    "num_linear_solver_threads": int,
    "progress_to_stdout": bool,
    "sampling": None,
    "gradient_at": None,
    "robust_loss": None,
    "robust_delta": float,
}


def config_from_dict(data: dict) -> PhovoConfig:
    kwargs: dict = {}
    for key, value in data.items():
        if key in _KEYMAP:
            field, elem = _KEYMAP[key]
        elif key in _FIELD_TYPES:
            field, elem = key, _FIELD_TYPES[key]
        else:
            continue  # unknown keys ignored, like cv::FileStorage lookups
        if isinstance(value, (list, tuple)):
            value = tuple(elem(v) if elem else v for v in value)
        elif elem is not None:
            value = elem(value)
        kwargs[field] = value

    n = kwargs.get("num_levels")
    if n is None:
        raise ValueError("config missing numOptimizationLevels / num_levels")

    # The reference indexes schedules by level < numOptimizationLevels, so
    # longer arrays are silently truncated and several shipped presets rely on
    # that (e.g. config_only_level_0_analytic.yml declares 1 level with
    # 4-entry arrays). Short arrays are padded with their last value.
    for field, value in list(kwargs.items()):
        if isinstance(value, tuple) and field.endswith(("s", "radii")):
            if len(value) > n:
                kwargs[field] = value[:n]
            elif 0 < len(value) < n:
                kwargs[field] = value + (value[-1],) * (n - len(value))

    defaults = {
        "blur_filter_sizes": (0,) * n,
        "gradient_scales": (0.0625,) * n,
        "max_iterations": (0,) * n,
        "lambda_steps": (1.0,) * n,
        "min_gradient_norms": (300.0,) * n,
    }
    for field, dval in defaults.items():
        kwargs.setdefault(field, dval)
    return PhovoConfig(**kwargs).validate()


def override_config(cfg: PhovoConfig, **overrides) -> PhovoConfig:
    """Apply CLI-style overrides to a loaded config, skipping None values
    (unset flags). Shared by the phovo-align / phovo-vo argument handling."""
    kept = {k: v for k, v in overrides.items() if v is not None}
    if not kept:
        return cfg
    return dataclasses.replace(cfg, **kept).validate()


def builtin_config_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "configs"


def load_builtin(name: str) -> PhovoConfig:
    """Load one of the shipped presets by file stem, e.g.
    'config_4_level_optimization_analytic'."""
    p = builtin_config_dir() / f"{name}.yml"
    return load_config(p)
