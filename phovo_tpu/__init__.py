"""phovo_tpu — multiscale photoconsistency visual odometry in JAX/XLA.

A ground-up JAX/XLA re-design of the capabilities of
MiguelAlgaba/photoconsistency-visual-odometry (reference: a header-only C++
library estimating the 6-DoF rigid transform between consecutive RGB-D frames
by minimizing per-pixel photometric error, coarse-to-fine over an image
pyramid; see /root/reference/phovo/include/CPhotoconsistencyOdometry.h:137-179
for the reference API this package mirrors functionally).

Architecture (a re-design, not a translation):
  ops/      pure-JAX compute: SE(3), camera, pyramids, warping,
            residual/Jacobian fields, the packed-gather JtJ reduction.
  solvers/  Gauss-Newton and trust-region Levenberg-Marquardt drivers built on
            lax.while_loop (static shapes, jit-once-per-level).
  models/   the odometry backends (analytic GN, autodiff LM "ceres",
            bi-objective intensity+depth GN, inverse-compositional GN)
            behind one functional API; batched frame chains.
  datasets/ TUM RGB-D streaming (host-side decode, device prefetch).
  parallel/ jax.sharding mesh utilities, sharded batch alignment, distributed
            pose-graph optimization.
  utils/    config schema (reference-compatible YAML), trajectories, ATE/RPE.
  apps/     CLI entry points (phovo-align, phovo-vo, phovo-serve, ...).
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/normal-equation math is precision-sensitive (6x6 solves on sums
# over 300k pixels); the XLA default matmul precision quantizes operands on
# some backends (TF32 on the GPU's tensor cores). All matmuls in this
# framework are small (<= rank 6 contract or banded image operators), and
# low precision visibly corrupts Jacobians.
_jax.config.update("jax_default_matmul_precision", "highest")

from phovo_tpu.ops import se3, camera, pyramid, warp, residuals  # noqa: F401
from phovo_tpu.utils.config import PhovoConfig, load_config  # noqa: F401
from phovo_tpu.models.base import AlignmentResult  # noqa: F401
from phovo_tpu.models.analytic import PhotoconsistencyOdometryAnalytic  # noqa: F401
from phovo_tpu.models.autodiff import PhotoconsistencyOdometryAutodiff  # noqa: F401
from phovo_tpu.models.biobjective import PhotoconsistencyOdometryBiObjective  # noqa: F401
