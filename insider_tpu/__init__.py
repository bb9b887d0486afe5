"""insider_tpu — a JAX framework for INSIDER-style interpretable sparse
matrix decomposition.

Reimplements, in JAX (XLA, with a Pallas/Triton column-solve kernel on NVIDIA
GPUs), the capabilities of the
kai0511/insider R package (RcppArmadillo/OpenMP): confounder-indexed low-rank
decomposition

    X ~= (sum_v E_v V_v + C W) F

with per-level ridge row updates, elastic-net (L1+L2) coordinate-descent column
updates with strong-rule screening and KKT reactivation, masked train/test
element splits, interaction factors, continuous covariates, two-stage
hyperparameter tuning, and post-fit GLM interaction analysis.

Reference behavior citations are file:line paths in the kai0511/insider
repository.

Public API (mirrors the R package surface: R/insider.R:18,81,190 and
R/glm_interaction.R:2):

    Insider(...)            - build a model object (splitter + interaction setup)
    .tune(...)              - two-stage rank / (lambda, alpha) search
    .fit(...)               - final fit, attaches factors
    optimize(...)           - the ALS driver (src/optimize.cpp:256 analog)
    glm_interaction(...)    - downstream per-level GLM inference
    fit_interaction(...)    - standalone per-level ridge op (src/fit_interaction.cpp:10)
"""

from insider_tpu.api import Insider, FitResult
from insider_tpu.config import FitConfig, ShardingConfig
from insider_tpu.data.splitter import ratio_splitter, SplitResult
from insider_tpu.data.simulate import simulate_insider_data, simulate_scale
from insider_tpu.model.state import InsiderState, init_state
from insider_tpu.train.als import optimize
from insider_tpu.tune.grid import tune
from insider_tpu.analysis.glm import glm_interaction
from insider_tpu.ops.row_update import fit_interaction
from insider_tpu.ops.solvers import coordinate_descent, strong_coordinate_descent
from insider_tpu.checkpoint import load_checkpoint, save_checkpoint
from insider_tpu.sharding.distributed import initialize_distributed, pod_sharding

__version__ = "0.1.0"

__all__ = [
    "Insider",
    "FitResult",
    "FitConfig",
    "ShardingConfig",
    "ratio_splitter",
    "SplitResult",
    "simulate_insider_data",
    "simulate_scale",
    "InsiderState",
    "init_state",
    "optimize",
    "tune",
    "glm_interaction",
    "fit_interaction",
    "coordinate_descent",
    "strong_coordinate_descent",
    "load_checkpoint",
    "save_checkpoint",
    "initialize_distributed",
    "pod_sharding",
]
