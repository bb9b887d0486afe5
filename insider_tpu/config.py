"""Configuration dataclasses.

The reference passes all knobs as function arguments with inline magic
constants (R/insider.R:18, src/optimize.cpp:257,389-403).  Here every magic
number becomes a named, documented default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Optimization hyperparameters for one `optimize` run.

    Mirrors the argument list of the reference driver
    (src/optimize.cpp:256-257) plus the constants it hardcodes.
    """

    latent_dim: int = 10
    # Ridge penalty on all row-side factors (lambda1, src/utils.cpp:85).
    lambda1: float = 1.0
    # Elastic-net penalty on the gene/column factor (lambda2, src/utils.cpp:88-91).
    lambda2: float = 1.0
    # Elastic-net mixing: alpha*L1 + (1-alpha)*L2 (src/utils.cpp:88-91).
    alpha: float = 0.1
    # tuning==1: masked (train-only) updates; tuning==0: dense whole-matrix
    # fast path (src/optimize.cpp:150,178 and R `partition`, R/insider.R:209).
    masked: bool = True
    # Relative-loss stopping criterion, checked every `check_every` iterations
    # (src/optimize.cpp:381,405).
    global_tol: float = 1e-10
    # Base tolerance of the per-column elastic-net subproblem
    # (src/optimize.cpp:376; default 1e-5 at R/insider.R:18).
    sub_tol: float = 1e-5
    max_iter: int = 10000
    # Convergence/metrics cadence (src/optimize.cpp:327,381: `iter % 10`).
    check_every: int = 10
    # How many check boundaries one device dispatch runs back-to-back, with
    # the sub_tol decay ladder and the relative-loss stop evaluated ON
    # DEVICE between them (train/als._run_boundary_chain).  The protocol is
    # unchanged — same per-boundary metrics, same ladder, same stop test —
    # but one host round-trip serves this many boundaries.  Checkpoints
    # land every dispatch rather than every boundary.  1 = one dispatch per
    # boundary.  (Whether 5 beats 1 on the GPU is not measured yet.)
    boundaries_per_dispatch: int = 5
    # Safety cap on CD sweeps inside one column update (the reference loops
    # unboundedly, coordinate_descent.cpp:82-114; we bound for jit safety).
    # KKT reactivation (coordinate_descent.cpp:118-124) is folded into the
    # same sweep loop (ops/col_update.elastic_net_cd), so this single cap
    # bounds it too — there is deliberately no separate kkt-rounds knob.
    max_cd_sweeps: int = 200
    # col_solver="cd" warm start: solve the sign pattern exactly with one
    # FSS pass first, then run plain CD sweeps from that point until the
    # reference's stopping criterion (per-column sweep decrease <= tol,
    # coordinate_descent.cpp:112-114) fires.  Same unique optimum, same
    # stopping contract, far fewer sweeps than cold CD (which converges
    # linearly on these ill-conditioned grams).  False = the pure
    # reference trajectory (cold strong-rule CD).
    cd_warm_start: bool = True
    # Continuous-covariate CD stop: sum|delta w| < ctns_tol
    # (src/optimize.cpp:122) with a sweep cap for jit safety.
    ctns_tol: float = 1e-1
    max_ctns_sweeps: int = 100
    # Init distribution N(0, init_std^2) (R/utils.R:40-43).
    init_std: float = 1e-3
    seed: int = 0
    # NOTE: compute dtype is a property of the Problem, not the fit — pass
    # `dtype=`/`mask_dtype=` to als.build_problem.  Factors are f32; loss
    # deltas use compensated (double-single) summation so f32 suffices for
    # the reference's 1e-9-relative stopping rule (ops/precise.py).
    # Run the feature-sign column solve as the Triton kernel
    # (kernels/fss_triton.py).  None = auto: yes on the 'gpu' backend, no on
    # 'cpu' (the jnp path); True off the GPU raises
    # (train/als.resolve_use_pallas).
    use_pallas: Optional[bool] = None
    # Column sub-solver for alpha > 0: "cd" = strong-rule coordinate descent
    # (the reference's algorithm, coordinate_descent.cpp:57); "fss" = batched
    # feature-sign search (exact active-set solves, ops/fss.py — the fast
    # path; the reference ships its own R prototype of this algorithm,
    # R/optimization_functions.R:136).  "auto" = fss.  Both solve the same
    # convex subproblem; fss returns its exact optimum, so the sub_tol decay
    # ladder becomes a no-op for it.
    col_solver: str = "auto"
    # Outer-step cap for the fss solver (each step = one batched K x K
    # solve; sign patterns are finite so termination is guaranteed, this is
    # a jit-safety bound).
    max_fss_outer: int = 48
    # Run a short plain-CD pass (no screening, warm-started from the FSS
    # solution, at the driver's effective sub_tol) after each FSS column
    # update.  FSS terminates under an f32-relative KKT slack (ops/fss.py
    # kkt_rtol) that can leave a boundary coordinate inactive with a
    # per-column objective excess on ill-scaled columns; the polish
    # soft-thresholds every
    # coordinate, so the returned solution additionally satisfies the
    # reference CD's own stopping criterion (coordinate_descent.cpp:112-114).
    fss_polish: bool = True
    # Sweep cap for the polish pass (from a near-optimum it converges in a
    # handful of sweeps).
    max_fss_polish_sweeps: int = 32
    # Sanitizer mode (SURVEY.md §5): run every step chunk under
    # jax.experimental.checkify with a finiteness check after EACH block
    # update, so the first NaN/Inf is pinned to the producing factor block
    # (row/continuous/column) instead of surfacing as a diverged loss at
    # the next 10-iter boundary.  Debug-only: the checks serialize some
    # fusion, so leave False for production runs.
    debug_checks: bool = False

    @property
    def sub_tol_decay_ladder(self) -> Tuple[float, ...]:
        """The reference's decay schedule (src/optimize.cpp:389-403).

        decay = 10^-d for the largest d in 1..6 with delta_loss/1000 <= 10^-d,
        else 1.0.
        """
        return (1.0, 1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)


def decay_from_delta_loss_jnp(delta_loss):
    """decay_from_delta_loss as a traced jnp expression (same ladder) —
    used by the on-device boundary chain (train/als._run_boundary_chain)."""
    import jax.numpy as jnp

    d = delta_loss / 1000.0
    ladder = [1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1]
    out = jnp.float32(1.0)
    for t in reversed(ladder):
        out = jnp.where(d <= t, jnp.float32(t), out)
    return out


def decay_from_delta_loss(delta_loss: float) -> float:
    """Map a 10-iter loss decrease to the sub_tol decay factor.

    Exact transliteration of the if-ladder at src/optimize.cpp:389-403.
    """
    d = delta_loss / 1000.0
    if d <= 1e-6:
        return 1e-6
    if d <= 1e-5:
        return 1e-5
    if d <= 1e-4:
        return 1e-4
    if d <= 1e-3:
        return 1e-3
    if d <= 1e-2:
        return 1e-2
    if d <= 1e-1:
        return 1e-1
    return 1.0


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Device mesh layout.

    Axes: 'rows' shards the sample axis (data-parallel analog; per-level Grams
    psum over it), 'cols' shards the gene axis (model-parallel analog; the CD
    inner loop is zero-communication within a gene shard).  See SURVEY.md §2d.
    """

    rows: int = 1
    cols: int = 1
    # Optional explicit device list; defaults to jax.devices().
    devices: Optional[tuple] = None

    @property
    def n_devices(self) -> int:
        return self.rows * self.cols
