"""The alternating-minimization driver.

Equivalent of `optimize()` (src/optimize.cpp:256-422): the ALS
outer loop over (per-confounder ridge row updates, continuous-covariate
updates, elastic-net column update), with the reference's convergence
protocol — relative-loss stop checked every `check_every` iterations and the
sub_tol decay ladder (src/optimize.cpp:381-408).

Structure: one jitted `run_steps` executes a dynamic-length fori_loop of full
ALS iterations on device; the host loop evaluates the compensated loss
between chunks, applies the decay ladder, logs the same quantities the
reference prints (src/utils.cpp:70-76,95-100), and decides termination.
Device-host traffic per chunk is a handful of scalars.  All problem arrays
are jit *arguments* (never closure constants), and all static structure is
hashable, so compilations are shared across runs of the same shape — e.g.
every trial of a tuning sweep reuses one executable.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from functools import partial
from typing import Callable, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from insider_tpu.config import FitConfig, ShardingConfig, decay_from_delta_loss
from insider_tpu.model.state import InsiderState, init_state
from insider_tpu.ops import col_update, continuous, losses, row_update
from insider_tpu.sharding.mesh import (apply_constraints, check_divisible,
                                       make_mesh, shard_problem_arrays)

logger = logging.getLogger("insider_tpu")

HIGHEST = lax.Precision.HIGHEST


class RowPrecomp(NamedTuple):
    """Per-problem constants that turn the row updates into pure matmuls
    (ops/row_update.update_row_factor_*_fast).  Entries are None for
    confounders where the one-hot materialization would be too large (the
    driver then falls back to the segment-sum path for that confounder)."""

    e: Tuple[Optional[jax.Array], ...]       # (N, L_v) one-hot
    mw: Tuple[Optional[jax.Array], ...]      # masked: E^T @ mask (L, M)
    d: Tuple[Optional[jax.Array], ...]       # masked: E^T(W.*X); dense: E^T X
    counts: Tuple[Optional[jax.Array], ...]  # (L,)
    ctns_q: Optional[jax.Array]              # (P, M) = (c_j^2)^T W
    ctns_bc: Optional[jax.Array]             # (P, M) = c_j^T (W .* X)
    ctns_dc: Optional[jax.Array]             # (P, M) = c_j^T X   (dense path)
    ctns_cc: Optional[jax.Array]             # (P,)   = c_j^T c_j


class ProblemArrays(NamedTuple):
    """Dynamic (device array) part of a problem — a jit-friendly pytree."""

    data: jax.Array                 # (N, M) observation matrix (NaNs zeroed)
    train_mask: jax.Array           # (N, M) f32 0/1
    test_mask: jax.Array            # (N, M) f32 0/1
    codes: Tuple[jax.Array, ...]    # per-confounder (N,) int32, 0-based dense
    ctns: Optional[jax.Array]       # (N, P) continuous covariates or None
    pre: Optional[RowPrecomp] = None


@dataclasses.dataclass(frozen=True)
class ProblemStatics:
    """Hashable static structure — a jit static argument."""

    n_levels: Tuple[int, ...]
    masked: bool
    mesh: Optional[object] = None   # jax Mesh (hashable) for sharded runs


class Hypers(NamedTuple):
    """Traced hyperparameter scalars — tuning sweeps over (lambda, alpha)
    reuse one compiled executable."""

    lam1: jax.Array
    lam2: jax.Array
    alpha: jax.Array


def resolve_use_pallas(requested: Optional[bool],
                       backend: Optional[str] = None) -> bool:
    """Whether the column solve runs the Triton kernel.

    'gpu' runs the kernel (kernels/fss_triton.py) unless requested=False;
    'cpu' runs the jnp path.  Any other backend is an error, and so is
    requested=True off the GPU: the kernel has no compiled route there, and
    interpret mode is reachable only through the kernel's own `interpret=`
    argument."""
    backend = jax.default_backend() if backend is None else backend
    if backend not in ("gpu", "cpu"):
        raise ValueError(
            f"unsupported JAX backend {backend!r}: insider_tpu runs on 'gpu' "
            "(CUDA) or 'cpu'")
    if requested is None:
        return backend == "gpu"
    if requested and backend != "gpu":
        raise ValueError(
            f"use_pallas=True needs the 'gpu' backend (the column-solve "
            f"kernel compiles only through Triton on CUDA); got {backend!r}")
    return bool(requested)


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Static solver structure (affects the traced program)."""

    alpha_is_zero: bool      # dispatches ridge vs CD (src/optimize.cpp:224,237)
    max_cd_sweeps: int
    max_ctns_sweeps: int
    ctns_tol: float
    use_pallas: bool = False
    # Sanitizer mode (SURVEY.md §5 race-detection/sanitizers row): insert a
    # checkify finiteness check after every block update inside the jitted
    # iteration, so a NaN/Inf is pinned to the factor block that produced
    # it instead of surfacing as a diverged loss at the next boundary.
    debug_checks: bool = False
    # "cd" (reference algorithm) or "fss" (exact active-set solves — the
    # fast path; see ops/fss.py).  With fss the sub_tol decay ladder only
    # affects the polish pass: subproblems are solved to their exact
    # (slack-bounded) optimum every iteration.
    col_solver: str = "fss"
    max_fss_outer: int = 48
    # Plain-CD polish after FSS (see FitConfig.fss_polish).
    fss_polish: bool = True
    max_fss_polish_sweeps: int = 32
    # FSS-warm-started CD (FitConfig.cd_warm_start).
    cd_warm_start: bool = True

    @classmethod
    def from_config(cls, config: FitConfig):
        use_pallas = resolve_use_pallas(config.use_pallas)
        solver = config.col_solver
        if solver == "auto":
            solver = "fss"
        if solver not in ("cd", "fss"):
            raise ValueError(f"col_solver must be auto|cd|fss, got {solver}")
        return cls(
            alpha_is_zero=(config.alpha == 0.0),
            max_cd_sweeps=config.max_cd_sweeps,
            max_ctns_sweeps=config.max_ctns_sweeps,
            ctns_tol=config.ctns_tol,
            use_pallas=use_pallas,
            debug_checks=config.debug_checks,
            col_solver=solver,
            max_fss_outer=config.max_fss_outer,
            fss_polish=config.fss_polish,
            max_fss_polish_sweeps=config.max_fss_polish_sweeps,
            cd_warm_start=config.cd_warm_start,
        )


@dataclasses.dataclass
class Problem:
    """Host-side bundle for one optimize() run."""

    arrays: ProblemArrays
    statics: ProblemStatics
    # Which train/test splitter produced the masks, when known:
    # "exact_k" (ratio_splitter / native split_mask) or "bernoulli_block"
    # (distributed per-block splitter, data/native.py) — the two yield
    # DIFFERENT partitions for the same (data, seed); recorded so
    # mixed-path comparisons are detectable.
    split_variant: Optional[str] = None

    @property
    def shape(self):
        return self.arrays.data.shape

    @property
    def n_levels(self):
        return self.statics.n_levels

    @property
    def masked(self):
        return self.statics.masked

    @property
    def ctns(self):
        return self.arrays.ctns

    @property
    def codes(self):
        return self.arrays.codes

    @property
    def data(self):
        return self.arrays.data

    @property
    def train_mask(self):
        return self.arrays.train_mask

    @property
    def test_mask(self):
        return self.arrays.test_mask


def _finish_problem(data_d, train_d, test_d, codes_d, ctns_d, n_levels,
                    masked, mesh, precompute=True) -> Problem:
    pre = None
    if precompute:
        pre = _precompute_row_constants(data_d, train_d, codes_d,
                                        tuple(n_levels), ctns_d, masked)
    return Problem(
        arrays=ProblemArrays(
            data=data_d,
            train_mask=train_d,
            test_mask=test_d,
            codes=tuple(codes_d),
            ctns=ctns_d,
            pre=pre,
        ),
        statics=ProblemStatics(
            n_levels=tuple(n_levels), masked=masked, mesh=mesh
        ),
    )


def build_problem(
    data: np.ndarray,
    confounder: np.ndarray,
    train_indicator: np.ndarray,
    test_indicator: np.ndarray,
    ctns_confounder: Optional[np.ndarray] = None,
    masked: bool = True,
    dtype=jnp.float32,
    sharding: Optional[ShardingConfig] = None,
    mask_dtype=None,
    precompute: bool = True,
) -> Problem:
    """Stage host arrays onto devices.

    confounder: (N, C) integer level codes per discrete confounder (any
    integer labels; densified per column like the reference's `unique()`
    indexing, src/optimize.cpp:296-313).
    mask_dtype: storage dtype of the indicator matrices.  uint8 quarters the
    persistent mask footprint (the memory-lean mode for the synthetic
    BASELINE configs); masks are cast to the compute dtype inside jit where
    a matmul needs them (one fused/transient copy per iteration).
    """
    confounder = np.asarray(confounder)
    codes_np, n_levels = [], []
    for c in range(confounder.shape[1]):
        levels, inv = np.unique(confounder[:, c], return_inverse=True)
        codes_np.append(inv.astype(np.int32))
        n_levels.append(int(levels.size))

    mesh = make_mesh(sharding) if sharding is not None else None
    data_d, train_d, test_d, codes_d, ctns_d = shard_problem_arrays(
        mesh,
        np.asarray(data, np.float32),
        train_indicator,
        test_indicator,
        codes_np,
        None if ctns_confounder is None else np.asarray(ctns_confounder, np.float32),
        dtype,
        mask_dtype=mask_dtype,
    )
    return _finish_problem(data_d, train_d, test_d, codes_d, ctns_d,
                           n_levels, masked, mesh, precompute=precompute)


def build_problem_distributed(
    data,
    train_indicator,
    test_indicator,
    codes,
    n_levels: Tuple[int, ...],
    global_shape: Tuple[int, int],
    sharding: ShardingConfig,
    ctns_confounder=None,
    n_ctns: int = 0,
    masked: bool = True,
    dtype=jnp.float32,
    mask_dtype=None,
    precompute: bool = True,
) -> Problem:
    """Build a globally-sharded Problem WITHOUT any process materializing
    the full matrix (BASELINE.json configs 4-5; the reference is a single
    in-RAM process, src/Makevars:11-13, so this subsystem is new).

    Each of data / train_indicator / test_indicator (and ctns_confounder)
    is either
      * this process's local block, covering exactly
        sharding.distributed.process_block(mesh, P('rows','cols'), shape) —
        assembled with jax.make_array_from_process_local_data; or
      * a callable cb(index: tuple[slice, ...]) -> numpy block, invoked once
        per addressable device shard — so no allocation ever exceeds one
        shard (for matrices bigger than host RAM).

    codes: list of per-confounder level codes — local (row-block) arrays or
    callables like above; they must already be densified to [0, n_levels[v])
    GLOBALLY (a local np.unique would renumber levels inconsistently across
    hosts).  n_levels is therefore explicit.
    """
    from jax.sharding import PartitionSpec as P

    from insider_tpu.sharding.distributed import (
        make_global_array,
        make_global_array_from_callback,
    )

    mesh = make_mesh(sharding)
    N, M = global_shape
    check_divisible(mesh, global_shape)
    np_f = np.dtype(jnp.dtype(dtype).name)
    np_m = np_f if mask_dtype is None else np.dtype(jnp.dtype(mask_dtype).name)

    def _to_global(x, spec, shape, np_dtype):
        if x is None:
            return None
        if callable(x):
            return make_global_array_from_callback(shape, mesh, spec, x,
                                                   np_dtype=np_dtype)
        return make_global_array(np.asarray(x, np_dtype), mesh, spec,
                                 global_shape=shape)

    mat = P("rows", "cols")
    data_d = _to_global(data, mat, (N, M), np_f)
    train_d = _to_global(train_indicator, mat, (N, M), np_m)
    test_d = _to_global(test_indicator, mat, (N, M), np_m)
    codes_d = [_to_global(c, P("rows"), (N,), np.int32) for c in codes]
    ctns_d = _to_global(ctns_confounder, P("rows", None), (N, n_ctns), np_f)
    prob = _finish_problem(data_d, train_d, test_d, codes_d, ctns_d,
                           list(n_levels), masked, mesh,
                           precompute=precompute)
    # Callback-built masks come from the per-block Bernoulli splitter
    # (data/native.py split_mask_block), which partitions differently from
    # ratio_splitter's exact-k sample — record the variant.
    prob.split_variant = ("bernoulli_block" if callable(train_indicator)
                          else None)
    return prob


# Memory budget for the one-hot fast path: skip it for a confounder whose
# E or level-sum matrices would exceed these byte counts.
_FAST_E_BYTES = 256 * 1024 * 1024
_FAST_LM_BYTES = 512 * 1024 * 1024


# Column-chunk the precompute contractions when the (N, M) transients they
# need (widened mask, mask .* data) would exceed this budget — at the
# capacity shapes a whole-matrix wx is an 8+ GB transient that OOMs setup
# even though the steady-state iteration fits.
_PRECOMPUTE_TRANSIENT_BYTES = 1 * 1024 * 1024 * 1024


def _chunked_cols(fn_chunk, M, chunk):
    """Concatenate fn_chunk(c0, c1) blocks along the column axis."""
    outs = [fn_chunk(c0, min(c0 + chunk, M)) for c0 in range(0, M, chunk)]
    return jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]


def _precompute_row_constants(data, mask, codes, n_levels, ctns, masked
                              ) -> RowPrecomp:
    from insider_tpu.ops.row_update import one_hot_levels

    N, M = data.shape
    HI = HIGHEST
    chunk = M
    if N * M * 4 > _PRECOMPUTE_TRANSIENT_BYTES:
        chunk = max(1024, _PRECOMPUTE_TRANSIENT_BYTES // (4 * N) // 256 * 256)

    def mask_f(c0, c1):
        m = mask[:, c0:c1]
        return m if m.dtype == data.dtype else m.astype(data.dtype)

    def wx_c(c0, c1):
        # wx = mask .* data exists only chunk-transiently: no persistent
        # (N, M) wx copy is kept (it would double the data footprint).
        return mask_f(c0, c1) * data[:, c0:c1]

    e, mw, d, counts = [], [], [], []
    for c, L in zip(codes, n_levels):
        if N * L * 4 > _FAST_E_BYTES or 2 * L * M * 4 > _FAST_LM_BYTES:
            e.append(None)
            mw.append(None)
            d.append(None)
            counts.append(None)
            continue
        E = one_hot_levels(c, L)
        e.append(E)
        counts.append(jnp.sum(E, axis=0))
        if masked:
            mw.append(_chunked_cols(
                lambda c0, c1: jnp.matmul(E.T, mask_f(c0, c1), precision=HI),
                M, chunk))
            d.append(_chunked_cols(
                lambda c0, c1: jnp.matmul(E.T, wx_c(c0, c1), precision=HI),
                M, chunk))
        else:
            mw.append(None)
            d.append(_chunked_cols(
                lambda c0, c1: jnp.matmul(E.T, data[:, c0:c1], precision=HI),
                M, chunk))
    q = bc = dc = cc = None
    if ctns is not None:
        cc = jnp.sum(ctns * ctns, axis=0)                      # (P,)
        if masked:
            q = _chunked_cols(
                lambda c0, c1: jnp.matmul((ctns * ctns).T, mask_f(c0, c1),
                                          precision=HI), M, chunk)  # (P, M)
            bc = _chunked_cols(
                lambda c0, c1: jnp.matmul(ctns.T, wx_c(c0, c1),
                                          precision=HI), M, chunk)  # (P, M)
        else:
            dc = _chunked_cols(
                lambda c0, c1: jnp.matmul(ctns.T, data[:, c0:c1],
                                          precision=HI), M, chunk)
    return RowPrecomp(e=tuple(e), mw=tuple(mw), d=tuple(d),
                      counts=tuple(counts), ctns_q=q, ctns_bc=bc,
                      ctns_dc=dc, ctns_cc=cc)


def _debug_check_finite(tag: str, x: jax.Array) -> None:
    """Sanitizer check (SURVEY.md §5): under FitConfig.debug_checks the
    driver runs the step chunk through `checkify`, and this pins the FIRST
    non-finite value to the block update that produced it.  The reference
    has no analog (NaNs surface only in the R-side is_converged warning,
    R/utils.R:126-128)."""
    from jax.experimental import checkify

    checkify.check(jnp.all(jnp.isfinite(x)),
                   f"non-finite values produced by {tag}")


def _row_factor(arrays: ProblemArrays, state: InsiderState) -> jax.Array:
    """R = sum_v V_v[codes_v] + C W  (src/optimize.cpp:365-373)."""
    R = state.cfd_factors[0][arrays.codes[0]]
    for v in range(1, len(arrays.codes)):
        R = R + state.cfd_factors[v][arrays.codes[v]]
    if arrays.ctns is not None:
        R = R + jnp.matmul(arrays.ctns, state.ctns_factor, precision=HIGHEST)
    return R


def _als_iteration(arrays: ProblemArrays, statics: ProblemStatics,
                   step_statics: StepStatics, hypers: Hypers,
                   state: InsiderState,
                   sub_tol_eff: jax.Array) -> InsiderState:
    """One full ALS iteration (src/optimize.cpp:325-379)."""
    F = state.column_factor
    mask_raw = arrays.train_mask
    # f32 view for the matmuls (the mask may be stored uint8).
    mask = (mask_raw if mask_raw.dtype == F.dtype
            else mask_raw.astype(F.dtype))
    masked = statics.masked

    gram = jnp.matmul(F, F.T, precision=HIGHEST)
    R = _row_factor(arrays, state)

    # --- row-side: block Gauss-Seidel over confounders (:335-362) ---
    # The reference maintains an (N, M) residual and adds/subtracts each
    # confounder's contribution (two N*K*M matmuls per confounder).  We keep
    # the cheap (N, K) row factor up to date instead and materialize each
    # confounder's add-back residual directly: data - (R - V_v[codes]) @ F —
    # one N*K*M matmul per confounder, mathematically identical.
    cfd_new: List[jax.Array] = list(state.cfd_factors)
    n_cfd = len(arrays.codes)
    pre = arrays.pre

    # Every confounder's level gram uses the same F (F only changes in the
    # column update below), so build the (K^2, M) outer-product table once
    # and compute ALL fast-path confounders' grams in a single (sum_L, M) @
    # (M, K^2) matmul instead of one small matmul + table rebuild each.
    level_xtx: List[Optional[jax.Array]] = [None] * n_cfd
    if masked and pre is not None:
        fast_v = [v for v in range(n_cfd) if pre.e[v] is not None]
        if fast_v:
            from insider_tpu.ops.row_update import (factor_outer_table,
                                                    level_gram_masked)

            mw_cat = jnp.concatenate([pre.mw[v] for v in fast_v], axis=0)
            xtx_cat = level_gram_masked(mw_cat, F, factor_outer_table(F))
            off = 0
            for v in fast_v:
                L = statics.n_levels[v]
                level_xtx[v] = xtx_cat[off:off + L]
                off += L

    for v in range(n_cfd):
        R_minus = R - cfd_new[v][arrays.codes[v]]
        fast = pre is not None and pre.e[v] is not None
        if masked:
            if fast:
                V = row_update.update_row_factor_masked_fast(
                    pre.e[v], pre.mw[v], pre.d[v], mask, R_minus, F,
                    hypers.lam1, xtx=level_xtx[v],
                )
            else:
                resid_plus = arrays.data - losses.predict(R_minus, F)
                V = row_update.update_row_factor_masked(
                    resid_plus, mask, F, arrays.codes[v],
                    statics.n_levels[v], hypers.lam1,
                )
        else:
            if fast:
                V = row_update.update_row_factor_dense_fast(
                    pre.e[v], pre.d[v], pre.counts[v], R_minus, F, gram,
                    hypers.lam1,
                )
            else:
                resid_plus = arrays.data - losses.predict(R_minus, F)
                V = row_update.update_row_factor_dense(
                    resid_plus, F, gram, arrays.codes[v],
                    statics.n_levels[v], hypers.lam1,
                )
        if step_statics.debug_checks:
            _debug_check_finite(f"row update V[{v}] (optimize_row)", V)
        cfd_new[v] = V
        R = R_minus + V[arrays.codes[v]]

    # --- continuous covariates (:341-350) ---
    W = state.ctns_factor
    if arrays.ctns is not None:
        P = arrays.ctns.shape[1]
        for j in range(P):
            c = arrays.ctns[:, j]
            R_minus = R - jnp.outer(c, W[j])
            if masked:
                if pre is not None and pre.ctns_q is not None:
                    w = continuous.update_ctns_row_masked_fast(
                        pre.ctns_q[j], pre.ctns_bc[j], mask, R_minus, F, c,
                        W[j], hypers.lam1, tol=step_statics.ctns_tol,
                        max_sweeps=step_statics.max_ctns_sweeps,
                    )
                else:
                    resid_plus = arrays.data - losses.predict(R_minus, F)
                    w = continuous.update_ctns_row_masked(
                        resid_plus, mask, F, c, W[j], hypers.lam1,
                        tol=step_statics.ctns_tol,
                        max_sweeps=step_statics.max_ctns_sweeps,
                    )
            else:
                if pre is not None and pre.ctns_dc is not None:
                    w = continuous.update_ctns_row_dense_fast(
                        pre.ctns_dc[j], pre.ctns_cc[j], R_minus, F, gram, c,
                        hypers.lam1,
                    )
                else:
                    resid_plus = arrays.data - losses.predict(R_minus, F)
                    w = continuous.update_ctns_row_dense(resid_plus, F, gram,
                                                         c, hypers.lam1)
            if step_statics.debug_checks:
                _debug_check_finite(
                    f"continuous update W[{j}] (optimize_continuous_v2)", w)
            W = W.at[j].set(w)
            R = R_minus + jnp.outer(c, w)

    # --- rebuild row factor exactly (:365-373; cheap, avoids accumulation
    # drift in the incrementally-maintained R), update columns (:376) ---
    state = InsiderState(cfd_new, W, F, state.key)
    R = _row_factor(arrays, state)
    if masked:
        F_new, key, _ = col_update.update_columns_masked(
            arrays.data, mask_raw, R, F, hypers.lam2, hypers.alpha,
            sub_tol_eff, state.key, step_statics.max_cd_sweeps,
            alpha_is_zero=step_statics.alpha_is_zero,
            use_pallas=step_statics.use_pallas,
            mesh=statics.mesh,
            solver=step_statics.col_solver,
            max_fss_outer=step_statics.max_fss_outer,
            fss_polish=step_statics.fss_polish,
            max_fss_polish_sweeps=step_statics.max_fss_polish_sweeps,
            cd_warm_start=step_statics.cd_warm_start,
        )
    else:
        F_new, key, _ = col_update.update_columns_dense(
            arrays.data, R, F, hypers.lam2, hypers.alpha,
            sub_tol_eff, state.key, step_statics.max_cd_sweeps,
            alpha_is_zero=step_statics.alpha_is_zero,
            use_pallas=step_statics.use_pallas,
            mesh=statics.mesh,
            solver=step_statics.col_solver,
            max_fss_outer=step_statics.max_fss_outer,
            fss_polish=step_statics.fss_polish,
            max_fss_polish_sweeps=step_statics.max_fss_polish_sweeps,
            cd_warm_start=step_statics.cd_warm_start,
        )
    if step_statics.debug_checks:
        _debug_check_finite("column update F (optimize_col)", F_new)
    new_state = InsiderState(cfd_new, W, F_new, key)
    return apply_constraints(statics.mesh, new_state)


@partial(jax.jit, static_argnums=(1, 2), donate_argnums=(4,))
def _run_steps(arrays: ProblemArrays, statics: ProblemStatics,
               step_statics: StepStatics, hypers: Hypers, state: InsiderState,
               sub_tol_eff: jax.Array, n_steps: jax.Array) -> InsiderState:
    """n_steps full ALS iterations on device (n_steps is dynamic: one
    executable serves every chunk size)."""

    def body(_, st):
        return _als_iteration(arrays, statics, step_statics, hypers, st,
                              sub_tol_eff)

    return lax.fori_loop(0, n_steps, body, state)


def _evaluate_impl(arrays: ProblemArrays, statics: ProblemStatics,
                   state: InsiderState):
    R = _row_factor(arrays, state)
    residual = arrays.data - losses.predict(R, state.column_factor)
    if statics.masked:
        ev = losses.evaluate_masked(residual, arrays.train_mask,
                                    arrays.test_mask)
    else:
        ev = losses.evaluate_dense(residual)
    reg = losses.regularization_sums(state.cfd_factors, state.ctns_factor,
                                     state.column_factor)
    return ev, reg


_evaluate = partial(jax.jit, static_argnums=(1,))(_evaluate_impl)


@partial(jax.jit, static_argnums=(1, 2))
def _run_steps_eval_checked(arrays: ProblemArrays, statics: ProblemStatics,
                            step_statics: StepStatics, hypers: Hypers,
                            state: InsiderState, sub_tol_eff: jax.Array,
                            n_steps: jax.Array):
    """_run_steps_eval under checkify (FitConfig.debug_checks): returns
    (error, (state, metrics)); the host throws the error with the failing
    block's tag.  No donation — debug mode keeps buffers inspectable."""
    from jax.experimental import checkify

    def f(arrays, hypers, state, sub_tol_eff, n_steps):
        def body(_, st):
            return _als_iteration(arrays, statics, step_statics, hypers, st,
                                  sub_tol_eff)

        state2 = lax.fori_loop(0, n_steps, body, state)
        ev, reg = _evaluate_impl(arrays, statics, state2)
        return state2, losses.pack_metrics(ev, reg)

    checked = checkify.checkify(f, errors=checkify.user_checks)
    return checked(arrays, hypers, state, sub_tol_eff, n_steps)


def _loss_pair_from_metrics(vec: jax.Array, lam1, lam2, alpha, masked: bool):
    """On-device double-single loss from a pack_metrics vector.

    Mirrors losses.finalize_loss's combination (src/utils.cpp:93-100) in
    (hi, lo) f32 pairs so the boundary chain can evaluate the decay ladder
    and the relative-loss stop WITHOUT a host round-trip.  Error O(eps^2)
    per op — the same accuracy class as the host f64 combination of the
    same compensated sums."""
    from insider_tpu.ops import precise

    def scale(hi, lo, s):
        p, e = precise.two_prod(hi, s)
        return precise.two_sum(p, lo * s + e)

    sr = (vec[0], vec[1])
    rr = scale(vec[8], vec[9], lam1)
    c2 = scale(vec[10], vec[11], lam2 * (1.0 - alpha))
    l1 = scale(vec[12], vec[13], lam2 * alpha)
    h, l = scale(*sr, jnp.float32(0.5))
    h, l = precise.ds_add(h, l, *scale(*rr, jnp.float32(0.5)))
    h, l = precise.ds_add(h, l, *scale(*c2, jnp.float32(0.5)))
    return precise.ds_add(h, l, *l1)


@partial(jax.jit, static_argnums=(1, 2, 8), donate_argnums=(4,))
def _run_boundary_chain(arrays: ProblemArrays, statics: ProblemStatics,
                        step_statics: StepStatics, hypers: Hypers,
                        state: InsiderState, base_sub_tol: jax.Array,
                        decay0: jax.Array, pre_loss_pair: jax.Array,
                        chain: tuple):
    """Up to n_chunks boundaries of check_every iterations each, chained ON
    DEVICE: between boundaries the sub_tol decay ladder
    (src/optimize.cpp:389-403) and the relative-loss stop (:405) run as
    traced ops on the compensated loss pair, so one dispatch and one host
    transfer serve many boundaries.

    chain = (n_chunks, check_every, global_tol) — static.
    Returns (state, metrics (n_chunks, N_METRICS + 1): the pack_metrics
    slots + the decay USED for that boundary, flags (4,): [n_done,
    decay_next, converged, diverged]).
    """
    from insider_tpu.ops import precise

    n_chunks, check_every, global_tol = chain

    def chunk(st, sub_tol_eff):
        def body(_, s):
            return _als_iteration(arrays, statics, step_statics, hypers, s,
                                  sub_tol_eff)
        return lax.fori_loop(0, check_every, body, st)

    metrics0 = jnp.zeros((n_chunks, losses.N_METRICS + 1), jnp.float32)

    def cond(carry):
        st, decay, pre, k, metrics, conv, div = carry
        return (k < n_chunks) & (~conv) & (~div)

    def body(carry):
        st, decay, pre, k, metrics, conv, div = carry
        st = chunk(st, base_sub_tol * decay)
        ev, reg = _evaluate_impl(arrays, statics, st)
        vec = losses.pack_metrics(ev, reg)
        metrics = lax.dynamic_update_slice(
            metrics, jnp.concatenate([vec, decay[None]])[None], (k, 0))
        lh, ll = _loss_pair_from_metrics(vec, hypers.lam1, hypers.lam2,
                                         hypers.alpha, statics.masked)
        # delta/pre in ds -> f32 (the ladder rungs are decades; the stop
        # threshold is resolved far above the pair's ~1e-14 noise)
        dh, dl = precise.ds_add(pre[0], pre[1], -lh, -ll)
        delta = dh + dl
        from insider_tpu.config import decay_from_delta_loss_jnp

        decay_new = decay_from_delta_loss_jnp(delta)
        pre_val = pre[0] + pre[1]
        rel = delta / pre_val
        conv = rel < jnp.float32(global_tol)
        div = ~jnp.isfinite(lh)
        return (st, decay_new, jnp.stack([lh, ll]), k + 1, metrics, conv,
                div)

    st, decay, pre, k, metrics, conv, div = lax.while_loop(
        cond, body,
        (state, decay0, pre_loss_pair, jnp.int32(0), metrics0,
         jnp.bool_(False), jnp.bool_(False)))
    flags = jnp.stack([k.astype(jnp.float32), decay,
                       conv.astype(jnp.float32), div.astype(jnp.float32)])
    return st, metrics, flags


@partial(jax.jit, static_argnums=(1, 2), donate_argnums=(4,))
def _run_steps_eval(arrays: ProblemArrays, statics: ProblemStatics,
                    step_statics: StepStatics, hypers: Hypers,
                    state: InsiderState, sub_tol_eff: jax.Array,
                    n_steps: jax.Array):
    """n_steps ALS iterations + the boundary eval in ONE device program.

    The reference evaluates every 10 iterations (src/optimize.cpp:381-408);
    fusing that eval into the step chunk and packing the partial sums into
    one vector makes a boundary one dispatch + one small transfer.
    n_steps=0 serves the initial eval (src/optimize.cpp:320-323) with the
    same executable.
    """

    def body(_, st):
        return _als_iteration(arrays, statics, step_statics, hypers, st,
                              sub_tol_eff)

    state = lax.fori_loop(0, n_steps, body, state)
    ev, reg = _evaluate_impl(arrays, statics, state)
    return state, losses.pack_metrics(ev, reg)


def _stage_state_global(mesh, state: InsiderState) -> InsiderState:
    """Lift a process-local initial state onto a multi-process global mesh.

    init_state is deterministic in the seed, so every process holds the same
    full factor values; each leaf becomes a global jax.Array (factors
    replicated, F column-sharded per sharding/mesh.py) by slicing the local
    copy per addressable shard.  Single-process meshes (including virtual
    devices) need none of this — pjit shards local arrays directly.
    """
    if mesh is None or jax.process_count() == 1:
        return state
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x, spec):
        if x is None:
            return None
        xnp = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            xnp.shape, sh, lambda idx, xnp=xnp: xnp[idx])

    return InsiderState(
        [put(f, P(None, None)) for f in state.cfd_factors],
        put(state.ctns_factor, P(None, None)),
        put(state.column_factor, P(None, "cols")),
        put(state.key, P()),
    )


def _to_host(x):
    """np.asarray that also works for multi-process global arrays.

    Under a multi-host mesh the column factor is genuinely distributed
    (sharding/mesh.py pins P(None, 'cols')), so no single process can
    np.asarray it; all-gather it across processes first.  Single-process
    (including virtual-device meshes) takes the plain path.
    """
    if x is None:
        return None
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


@dataclasses.dataclass
class OptimizeResult:
    row_matrices: List[np.ndarray]
    ctns_factor: Optional[np.ndarray]
    column_factor: np.ndarray
    train_rmse: float
    test_rmse: float
    loss: float
    n_iter: int
    history: List[dict]
    state: InsiderState
    # True when the run was aborted because the loss went NaN/Inf (the
    # reference only *warns*, R/utils.R:126-128, and its stop test is False
    # for NaN so a diverged run would silently burn max_iter; we abort).
    diverged: bool = False
    # True iff the relative-loss stop actually fired ((pre-loss)/pre <
    # global_tol, src/optimize.cpp:405) — NOT inferred from n_iter, which
    # conflates cap-exhaustion with convergence at the boundary.
    converged: bool = False


def optimize(
    problem: Problem,
    config: FitConfig,
    state: Optional[InsiderState] = None,
    log_jsonl: Optional[str] = None,
    verbose: bool = True,
    progress_callback: Optional[Callable[[dict], None]] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    profile_dir: Optional[str] = None,
) -> OptimizeResult:
    """Run ALS to convergence.  Mirrors src/optimize.cpp:256-422.

    The convergence protocol replicates the reference exactly: initial loss
    before the loop (:320-323); checks when `iter % check_every == 0` at the
    end of that iteration (:381); stop when (pre-loss)/pre < global_tol
    (:405); sub_tol decay ladder from the 10-iter loss delta (:389-403).

    checkpoint_path: snapshot factors+key at every check boundary; with
    resume=True an existing snapshot restarts the run deterministically from
    (iter, key, factors) (SURVEY.md §5).
    profile_dir: capture a jax.profiler trace of the second step chunk (the
    first is compile) — the tracing subsystem the reference lacks
    (SURVEY.md §5, tracing row).
    """
    N, M = problem.shape
    start_iter = 0
    resume_decay = 1.0
    if resume and checkpoint_path and state is None:
        import os as _os

        if _os.path.exists(checkpoint_path):
            from insider_tpu.checkpoint import load_checkpoint

            state, meta = load_checkpoint(checkpoint_path)
            start_iter = meta["iter"] + 1
            # The sub_tol decay ladder is part of the trajectory
            # (src/optimize.cpp:389-403): restore it so an interrupted run
            # continues bit-identically to an uninterrupted one
            # (SURVEY.md §5 deterministic-resume promise).
            resume_decay = float(meta.get("extra", {}).get("decay", 1.0))
            if verbose:
                logger.info("resumed from %s at iter %d (decay=%g)",
                            checkpoint_path, meta["iter"], resume_decay)
    if state is None:
        state = init_state(
            jax.random.PRNGKey(config.seed),
            problem.n_levels,
            M,
            config.latent_dim,
            n_ctns=0 if problem.ctns is None else problem.ctns.shape[1],
            init_std=config.init_std,
        )

    arrays, statics = problem.arrays, problem.statics
    state = _stage_state_global(statics.mesh, state)

    def finalize(metrics_vec):
        return losses.finalize_metrics_vec(
            metrics_vec, config.lambda1, config.lambda2, config.alpha,
            statics.masked,
        )

    history: List[dict] = []
    jl = open(log_jsonl, "a") if log_jsonl else None

    def emit(rec):
        history.append(rec)
        if jl:
            jl.write(json.dumps(rec) + "\n")
            jl.flush()
        if verbose:
            logger.info(
                "iter %d: loss=%.12g train_rmse=%.12g test_rmse=%.12g "
                "delta=%.6g decay=%g",
                rec["iter"], rec["loss"], rec["train_rmse"], rec["test_rmse"],
                rec.get("delta_loss", float("nan")), rec.get("decay", 1.0),
            )
        if progress_callback:
            progress_callback(rec)

    step_statics = StepStatics.from_config(config)
    hypers = Hypers(
        lam1=jnp.float32(config.lambda1),
        lam2=jnp.float32(config.lambda2),
        alpha=jnp.float32(config.alpha),
    )

    def run_chunk(state, sub_tol_eff, n):
        if config.debug_checks:
            err, (state, metrics) = _run_steps_eval_checked(
                arrays, statics, step_statics, hypers, state, sub_tol_eff,
                jnp.int32(n))
            err.throw()   # raises with the failing block's tag
            return state, metrics
        return _run_steps_eval(arrays, statics, step_statics, hypers, state,
                               sub_tol_eff, jnp.int32(n))

    t0 = time.time()
    # Initial eval (src/optimize.cpp:320-323) via the fused chunk with
    # n_steps=0: same executable as every boundary, one compile total.
    state, metrics = run_chunk(state, jnp.float32(config.sub_tol), 0)
    m = finalize(metrics)
    loss = m["loss"]
    emit({"iter": -1, **m, "elapsed_s": time.time() - t0})
    diverged = not np.isfinite(loss)
    if diverged:
        logger.warning("infinite or missing values in loss at init; "
                       "aborting (reference warns: R/utils.R:126-128)")

    decay = resume_decay
    it = start_iter
    converged = False
    # On-device boundary chaining (config.boundaries_per_dispatch > 1):
    # full check_every-sized boundaries run back-to-back in one dispatch
    # with the decay ladder + stop test evaluated on device; the host
    # fetches one (n_chunks, N_METRICS + 1) metrics block per dispatch
    # instead of one vector per boundary.  The modes that need per-boundary host hooks
    # (checkify sanitizer, profiler capture) and irregular chunks (the
    # first 1-step chunk, max_iter tails) take the single-boundary path.
    chain_ok = (config.boundaries_per_dispatch > 1
                and not config.debug_checks and profile_dir is None)
    while (not diverged) and it <= config.max_iter:
        # Advance to the end of the next check boundary (iterations it .. b).
        boundary = it if it % config.check_every == 0 else (
            (it // config.check_every + 1) * config.check_every
        )
        boundary = min(boundary, config.max_iter)
        n = boundary - it + 1
        n_full = ((config.max_iter - (it - 1)) // config.check_every
                  if n == config.check_every else 0)
        if chain_ok and n_full >= 1:
            n_chunks = min(config.boundaries_per_dispatch, n_full)
            pre_pair = jnp.asarray(
                [np.float32(loss), np.float32(loss - np.float64(np.float32(loss)))],
                jnp.float32)
            state, mbuf, flags = _run_boundary_chain(
                arrays, statics, step_statics, hypers, state,
                jnp.float32(config.sub_tol), jnp.float32(decay), pre_pair,
                (n_chunks, config.check_every, float(config.global_tol)))
            mbuf_h = np.asarray(mbuf)
            flags_h = np.asarray(flags)
            k_done = int(flags_h[0])
            conv_flag = bool(flags_h[2] > 0.5)
            div_flag = bool(flags_h[3] > 0.5)
            base_it = it - 1
            for i in range(k_done):
                b_i = base_it + (i + 1) * config.check_every
                pre_loss = loss
                m = finalize(mbuf_h[i, :losses.N_METRICS])
                loss = m["loss"]
                delta_loss = pre_loss - loss
                emit({
                    "iter": b_i, **m, "delta_loss": delta_loss,
                    "decay": decay_from_delta_loss(delta_loss),
                    "elapsed_s": time.time() - t0,
                })
            decay = float(flags_h[1])     # the chain's own next-decay
            it = base_it + k_done * config.check_every + 1
            last_boundary = base_it + k_done * config.check_every
            if div_flag or not np.isfinite(loss):
                diverged = True
                logger.warning(
                    "infinite or missing values in loss at iter %d; "
                    "aborting (reference warns: R/utils.R:126-128)",
                    last_boundary)
                break
            if checkpoint_path:
                from insider_tpu.checkpoint import save_checkpoint

                save_checkpoint(checkpoint_path, state, it=last_boundary,
                                loss=loss, extra={"decay": decay})
            if conv_flag:
                converged = True
                break
            continue
        sub_tol_eff = jnp.asarray(config.sub_tol * decay, jnp.float32)
        chunk_idx = len(history)  # 1 = first post-init chunk (compile)
        if profile_dir and chunk_idx == 2:
            with jax.profiler.trace(profile_dir):
                state, metrics = run_chunk(state, sub_tol_eff, n)
                jax.block_until_ready(state.column_factor)
        else:
            state, metrics = run_chunk(state, sub_tol_eff, n)
        it = boundary + 1

        pre_loss = loss
        m = finalize(metrics)
        loss = m["loss"]
        delta_loss = pre_loss - loss
        decay = decay_from_delta_loss(delta_loss)
        emit({
            "iter": boundary, **m, "delta_loss": delta_loss, "decay": decay,
            "elapsed_s": time.time() - t0,
        })
        if not np.isfinite(loss):
            # The reference's stop test is False for NaN (R/utils.R:119-130
            # only warns), so a diverged run would spin to max_iter; abort
            # within one check boundary instead.
            diverged = True
            logger.warning(
                "infinite or missing values in loss at iter %d; aborting "
                "(reference warns: R/utils.R:126-128)", boundary)
            break
        if checkpoint_path:
            from insider_tpu.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, state, it=boundary, loss=loss,
                            extra={"decay": decay,
                                   "delta_loss": delta_loss})
        if (pre_loss - loss) / pre_loss < config.global_tol:
            converged = True
            break
        if boundary >= config.max_iter:
            break

    if jl:
        jl.close()

    return OptimizeResult(
        row_matrices=[_to_host(f) for f in state.cfd_factors],
        ctns_factor=_to_host(state.ctns_factor),
        column_factor=_to_host(state.column_factor),
        train_rmse=m["train_rmse"],
        test_rmse=m["test_rmse"],
        loss=loss,
        n_iter=it - 1,
        history=history,
        state=state,
        diverged=diverged,
        converged=converged,
    )
