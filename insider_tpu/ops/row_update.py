"""Row-side (confounder-level) batched ridge updates.

Equivalent of `optimize_row` (src/optimize.cpp:139-198) and the
standalone `fit_interaction` (src/fit_interaction.cpp:10-90).

The reference loops over confounder levels with OpenMP, assembling per-level
normal equations from gathered member rows.  Here the whole confounder updates
in a handful of large batched ops:

  masked:  XtX_l = sum_{i in level l} F diag(w_i) F^T
              ==> segment-sum the mask over levels, then one (L,M)@(M,K^2)
                  matmul against the elementwise factor outer-product table.
           Xty_l = F @ (segment-sum of masked residual)^T
  dense:   XtX_l = n_l * gram,  Xty_l = F @ (segment-sum of residual)^T
  solve:   batched K x K Cholesky solve over all L levels at once.

This replaces the reference's per-row "Gram complement" trick
(src/optimize.cpp:170) — a CPU cache optimization — with direct masked
accumulation, which maps onto dense matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def factor_outer_table(F: jax.Array) -> jax.Array:
    """(K,M) -> (K*K, M) table of f_kj * f_lj, shared by masked gram builds."""
    K, M = F.shape
    return (F[:, None, :] * F[None, :, :]).reshape(K * K, M)


def level_gram_masked(mask_by_level: jax.Array, F: jax.Array,
                      PF: jax.Array = None) -> jax.Array:
    """Per-level masked Grams: (L,M) x (K,M) -> (L,K,K).

    mask_by_level[l, j] = number of member rows of level l with entry (i, j)
    observed (the segment-sum of the 0/1 train mask over the level).

    PF: optionally the precomputed factor_outer_table(F) — within one ALS
    iteration every confounder's gram uses the same F (F only changes in the
    column update), so the driver builds the (K^2, M) table once and batches
    all confounders' (L_v, M) blocks into a single matmul
    (train/als.py _als_iteration).
    """
    K = F.shape[0]
    if PF is None:
        PF = factor_outer_table(F)
    XtX = jnp.matmul(mask_by_level, PF.T, precision=HIGHEST)
    return XtX.reshape(-1, K, K)


def _ridge_solve_batched(XtX: jax.Array, Xty: jax.Array, lam) -> jax.Array:
    """Solve (XtX_l + lam*I) v_l = Xty_l for all l.  XtX: (L,K,K), Xty: (L,K).

    SPD by construction (+ridge); uses the unrolled vectorized Gauss-Jordan
    (ops/linalg.py) — the batched analog of the reference's
    solve(likely_sympd) (src/optimize.cpp:175).
    """
    from insider_tpu.ops.linalg import spd_solve

    K = XtX.shape[-1]
    A = XtX + lam * jnp.eye(K, dtype=XtX.dtype)
    return spd_solve(A, Xty)


def update_row_factor_masked(
    residual_plus: jax.Array,  # (N, M) residual with this confounder added back
    mask: jax.Array,           # (N, M) 0/1 train indicator
    F: jax.Array,              # (K, M) column factor
    codes: jax.Array,          # (N,) int32 level codes in [0, L)
    n_levels: int,
    lam: float,
) -> jax.Array:
    """Masked (tuning==1) per-level ridge, src/optimize.cpp:150-176."""
    seg = lambda x: jax.ops.segment_sum(x, codes, num_segments=n_levels)
    Mw = seg(mask)                                   # (L, M)
    S = seg(mask * residual_plus)                    # (L, M)
    XtX = level_gram_masked(Mw, F)                   # (L, K, K)
    Xty = jnp.matmul(S, F.T, precision=HIGHEST)      # (L, K)
    return _ridge_solve_batched(XtX, Xty, lam)


def one_hot_levels(codes: jax.Array, n_levels: int, dtype=jnp.float32):
    """Dense one-hot membership matrix E (N, L) — the index_matrices of
    src/optimize.cpp:296-313.  Segment sums become (L,N)@(N,M) matmuls
    instead of scatter-adds."""
    return jax.nn.one_hot(codes, n_levels, dtype=dtype)


def update_row_factor_masked_fast(
    E: jax.Array,        # (N, L) one-hot
    Mw: jax.Array,       # (L, M) = E^T @ mask            (per-problem constant)
    D: jax.Array,        # (L, M) = E^T @ (mask * data)   (per-problem constant)
    mask: jax.Array,     # (N, M)
    R_minus: jax.Array,  # (N, K) row factor excluding this confounder
    F: jax.Array,        # (K, M)
    lam,
    xtx: jax.Array = None,  # optional precomputed (L, K, K) level grams
) -> jax.Array:
    """Masked per-level ridge with precomputed constants.

    The add-back residual is data - R_minus @ F, so the masked level sums
    split as E^T(W .* data) - E^T(W .* (R_minus F)): the first term is the
    constant D, and only the second is per-iteration work — one (N,K)@(K,M)
    predict, one elementwise mask, one (L,N)@(N,M) matmul.  Mathematically
    identical to update_row_factor_masked.

    xtx: optionally the precomputed level_gram_masked(Mw, F) — the driver
    batches all confounders' grams into one matmul per iteration.
    """
    P = jnp.matmul(R_minus, F, precision=HIGHEST)          # (N, M)
    T = jnp.matmul(E.T, mask * P, precision=HIGHEST)   # (L, M)
    S = D - T
    XtX = level_gram_masked(Mw, F) if xtx is None else xtx  # (L, K, K)
    Xty = jnp.matmul(S, F.T, precision=HIGHEST)            # (L, K)
    return _ridge_solve_batched(XtX, Xty, lam)


def update_row_factor_dense_fast(
    E: jax.Array,        # (N, L)
    Ddense: jax.Array,   # (L, M) = E^T @ data            (per-problem constant)
    counts: jax.Array,   # (L,)
    R_minus: jax.Array,  # (N, K)
    F: jax.Array,
    gram: jax.Array,     # (K, K)
    lam,
) -> jax.Array:
    """Dense per-level ridge with precomputed constants
    (src/optimize.cpp:178-191 semantics)."""
    P = jnp.matmul(R_minus, F, precision=HIGHEST)
    S = Ddense - jnp.matmul(E.T, P, precision=HIGHEST)
    XtX = counts[:, None, None] * gram
    Xty = jnp.matmul(S, F.T, precision=HIGHEST)
    return _ridge_solve_batched(XtX, Xty, lam)


def update_row_factor_dense(
    residual_plus: jax.Array,
    F: jax.Array,
    gram: jax.Array,           # (K, K) = F F^T
    codes: jax.Array,
    n_levels: int,
    lam: float,
) -> jax.Array:
    """Dense (tuning==0) fast path, src/optimize.cpp:178-191."""
    seg = lambda x: jax.ops.segment_sum(x, codes, num_segments=n_levels)
    counts = seg(jnp.ones(codes.shape[0], F.dtype))  # (L,)
    S = seg(residual_plus)                           # (L, M)
    XtX = counts[:, None, None] * gram               # (L, K, K)
    Xty = jnp.matmul(S, F.T, precision=HIGHEST)
    return _ridge_solve_batched(XtX, Xty, lam)


def fit_interaction(
    residual: jax.Array,
    train_indicator: jax.Array,
    interaction_codes: jax.Array,
    column_factor: jax.Array,
    masked: bool = True,
) -> jax.Array:
    """Standalone per-level least-squares op (src/fit_interaction.cpp:10-90).

    The reference compiles this but never calls it (not in the export table,
    src/RcppExports.cpp:112-119); interactions are folded into the confounder
    list in R instead (R/insider.R:34-40).  We expose it for parity.  Note the
    reference solves the *unregularized* normal equations (its `lambda`
    argument is unused, fit_interaction.cpp:54,82); we mirror that but add a
    tiny jitter-free exact solve via the same batched path with lam=0.
    """
    codes = jnp.asarray(interaction_codes, jnp.int32)
    # Host-level API: codes must be concrete so the output shape (L, K) is known.
    n_levels = int(codes.max()) + 1
    F = column_factor
    if masked:
        return update_row_factor_masked(
            residual, train_indicator, F, codes, n_levels, lam=0.0
        )
    gram = jnp.matmul(F, F.T, precision=HIGHEST)
    return update_row_factor_dense(residual, F, gram, codes, n_levels, lam=0.0)
