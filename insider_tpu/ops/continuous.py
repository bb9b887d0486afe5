"""Continuous-covariate coefficient updates.

Equivalent of `optimize_continuous_v2` (src/optimize.cpp:77-137;
the driver calls only v2, src/optimize.cpp:345).  One covariate column c (N,)
with coefficient row w (K,) is a K-dimensional ridge problem; the reference
runs scalar cyclic CD with residual maintenance over the full (N, M) matrix.

Here the problem is projected into K-space once:

    XtX_kl = sum_ij c_i^2 w^mask_ij F_kj F_lj  =  (F * q) F^T,
             q_j = (c^2)^T mask_j                       [(K,K), one matmul]
    b_k    = c^T (mask .* resid_plus) F_k               [(K,), one matmul]

and the CD loop (sequential coordinates 0..K-1, as the reference,
src/optimize.cpp:104) runs entirely on K scalars inside a while_loop with the
reference's stop rule sum|delta w| < 1e-1 (src/optimize.cpp:122).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def update_ctns_row_masked(
    resid_plus: jax.Array,   # (N, M) residual with this covariate added back
    mask: jax.Array,         # (N, M)
    F: jax.Array,            # (K, M)
    c: jax.Array,            # (N,) covariate column
    w0: jax.Array,           # (K,) warm start
    lam: float,
    tol: float = 1e-1,
    max_sweeps: int = 100,
) -> jax.Array:
    """Masked (tuning==1) path of optimize_continuous_v2."""
    q = jnp.matmul(c * c, mask, precision=HIGHEST)            # (M,)
    XtX = jnp.matmul(F * q[None, :], F.T, precision=HIGHEST)  # (K, K)
    b = jnp.matmul(F, jnp.matmul(c, mask * resid_plus, precision=HIGHEST),
                   precision=HIGHEST)                          # (K,)
    return _ctns_cd(XtX, b, w0, lam, tol, max_sweeps)


def update_ctns_row_masked_fast(
    q: jax.Array,          # (M,) = (c^2)^T mask          (per-problem constant)
    bc: jax.Array,         # (M,) = c^T (mask .* data)    (per-problem constant)
    mask: jax.Array,       # (N, M)
    R_minus: jax.Array,    # (N, K) row factor excluding this covariate
    F: jax.Array,
    c: jax.Array,
    w0: jax.Array,
    lam,
    tol: float = 1e-1,
    max_sweeps: int = 100,
) -> jax.Array:
    """Masked path with precomputed constants: the add-back residual is
    data - R_minus F, so c^T(W .* resid) = bc - c^T(W .* (R_minus F)).

    The correction term contracts over ROWS first — v_j = sum_k
    [mask^T (c .* R_minus)]_{jk} F_kj — so no (N, M) predict is ever
    materialized (the naive form costs a 6-pass (N,K)@(K,M) matmul plus two
    full-matrix reads PER COVARIATE per iteration; this form is one
    3-pass (M,N)@(N,K) matmul with a (M,K) output).  Mathematically
    identical; the mask operand is exact in bf16 so the per-operand
    precision loses nothing.
    """
    XtX = jnp.matmul(F * q[None, :], F.T, precision=HIGHEST)
    G = jnp.matmul(mask.T, R_minus * c[:, None],
                   precision=HIGHEST)                     # (M, K)
    v = jnp.sum(G.T * F, axis=0)                              # (M,)
    b = jnp.matmul(F, bc - v, precision=HIGHEST)
    return _ctns_cd(XtX, b, w0, lam, tol, max_sweeps)


def update_ctns_row_masked_v1(
    resid_plus: jax.Array,
    mask: jax.Array,
    F: jax.Array,
    c: jax.Array,
    w0: jax.Array,
    lam: float,
    tol: float = 1e-3,
    max_sweeps: int = 100,
) -> jax.Array:
    """optimize_continuous (v1, src/optimize.cpp:15-63): identical CD to v2
    but stops on the per-sweep loss decrease delta < 1e-3 (:59) instead of
    sum|delta w|.  Exported by the reference bridge but unused by the driver
    (which calls v2 only, :345); kept for API parity.
    """
    q = jnp.matmul(c * c, mask, precision=HIGHEST)
    XtX = jnp.matmul(F * q[None, :], F.T, precision=HIGHEST)
    b = jnp.matmul(F, jnp.matmul(c, mask * resid_plus, precision=HIGHEST),
                   precision=HIGHEST)
    return _ctns_cd(XtX, b, w0, lam, tol, max_sweeps, loss_criterion=True)


def _ctns_cd(XtX, b, w0, lam, tol, max_sweeps, loss_criterion=False):
    """Sequential-coordinate ridge CD in K-space (src/optimize.cpp:102-126).

    loss_criterion=True reproduces v1's stop rule: per-sweep objective
    decrease < tol, tracked as the sum of exact per-coordinate decrements
    (robust in f32; see ops/col_update.py docstring).
    """
    K = XtX.shape[0]
    diag = jnp.diagonal(XtX)

    def coord_body(k, carry):
        w, s, dec = carry
        u = b[k] - s[k] + w[k] * diag[k]
        w_new = u / (diag[k] + lam)
        delta = w_new - w[k]
        # exact ridge objective decrease for this coordinate update
        dec = dec + (0.5 * (diag[k] + lam) * delta * delta)
        s = s + XtX[:, k] * delta
        w = w.at[k].set(w_new)
        return w, s, dec

    def cond(carry):
        w, s, crit, sweeps = carry
        return (crit >= tol) & (sweeps < max_sweeps)

    def body(carry):
        w, s, _, sweeps = carry
        w_new, s_new, dec = lax.fori_loop(
            0, K, coord_body, (w, s, jnp.asarray(0.0, w.dtype))
        )
        crit = dec if loss_criterion else jnp.sum(jnp.abs(w_new - w))
        return w_new, s_new, crit, sweeps + 1

    s0 = jnp.matmul(XtX, w0, precision=HIGHEST)
    # Seed the criterion with +inf so at least one sweep runs (while(1)).
    w, _, _, _ = lax.while_loop(
        cond, body, (w0, s0, jnp.asarray(jnp.inf, w0.dtype), jnp.int32(0))
    )
    return w


def update_ctns_row_dense(
    resid_plus: jax.Array,
    F: jax.Array,
    gram: jax.Array,         # (K, K) = F F^T
    c: jax.Array,
    lam: float,
) -> jax.Array:
    """Dense (tuning==0) closed form, src/optimize.cpp:127-131."""
    K = F.shape[0]
    Xty = jnp.matmul(F, jnp.matmul(resid_plus.T, c, precision=HIGHEST),
                     precision=HIGHEST)
    A = jnp.dot(c, c, precision=HIGHEST) * gram + lam * jnp.eye(K, dtype=F.dtype)
    from insider_tpu.ops.linalg import spd_solve
    return spd_solve(A, Xty)


def update_ctns_row_dense_fast(
    dc: jax.Array,           # (M,) = c^T data   (per-problem constant)
    cc: jax.Array,           # scalar c^T c
    R_minus: jax.Array,      # (N, K)
    F: jax.Array,
    gram: jax.Array,
    c: jax.Array,
    lam,
) -> jax.Array:
    """Dense closed form with precomputed constants:
    resid_plus^T c = data^T c - (R_minus F)^T c."""
    K = F.shape[0]
    pc = jnp.matmul(jnp.matmul(c, R_minus, precision=HIGHEST), F,
                    precision=HIGHEST)                       # (M,)
    Xty = jnp.matmul(F, dc - pc, precision=HIGHEST)
    A = cc * gram + lam * jnp.eye(K, dtype=F.dtype)
    from insider_tpu.ops.linalg import spd_solve
    return spd_solve(A, Xty)
