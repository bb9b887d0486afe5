"""Post-fit GLM interaction inference.

Equivalent of `glm_interaction` (R/glm_interaction.R:2-30): for
each interaction level, regress the stacked residual rows of that level's
samples on the gene factor F^T (no intercept, gaussian family) and report
coefficients and p-values.

The reference materializes an (n_ids*M, K) design and calls R `glm` per
level.  Because the design is F^T repeated n_ids times, the normal equations
collapse to closed form and every level solves at once, batched:

    XtX_l = n_l * F F^T          Xty_l = F @ (sum of level-l residual rows)
    beta_l = XtX_l^{-1} Xty_l
    RSS_l  = sum ||rows||^2 - 2 beta^T Xty + beta^T XtX beta
    t_kl   = beta_kl / sqrt(sigma2_l * (XtX_l^{-1})_kk),  dof_l = n_l*M - K

p-values use the Student-t distribution via the regularized incomplete beta —
identical to what summary.glm reports for a gaussian family with estimated
dispersion (R/glm_interaction.R:27).

Like the reference, the `train_indicator` and `n_cores` arguments are
accepted but unused (the R body never touches them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def _student_t_sf(t_abs, dof):
    """P(T > t) for T ~ Student-t(dof), via regularized incomplete beta."""
    x = dof / (dof + t_abs * t_abs)
    return 0.5 * jax.scipy.special.betainc(dof / 2.0, 0.5, x)


@jax.jit
def _glm_batched(residual, codes, n_levels_arr, F):
    # residual (N, M), codes (N,), F (K, M)
    n_levels = n_levels_arr.shape[0]
    K, M = F.shape
    gram = jnp.matmul(F, F.T, precision=HIGHEST)                   # (K, K)
    counts = jax.ops.segment_sum(jnp.ones_like(codes, F.dtype), codes,
                                 num_segments=n_levels)            # (L,)
    S = jax.ops.segment_sum(residual, codes, num_segments=n_levels)  # (L, M)
    yty = jax.ops.segment_sum(jnp.sum(residual * residual, axis=1), codes,
                              num_segments=n_levels)               # (L,)
    Xty = jnp.matmul(S, F.T, precision=HIGHEST)                    # (L, K)

    from insider_tpu.ops.linalg import spd_inverse

    XtX = counts[:, None, None] * gram                             # (L, K, K)
    XtX_inv = spd_inverse(XtX)
    beta = jnp.einsum("lkj,lj->lk", XtX_inv, Xty, precision=HIGHEST)

    rss = yty - 2.0 * jnp.sum(beta * Xty, axis=1) + jnp.einsum(
        "lk,lkj,lj->l", beta, XtX, beta, precision=HIGHEST
    )
    dof = counts * M - K
    sigma2 = rss / jnp.maximum(dof, 1.0)
    se = jnp.sqrt(sigma2[:, None] *
                  jnp.diagonal(XtX_inv, axis1=1, axis2=2))
    t = beta / se
    pval = 2.0 * _student_t_sf(jnp.abs(t), dof[:, None])
    return beta, pval


def glm_interaction(
    residual: np.ndarray,
    train_indicator: Optional[np.ndarray],
    interaction_indicator: np.ndarray,
    column_factor: np.ndarray,
    tol: float = 1e-10,
    n_cores: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (coeff_matrix, pval_matrix), each (n_levels, K)."""
    del train_indicator, tol, n_cores  # unused, as in the reference
    codes_raw = np.asarray(interaction_indicator).ravel()
    levels, inv = np.unique(codes_raw, return_inverse=True)
    beta, pval = _glm_batched(
        jnp.asarray(residual, jnp.float32),
        jnp.asarray(inv, jnp.int32),
        jnp.zeros(levels.size),
        jnp.asarray(column_factor, jnp.float32),
    )
    return np.asarray(beta), np.asarray(pval)
