"""Small-K batched linear algebra.

The normal-equation solves in INSIDER are K x K with K ~ 3..50, batched over
up to ~1e5 systems (levels or gene columns).  Instead of LAPACK-style
cholesky/triangular_solve custom calls, which are built for big single
matrices, we use an unrolled, fully vectorized Gauss-Jordan elimination: K
rank-1 sweeps of elementwise ops over the whole batch, which XLA fuses into a
handful of elementwise kernels.  No pivoting — every system here is SPD with a ridge
term on the diagonal (src/optimize.cpp:174: XtX.diag() += lambda), so the
pivots are bounded below by lambda.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gauss_jordan_solve(A: jax.Array, B: jax.Array) -> jax.Array:
    """Solve A X = B for SPD A.  A: (..., K, K), B: (..., K, R) -> (..., K, R).

    Unrolled Gauss-Jordan; K must be static (it always is — the latent dim).
    """
    K = A.shape[-1]
    M = jnp.concatenate([A, B], axis=-1)
    for k in range(K):
        piv = M[..., k, k:k + 1]                       # (..., 1)
        row = M[..., k, :] / piv                       # (..., K+R)
        col = M[..., :, k:k + 1]                       # (..., K, 1)
        M = M - col * row[..., None, :]
        M = M.at[..., k, :].set(row)
    return M[..., :, K:]


def spd_solve(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b.  A: (..., K, K), b: (..., K) -> (..., K)."""
    return gauss_jordan_solve(A, b[..., None])[..., 0]


def spd_inverse(A: jax.Array) -> jax.Array:
    """Batched SPD inverse via Gauss-Jordan with B = I."""
    K = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(K, dtype=A.dtype), A.shape)
    return gauss_jordan_solve(A, eye)
