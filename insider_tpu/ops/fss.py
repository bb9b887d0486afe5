"""Batched feature-sign search: exact active-set solver for the per-column
elastic net.

Why a second solver: coordinate descent (ops/col_update.py, the reference's
strong_coordinate_descent) converges *linearly* with rate set by the Gram
conditioning; on the flagship workload the median column needs many sweeps
to reach sub_tol, and every sweep is a full pass over (K, M) state.
Feature-sign search (Lee, Battle,
Raina & Ng 2006) instead solves the sign-fixed quadratic subproblem EXACTLY
with one batched K x K solve per outer step and only iterates on the
(finite) sign pattern; from an ALS warm start the sign pattern is already
almost correct, so a handful of outer steps replaces ~150 sweeps.

The reference ships its own R prototype of exactly this algorithm
(`feature_sign_with_screening`, R/optimization_functions.R:136-238) as an
alternative to CD — this is its batched form, vectorized over all
M gene columns with per-column active-set masks and convergence freezing.

Per column j, minimizing (coordinate_descent.cpp objective)
    f(b) = 1/2 b^T XtX_j b - Xty_j^T b + l2/2 ||b||^2 + l1 ||b||_1,
    A = XtX_j + l2 I  (SPD: l2 = lam*(1-alpha) plus masked-Gram diagonal)

outer step:
  1. solve  A[act, act] b* = (Xty - l1*theta)[act]  for the active set with
     fixed signs theta (batched masked Gauss-Jordan, ops/linalg.py);
  2. line search toward b*: the sign-fixed objective is convex and minimized
     at b*, so it decreases monotonically along the segment until the first
     sign crossing; step to min crossing t*, zero & deactivate the crossing
     coordinates (exact zeros — this is where lasso sparsity comes from);
  3. if no crossing (t* = 1): the active subproblem is solved exactly; check
     KKT on inactive coordinates, |(A b - Xty)_k| <= l1
     (coordinate_descent.cpp:118-124's condition), activate all violators
     with theta = -sign(grad); converged when none.

Each step strictly decreases f, sign patterns are finite, so termination is
finite; `max_outer` is a jit-safety cap.  Unlike CD-with-tol this returns the
EXACT subproblem optimum (up to f32 solves) — at least as converged as any
sub_tol the reference would use, so the ALS-level convergence protocol is
preserved or improved.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from insider_tpu.ops.linalg import gauss_jordan_solve

HIGHEST = lax.Precision.HIGHEST


class FSSState(NamedTuple):
    beta: jax.Array        # (K, M)
    theta: jax.Array       # (K, M) signs in {-1, 0, +1}
    active: jax.Array      # (K, M) bool
    converged: jax.Array   # (M,) bool
    outer: jax.Array       # scalar int32


def _masked_solve(A, active_t, rhs_t):
    """Solve per-column systems restricted to active coordinates.

    A: (M or 1, K, K); active_t/rhs_t: (M, K).  Inactive rows/cols are
    replaced by identity with zero rhs, which decouples them exactly.
    """
    K = A.shape[-1]
    act = active_t.astype(A.dtype)
    U = A * act[:, :, None] * act[:, None, :]
    U = U + jnp.eye(K, dtype=A.dtype) * (1.0 - act)[:, :, None]
    return gauss_jordan_solve(U, (rhs_t * act)[:, :, None])[:, :, 0]


@partial(jax.jit, static_argnames=("max_outer",))
def feature_sign_batched(
    XtX: jax.Array,       # (M, K, K) or (1, K, K) shared
    Xty: jax.Array,       # (K, M)
    beta0: jax.Array,     # (K, M) warm start
    lam,
    alpha,
    max_outer: int = 64,
    kkt_rtol: float = 1e-5,
):
    """Exact batched elastic-net solve over all columns.

    Returns (beta, outer_steps_used).  Requires alpha > 0 (the l1 = 0 case is
    a plain ridge solve — dispatched separately by the caller).

    kkt_rtol: relative slack on the |grad| <= l1 optimality check.  The
    reference compares strictly in f64 (coordinate_descent.cpp:119); in f32
    the computed grad carries ~eps * column-scale noise, and a coordinate
    sitting exactly on the boundary would oscillate activate/deactivate
    forever.  The slack is scaled by the column's gradient magnitude, so it
    admits only coordinates whose true |beta| would be below f32 resolution
    anyway.  Default 1e-5 (must match kernels/fss_triton.KKT_RTOL): tight
    enough that boundary coordinates activate and solve EXACTLY in the GJ
    step rather than leaving slow CD-descent work to the polish, loose
    enough to absorb the f32 gradient noise floor.
    """
    K, M = beta0.shape
    lam = jnp.asarray(lam, beta0.dtype)
    alpha = jnp.asarray(alpha, beta0.dtype)
    l1 = lam * alpha
    l2 = lam * (1.0 - alpha)

    A = XtX + l2 * jnp.eye(K, dtype=beta0.dtype)
    if A.shape[0] == 1 and M != 1:
        A = jnp.broadcast_to(A, (M, K, K))
    b = Xty

    beta = beta0
    theta = jnp.sign(beta)
    active = beta != 0.0
    # (Bulk warm-start activation — activating every KKT violator of the
    # warm start at step 0 — makes joint sign guesses that destabilize the
    # line search; single-violator activation stays.)
    state = FSSState(beta, theta, active,
                     jnp.zeros(M, bool), jnp.int32(0))

    def cond(st: FSSState):
        return (~jnp.all(st.converged)) & (st.outer < max_outer)

    def body(st: FSSState):
        rhs = b - l1 * st.theta                                  # (K, M)
        beta_star = _masked_solve(A, st.active.T, rhs.T).T       # (K, M)

        # --- line search to the first sign crossing ---
        # Just-activated coordinates (active with beta exactly 0 — only the
        # KKT pick below creates that combination) are exempt from the flip
        # set: they sit AT zero, so a guessed-sign mismatch in the solve
        # would give a crossing time t_k = 0, forcing a zero step that
        # deactivates them again — a deterministic livelock re-picking the
        # same violator every outer step.  Classical FSS likewise lets the
        # fresh coordinate move on its first solve; theta is re-derived from
        # the realized sign afterwards.
        flip = st.active & (jnp.sign(beta_star) != st.theta) & (st.beta != 0.0)
        denom = st.beta - beta_star
        safe = jnp.where(flip & (denom != 0.0), denom, 1.0)
        t_k = jnp.where(flip, st.beta / safe, 1.0)               # (K, M)
        t_k = jnp.clip(t_k, 0.0, 1.0)
        t = jnp.min(t_k, axis=0)                                 # (M,)

        move = (~st.converged)[None, :] & st.active
        beta_new = jnp.where(
            move, st.beta + t[None, :] * (beta_star - st.beta), st.beta
        )
        # Coordinates that crossed at t: exact zero, deactivate.  Frozen
        # (converged) columns are excluded — their beta did not move, so a
        # near-zero active coordinate must not be re-zeroed (matches the
        # kernel's `live` guard, kernels/fss_triton.py).
        crossed = (flip & (t_k <= t[None, :]) & (t[None, :] < 1.0)
                   & (~st.converged)[None, :])
        beta_new = jnp.where(crossed, 0.0, beta_new)
        active_new = st.active & (~crossed) & (beta_new != 0.0)
        theta_new = jnp.where(active_new, jnp.sign(beta_new), 0.0)

        # --- KKT activation for columns whose active subproblem is solved ---
        # Activate ONE violator per column per step (the canonical rule):
        # activating all violators at once guesses many signs jointly and
        # cycles (validated: ~98% failure on ill-conditioned Grams vs 0% for
        # single-violator; from an ALS warm start 1-7 steps suffice).
        solved = (t >= 1.0) & (~st.converged)                    # (M,)
        grad = (jnp.einsum("mkl,lm->km", A, beta_new,
                           precision=HIGHEST) - b)               # (K, M)
        # grad = A beta - b suffers cancellation at the optimum, so its f32
        # noise scales with |b| (and the solve's kappa-amplified error), not
        # with |grad| itself.
        scale = jnp.max(jnp.abs(b), axis=0, keepdims=True)       # (1, M)
        thresh = l1 + kkt_rtol * (l1 + scale)
        viol = (~active_new) & (jnp.abs(grad) > thresh) & solved[None, :]
        has_viol = jnp.any(viol, axis=0)
        score = jnp.where(viol, jnp.abs(grad), -1.0)
        worst = jnp.argmax(score, axis=0)                        # (M,)
        pick = (jax.nn.one_hot(worst, K, dtype=bool, axis=0)
                & has_viol[None, :])
        active_new = active_new | pick
        theta_new = jnp.where(pick, -jnp.sign(grad), theta_new)
        converged = st.converged | (solved & (~has_viol))

        return FSSState(beta_new, theta_new, active_new, converged,
                        st.outer + 1)

    out = lax.while_loop(cond, body, state)
    return out.beta, out.outer
