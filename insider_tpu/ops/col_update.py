"""Column-side elastic-net updates: the hot path.

Equivalent of `optimize_col` (src/optimize.cpp:200-253) +
`strong_coordinate_descent` / `coordinate_descent`
(src/coordinate_descent.cpp:11-127).

Redesign (SURVEY.md §7): the reference runs scalar cyclic CD inside each gene
column, parallelizing columns over OpenMP threads.  Here one CD sweep updates
coordinate k of *all M columns simultaneously* — the state lives entirely in
(K, M) space (beta, Xty, s = XtX@beta), so the N-dimensional residual never
enters the inner loop.  Per-column semantics (cyclic order, soft-threshold
update, strong-rule screening, per-column convergence freezing, KKT
reactivation) are preserved exactly.

Convergence accounting: the reference stops a column when the loss decrease of
a full sweep falls below `tol` (coordinate_descent.cpp:112-114), with tol
decayed down to ~1e-11 (src/optimize.cpp:376,389-403).  Computing that as a
difference of two O(1e3) losses is impossible in f32; even the direct
per-coordinate decrement

    -delta_f_k = -(1/2 (d+l2)(w^2 - o^2) - u (w - o) + l1 (|w| - |o|))

has a u*(w-o) cancellation whose f32 rounding floor (~eps*|u|*|w|) can sit
ABOVE tol, leaving straggler columns sweeping forever.  We instead use the
optimality identity: the soft-threshold update satisfies u - (d+l2) w =
l1*xi, xi in the subdifferential of |w|, which turns the decrement into a sum
of two NONNEGATIVE terms

    -delta_f_k = 1/2 (d+l2) (w - o)^2 + l1 (|o| - xi*o),
    xi = sign(w) if w != 0 else u/l1 (in [-1, 1])

identical in exact arithmetic and computable to full relative precision in
f32 (the quadratic term's noise floor is ~eps^2).  Summed over a sweep it
equals the sweep's loss decrease exactly.  This is the one deliberate
deviation from the reference's arithmetic — same math, robust numerics.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def col_gram_masked(R: jax.Array, mask: jax.Array) -> jax.Array:
    """Per-column masked Grams XtX_j = R^T diag(mask_j) R  ->  (M, K, K).

    One (M,N)@(N,K^2) matmul against the row-factor outer-product table —
    the batched replacement for the reference's per-row rank-1 slice cube
    (src/optimize.cpp:207-219).
    """
    N, K = R.shape
    PR = (R[:, :, None] * R[:, None, :]).reshape(N, K * K)
    XtX = jnp.matmul(mask.T, PR, precision=HIGHEST)
    return XtX.reshape(-1, K, K)


def make_sweep_perms(key: jax.Array, K: int, max_sweeps: int) -> jax.Array:
    """Pre-generate per-sweep coordinate orders, shared across columns (the
    distributional analog of the per-column randperm at
    coordinate_descent.cpp:89; a single permutation per sweep keeps the
    update vectorized and deterministic under the key).  Shared by the jnp
    and Pallas paths so they compute the identical iteration."""
    keys = jax.random.split(key, max_sweeps)
    return jax.vmap(lambda k: jax.random.permutation(k, K))(keys).astype(jnp.int32)


class CDState(NamedTuple):
    beta: jax.Array        # (K, M) coefficients
    s: jax.Array           # (K, M) XtX @ beta, maintained incrementally
    active: jax.Array      # (K, M) bool strong-rule / KKT active set
    converged: jax.Array   # (M,) bool per-column freeze flags
    sweeps: jax.Array      # scalar int32, total sweeps executed


def _sweep(XtX, diag, Xty, lam, alpha, perm, state: CDState):
    """One full cyclic CD sweep over all K coordinates, all M columns.

    XtX: (M, K, K) per-column Grams, or (1, K, K) broadcast (dense path).
    Returns (new_state_fields, sweep_decrease (M,)).
    """
    K, M = state.beta.shape
    l1 = lam * alpha
    l2 = lam * (1.0 - alpha)

    def coord_body(i, carry):
        beta, s, decrease = carry
        k = perm[i]
        d_k = diag[k]                                   # (M,)
        u = Xty[k] - s[k] + beta[k] * d_k               # (M,)
        denom = jnp.where(d_k + l2 > 0.0, d_k + l2, 1.0)
        w = jnp.sign(u) * jnp.maximum(jnp.abs(u) - l1, 0.0) / denom
        # Frozen columns and screened-out coordinates don't move
        # (coordinate_descent.cpp:74-75; per-column do-while exit).
        upd = state.active[k] & (~state.converged)
        w = jnp.where(upd, w, beta[k])
        delta = w - beta[k]
        # Exact per-coordinate objective decrease, cancellation-free form
        # (see module docstring): both terms nonnegative, full relative
        # precision in f32.
        xi = jnp.where(
            w != 0.0, jnp.sign(w),
            jnp.clip(u / jnp.maximum(l1, 1e-30), -1.0, 1.0),
        )
        dec_k = 0.5 * denom * delta * delta + l1 * (
            jnp.abs(beta[k]) - xi * beta[k]
        )
        # s += XtX[:, :, k] * delta  (rank-1 maintenance,
        # coordinate_descent.cpp:107, vectorized across columns).
        col_k = jnp.take(XtX, k, axis=2)                # (M or 1, K)
        s = s + col_k.T * delta[None, :]
        beta = beta.at[k].set(w)
        return beta, s, decrease + dec_k

    beta, s, decrease = lax.fori_loop(
        0, K, coord_body, (state.beta, state.s, jnp.zeros(M, state.beta.dtype))
    )
    return beta, s, decrease


def _kkt_violations(s, Xty, active, lam, alpha):
    """|XtX[ex,inc] beta[inc] - Xty[ex]| > alpha*lam on inactive coords.

    With beta zero on inactive coords, s = XtX@beta restricted to them is
    exactly the reference's `grad` (coordinate_descent.cpp:118).
    """
    grad = s - Xty
    return (~active) & (jnp.abs(grad) > alpha * lam)


@partial(jax.jit, static_argnames=("max_sweeps", "use_strong_rule"))
def elastic_net_cd(
    XtX: jax.Array,          # (M, K, K) or (1, K, K)
    Xty: jax.Array,          # (K, M)
    beta0: jax.Array,        # (K, M) warm start (previous column factor)
    lam: float,
    alpha: float,
    tol: jax.Array,          # scalar (sub_tol * decay), traced
    key: jax.Array,
    max_sweeps: int = 200,
    use_strong_rule: bool = True,
):
    """Vectorized strong-rule CD with KKT reactivation over all columns.

    Returns (beta, key, sweeps_used).
    """
    K, M = beta0.shape
    key, sub = jax.random.split(key)
    perms = make_sweep_perms(sub, K, max_sweeps)
    diag = jnp.diagonal(XtX, axis1=1, axis2=2).T        # (K, M or 1) -> broadcast
    if diag.shape[1] == 1 and M != 1:
        diag = jnp.broadcast_to(diag, (K, M))

    if use_strong_rule:
        # Strong screening (coordinate_descent.cpp:74-75): drop coords with
        # |Xty| < alpha*(2*lam - max_k |Xty|); zero their warm start.
        thr = alpha * (2.0 * lam - jnp.max(jnp.abs(Xty), axis=0))  # (M,)
        active = jnp.abs(Xty) >= thr[None, :]
        beta = jnp.where(active, beta0, 0.0)
    else:
        active = jnp.ones((K, M), bool)
        beta = beta0

    s = jnp.einsum("mkl,lm->km", XtX, beta, precision=HIGHEST)
    state = CDState(
        beta=beta,
        s=s,
        active=active,
        converged=jnp.zeros(M, bool),
        sweeps=jnp.int32(0),
    )

    def cond(st: CDState):
        return (~jnp.all(st.converged)) & (st.sweeps < max_sweeps)

    def body(st: CDState):
        beta, s, decrease = _sweep(XtX, diag, Xty, lam, alpha,
                                   perms[st.sweeps], st)
        # do-while semantics: a column may stop only after this sweep ran on it.
        candidate = (~st.converged) & (jnp.abs(decrease) <= tol)
        if use_strong_rule:
            viol = _kkt_violations(s, Xty, st.active, lam, alpha)  # (K, M)
            has_viol = jnp.any(viol, axis=0)                        # (M,)
            # Columns whose inner loop just converged: reactivate violators and
            # keep sweeping them; converge only if KKT-clean
            # (coordinate_descent.cpp:118-124).
            activate = viol & candidate[None, :]
            active = st.active | activate
            converged = st.converged | (candidate & (~has_viol))
        else:
            active = st.active
            converged = st.converged | candidate
        return CDState(beta, s, active, converged, st.sweeps + 1)

    out = lax.while_loop(cond, body, state)
    return out.beta, key, out.sweeps


def _fss_kernel_solve(mesh, XtX, Xty, F_prev, lam, alpha, tol, key,
                      max_outer, polish_sweeps):
    """The Triton feature-sign kernel (kernels/fss_triton.py), with the
    polish's coordinate orders drawn exactly as elastic_net_cd draws them.

    On a mesh the kernel runs under shard_map over 'cols' (a Pallas call is
    not GSPMD-partitionable); the mesh divides M evenly
    (sharding/mesh.check_divisible)."""
    from insider_tpu.kernels.fss_triton import feature_sign_triton

    K = Xty.shape[0]
    perms = jnp.zeros((1, K), jnp.int32)
    if polish_sweeps:
        key, sub = jax.random.split(key)
        perms = make_sweep_perms(sub, K, polish_sweeps)

    def solve(g, xy, b0, lam, alpha, tol, perms):
        return feature_sign_triton(g, xy, b0, lam, alpha, tol, perms,
                                   max_outer=max_outer,
                                   polish_sweeps=polish_sweeps)

    if mesh is None:
        F, outers = solve(XtX, Xty, F_prev, lam, alpha, tol, perms)
        return F, key, outers
    from jax.sharding import PartitionSpec as P

    def local(*args):
        F, outers = solve(*args)
        return F, lax.pmax(outers, "cols")

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P() if XtX.ndim == 2 else P("cols"), P(None, "cols"),
                  P(None, "cols"), P(), P(), P(), P()),
        out_specs=(P(None, "cols"), P()),
        check_vma=False,
    )
    F, outers = sharded(XtX, Xty, F_prev, jnp.asarray(lam, jnp.float32),
                        jnp.asarray(alpha, jnp.float32),
                        jnp.asarray(tol, jnp.float32), perms)
    return F, key, outers


def _fss_solve(XtX, Xty, F_prev, lam, alpha, tol, key, *, use_pallas, mesh,
               max_fss_outer, fss_polish, max_fss_polish_sweeps):
    """Feature-sign solve plus plain-CD polish, on the kernel or in XLA.

    XtX is (M, K, K) per column or one (K, K) gram shared by every column
    (dense path)."""
    polish = max_fss_polish_sweeps if fss_polish else 0
    if use_pallas:
        return _fss_kernel_solve(mesh, XtX, Xty, F_prev, lam, alpha, tol,
                                 key, max_fss_outer, polish)
    from insider_tpu.ops.fss import feature_sign_batched

    XtX3 = XtX[None] if XtX.ndim == 2 else XtX
    F, outers = feature_sign_batched(XtX3, Xty, F_prev, lam, alpha,
                                     max_fss_outer)
    if polish:
        F, key, _ = elastic_net_cd(XtX3, Xty, F, lam, alpha, tol, key,
                                   max_sweeps=polish, use_strong_rule=False)
    return F, key, outers


def update_columns_masked(
    data: jax.Array,        # (N, M) — NOTE: the driver passes data, not the
                            # residual (src/optimize.cpp:376); the column solve
                            # regresses data onto the full row factor.
    mask: jax.Array,        # (N, M) 0/1 train indicator
    R: jax.Array,           # (N, K) row factor
    F_prev: jax.Array,      # (K, M) warm start
    lam: float,
    alpha: float,
    tol: jax.Array,
    key: jax.Array,
    max_sweeps: int = 200,
    alpha_is_zero: bool = None,
    use_pallas: bool = False,        # the Triton FSS kernel (GPU only)
    mesh=None,                       # shard the kernel over mesh axis 'cols'
    solver: str = "cd",              # "cd" | "fss" (alpha > 0 only)
    max_fss_outer: int = 48,
    fss_polish: bool = True,
    max_fss_polish_sweeps: int = 32,
    cd_warm_start: bool = True,
):
    """Masked (tuning==1) column update, src/optimize.cpp:203-230.

    mask may be stored uint8 (memory-lean); it is widened to the compute
    dtype where a matmul reads it.  Returns (F, key, outer steps or sweeps).
    """
    if alpha_is_zero is None:
        alpha_is_zero = alpha == 0.0
    mask_f = mask if mask.dtype == R.dtype else mask.astype(R.dtype)
    Xty = jnp.matmul(R.T, mask_f * data, precision=HIGHEST)  # (K, M)
    XtX = col_gram_masked(R, mask_f)                       # (M, K, K)
    if alpha_is_zero:
        from insider_tpu.ops.row_update import _ridge_solve_batched
        F = _ridge_solve_batched(XtX, Xty.T, lam).T
        return F, key, jnp.int32(0)
    if solver == "cd" and cd_warm_start:
        # FSS-warm-started CD (FitConfig.cd_warm_start): solve the sign
        # pattern exactly with FSS, then plain-CD sweeps (all coordinates
        # active, no screening needed) until the reference's per-column
        # stopping criterion fires at `tol` (coordinate_descent.cpp:112-114).
        # Same unique optimum and stopping contract as cold CD.
        solver, fss_polish, max_fss_polish_sweeps = "fss", True, max_sweeps
    if solver == "fss":
        return _fss_solve(XtX, Xty, F_prev, lam, alpha, tol, key,
                          use_pallas=use_pallas, mesh=mesh,
                          max_fss_outer=max_fss_outer, fss_polish=fss_polish,
                          max_fss_polish_sweeps=max_fss_polish_sweeps)
    return elastic_net_cd(XtX, Xty, F_prev, lam, alpha, tol, key, max_sweeps)


def update_columns_dense(
    data: jax.Array,
    R: jax.Array,
    F_prev: jax.Array,
    lam: float,
    alpha: float,
    tol: jax.Array,
    key: jax.Array,
    max_sweeps: int = 200,
    alpha_is_zero: bool = None,
    use_pallas: bool = False,
    mesh=None,
    solver: str = "cd",
    max_fss_outer: int = 48,
    fss_polish: bool = True,
    max_fss_polish_sweeps: int = 32,
    cd_warm_start: bool = True,
):
    """Dense (tuning==0) column update, src/optimize.cpp:232-247."""
    if alpha_is_zero is None:
        alpha_is_zero = alpha == 0.0
    K = R.shape[1]
    XtX = jnp.matmul(R.T, R, precision=HIGHEST)         # (K, K) shared
    Xty = jnp.matmul(R.T, data, precision=HIGHEST)      # (K, M)
    if alpha_is_zero:
        from insider_tpu.ops.linalg import gauss_jordan_solve
        A = XtX + lam * jnp.eye(K, dtype=R.dtype)
        F = gauss_jordan_solve(A, Xty)
        return F, key, jnp.int32(0)
    if solver == "cd" and cd_warm_start:
        # FSS-warm-started CD — see update_columns_masked.
        solver, fss_polish, max_fss_polish_sweeps = "fss", True, max_sweeps
    if solver == "fss":
        return _fss_solve(XtX, Xty, F_prev, lam, alpha, tol, key,
                          use_pallas=use_pallas, mesh=mesh,
                          max_fss_outer=max_fss_outer, fss_polish=fss_polish,
                          max_fss_polish_sweeps=max_fss_polish_sweeps)
    return elastic_net_cd(XtX[None], Xty, F_prev, lam, alpha, tol, key,
                          max_sweeps)
