"""Feature-sign column solve as a Pallas kernel on the Triton route.

One program solves the elastic-net subproblems of a block of BM gene
columns: the whole feature-sign outer loop (masked Gauss-Jordan solve, line
search to the first sign crossing, single-violator KKT activation) and the
plain-CD polish run inside the program, and a block stops as soon as its own
columns have converged.  The per-column grams and Xty come from XLA
(`col_gram_masked` and one `HIGHEST` matmul) and are read once per solve.

The iteration is `ops/fss.feature_sign_batched` followed by
`ops/col_update.elastic_net_cd(use_strong_rule=False)` step for step, with
the same coordinate orders (the caller passes the polish permutations), so
the two paths agree to f32 rounding.  K is padded to a power of two; padded
coordinates are inactive identity rows, exactly as `_masked_solve` decouples
inactive ones, and padded columns have zero grams and converge at once.

Tensors live in registers as (BM, KP, KP) blocks; a coordinate k is read
with a masked reduction (`where(iota == k, x, 0).sum(axis)`), which Triton
lowers without dynamic register indexing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Relative KKT slack: must equal ops/fss.feature_sign_batched's kkt_rtol.
KKT_RTOL = 1e-5

# One column per program and one warp: with (2, 1) the fastest of the
# (BM, warps) pairs timed on an H100 at the flagship width (PERF.md).
DEFAULT_BLOCK = 1
NUM_WARPS = 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pick(x, onehot, axis):
    """x[..., k, ...] for the coordinate selected by the boolean onehot."""
    return jnp.sum(jnp.where(onehot, x, 0.0), axis=axis)


def _fss_kernel(scal_ref, gram_ref, xty_ref, beta0_ref, perm_ref,
                out_ref, outer_ref, *, K: int, KP: int, M: int, BM: int,
                max_outer: int, polish_sweeps: int, shared: bool):
    pid = pl.program_id(0)
    cols = pid * BM + jnp.arange(BM, dtype=jnp.int32)          # (BM,)
    kk = jnp.arange(KP, dtype=jnp.int32)
    col_ok = cols < M
    k2 = kk[None, :]                                           # (1, KP)
    ok2 = col_ok[:, None] & (k2 < K)                           # (BM, KP)
    off2 = k2 * M + cols[:, None]
    i3 = kk[None, :, None]                                     # (1, KP, 1)
    j3 = kk[None, None, :]                                     # (1, 1, KP)
    ok3 = col_ok[:, None, None] & (i3 < K) & (j3 < K)
    off3 = jnp.broadcast_to(i3 * K + j3, (BM, KP, KP))
    if not shared:
        off3 = off3 + cols[:, None, None] * (K * K)

    lam = scal_ref[0]
    alpha = scal_ref[1]
    tol = scal_ref[2]
    l1 = lam * alpha
    l2 = lam * (1.0 - alpha)

    G = plgpu.load(gram_ref.at[off3], mask=ok3, other=0.0)     # (BM, KP, KP)
    b = plgpu.load(xty_ref.at[off2], mask=ok2, other=0.0)      # (BM, KP)
    beta = plgpu.load(beta0_ref.at[off2], mask=ok2, other=0.0)
    eye = (i3 == j3).astype(jnp.float32)

    def gram_dot(x):
        """(G + l2 I) x per column."""
        return jnp.sum((G + l2 * eye) * x[:, None, :], axis=2)

    # --- feature-sign outer loop (ops/fss.feature_sign_batched) ---
    def outer_cond(carry):
        outer, _, _, _, conv = carry
        return (outer < max_outer) & (jnp.min(conv) < 0.5)

    def outer_body(carry):
        outer, beta, theta, act, conv = carry
        rhs = (b - l1 * theta) * act
        U = ((G + l2 * eye) * act[:, :, None] * act[:, None, :]
             + eye * (1.0 - act)[:, :, None])

        def gj_step(k, ux):
            U, x = ux
            row = _pick(U, i3 == k, 1)                         # U[:, k, :]
            piv = _pick(row, k2 == k, 1)                       # (BM,)
            row = row / piv[:, None]
            xk = _pick(x, k2 == k, 1) / piv
            col = _pick(U, j3 == k, 2)                         # U[:, :, k]
            U = U - col[:, :, None] * row[:, None, :]
            x = x - col * xk[:, None]
            U = jnp.where(i3 == k, row[:, None, :], U)
            x = jnp.where(k2 == k, xk[:, None], x)
            return U, x

        _, beta_star = lax.fori_loop(0, K, gj_step, (U, rhs))

        # line search to the first sign crossing; just-activated
        # coordinates (beta == 0) are exempt on their first solve
        flip = ((act > 0.5) & (jnp.sign(beta_star) != theta)
                & (beta != 0.0))
        denom = beta - beta_star
        safe = jnp.where(flip & (denom != 0.0), denom, 1.0)
        t_k = jnp.clip(jnp.where(flip, beta / safe, 1.0), 0.0, 1.0)
        t = jnp.min(t_k, axis=1)                               # (BM,)
        live = conv < 0.5
        move = live[:, None] & (act > 0.5)
        beta_new = jnp.where(move, beta + t[:, None] * (beta_star - beta),
                             beta)
        crossed = (flip & (t_k <= t[:, None]) & (t[:, None] < 1.0)
                   & live[:, None])
        beta_new = jnp.where(crossed, 0.0, beta_new)
        act_new = (act > 0.5) & (~crossed) & (beta_new != 0.0)
        theta_new = jnp.where(act_new, jnp.sign(beta_new), 0.0)

        # single-violator KKT activation on columns whose active set solved
        solved = (t >= 1.0) & live
        grad = gram_dot(beta_new) - b
        scale = jnp.max(jnp.abs(b), axis=1)
        thresh = l1 + KKT_RTOL * (l1 + scale)
        viol = (~act_new) & (jnp.abs(grad) > thresh[:, None]) & solved[:, None]
        score = jnp.where(viol, jnp.abs(grad), -1.0)
        best = jnp.max(score, axis=1)
        has_viol = best > 0.0
        first = jnp.min(jnp.where(viol & (score >= best[:, None]), k2, KP),
                        axis=1)
        pick = (k2 == first[:, None]) & has_viol[:, None]
        act_new = act_new | pick
        theta_new = jnp.where(pick, -jnp.sign(grad), theta_new)
        conv = jnp.where(solved & (~has_viol), 1.0, conv)
        return (outer + 1, beta_new, theta_new, act_new.astype(jnp.float32),
                conv)

    init = (jnp.int32(0), beta, jnp.sign(beta),
            (beta != 0.0).astype(jnp.float32), jnp.zeros((BM,), jnp.float32))
    outer, beta, _, _, _ = lax.while_loop(outer_cond, outer_body, init)

    # --- plain-CD polish (ops/col_update.elastic_net_cd, no screening) ---
    if polish_sweeps > 0:
        diag = _pick(G, i3 == j3, 2)                           # (BM, KP)
        s = jnp.sum(G * beta[:, None, :], axis=2)
        l1_safe = jnp.maximum(l1, 1e-30)

        def coord(i, carry):
            beta, s, dec, conv, sweep = carry
            k = perm_ref[sweep * K + i]
            onek = k2 == k
            d_k = _pick(diag, onek, 1)
            b_k = _pick(beta, onek, 1)
            u = _pick(b, onek, 1) - _pick(s, onek, 1) + b_k * d_k
            denom = jnp.where(d_k + l2 > 0.0, d_k + l2, 1.0)
            w = jnp.sign(u) * jnp.maximum(jnp.abs(u) - l1, 0.0) / denom
            w = jnp.where(conv > 0.5, b_k, w)
            delta = w - b_k
            xi = jnp.where(w != 0.0, jnp.sign(w),
                           jnp.clip(u / l1_safe, -1.0, 1.0))
            dec = dec + (0.5 * denom * delta * delta
                         + l1 * (jnp.abs(b_k) - xi * b_k))
            s = s + _pick(G, j3 == k, 2) * delta[:, None]
            beta = jnp.where(onek, w[:, None], beta)
            return beta, s, dec, conv, sweep

        def sweep_cond(carry):
            _, _, conv, sweep = carry
            return (sweep < polish_sweeps) & (jnp.min(conv) < 0.5)

        def sweep_body(carry):
            beta, s, conv, sweep = carry
            beta, s, dec, _, _ = lax.fori_loop(
                0, K, coord,
                (beta, s, jnp.zeros((BM,), jnp.float32), conv, sweep))
            conv = jnp.where(jnp.abs(dec) <= tol, 1.0, conv)
            return beta, s, conv, sweep + 1

        beta, _, _, _ = lax.while_loop(
            sweep_cond, sweep_body,
            (beta, s, jnp.zeros((BM,), jnp.float32), jnp.int32(0)))

    plgpu.store(out_ref.at[off2], beta, mask=ok2)
    outer_ref[pid] = outer


@functools.partial(
    jax.jit,
    static_argnames=("max_outer", "polish_sweeps", "block", "interpret"))
def feature_sign_triton(gram, xty, beta0, lam, alpha, tol, perms, *,
                        max_outer: int = 48, polish_sweeps: int = 0,
                        block: int = DEFAULT_BLOCK,
                        interpret: bool = False):
    """Feature-sign solve (+ optional plain-CD polish) of every column.

    gram: (M, K, K) per-column grams, or one (K, K) gram shared by every
    column (the dense path).  xty, beta0: (K, M).  perms: (polish_sweeps, K)
    int32 coordinate orders of the polish sweeps (`make_sweep_perms`).
    Requires alpha > 0.  Returns (beta (K, M), outer steps of the slowest
    block).
    """
    K, M = xty.shape
    shared = gram.ndim == 2
    BM = block
    KP = _next_pow2(K)
    n_blocks = pl.cdiv(M, BM)
    scal = jnp.stack([jnp.asarray(lam, jnp.float32),
                      jnp.asarray(alpha, jnp.float32),
                      jnp.asarray(tol, jnp.float32),
                      jnp.float32(0.0)])
    if polish_sweeps == 0:
        perms = jnp.zeros((1, K), jnp.int32)
    kernel = functools.partial(
        _fss_kernel, K=K, KP=KP, M=M, BM=BM, max_outer=max_outer,
        polish_sweeps=polish_sweeps, shared=shared)
    beta, outers = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        out_shape=(jax.ShapeDtypeStruct((K * M,), jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks,), jnp.int32)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="fss_solve",
    )(scal, gram.astype(jnp.float32).reshape(-1),
      xty.astype(jnp.float32).reshape(-1),
      beta0.astype(jnp.float32).reshape(-1),
      perms.astype(jnp.int32).reshape(-1))
    return beta.reshape(K, M), jnp.max(outers)
