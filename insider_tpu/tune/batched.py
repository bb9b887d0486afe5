"""Device-batched hyperparameter trials.

The reference runs each (lambda, alpha) grid point as a separate serial
optimize call (R/insider.R:147-173).  Here the whole stage-2 grid for one
rank is a single vmapped program: trial states stack on a leading axis,
(lambda1, lambda2, alpha) become per-trial vectors, and every XLA op
processes all trials at once — G-fold batching that turns the
dispatch-latency-bound small ops of one trial into full-width work
(SURVEY.md §2d, hyperparameter-grid row).

Semantics per trial match the serial path: fresh N(0, 0.001^2) init with the
trial's own seed, the reference convergence protocol with a per-trial
sub_tol decay ladder, test-RMSE reported from the final state.  One
deviation: trials that satisfy the stopping rule before `tuning_iter` keep
iterating (their factors stay at the fixed point) instead of freezing — the
batch stops when all trials converge or the budget is reached.

Uses the jnp solver paths (not the Triton column-solve kernel).  The
column sub-solver is the caller's explicit choice (`col_solver`, default
"auto" = fss+polish, matching FitConfig); tests/test_batched_tune.py
asserts batched-vs-serial agreement per solver.

vmap materializes G copies of every (N, M)-scale intermediate, so at large
shapes the batch is bound by memory traffic; its regime is many SMALL
trials, whose single-trial ops are bound by dispatch latency.  Whether it
beats serial trials on the GPU is not measured yet.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from insider_tpu.config import FitConfig, decay_from_delta_loss
from insider_tpu.model.state import InsiderState, init_state
from insider_tpu.ops import losses
from insider_tpu.train import als


def _stack_states(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def pad_state_rank(state: InsiderState, k_max: int) -> InsiderState:
    """Zero-pad a rank-r state to latent dimension k_max.

    Padded coordinates are exact fixed points of every ALS update, so the
    padded trial computes the rank-r trajectory exactly:
      * row side — XtX has zero rows/columns at padded coords (the padded F
        rows are zero) and the ridge adds lam > 0 to the diagonal, so the
        normal equations decouple and solve to exactly 0 there (rhs is 0);
      * column side — Xty rows at padded coords are 0 (padded R columns are
        zero), so ridge gives 0 and CD/FSS keep them inactive (u = 0 under
        the soft-threshold; KKT gradient is exactly 0).
    This is the device-batched stage-1 rank sweep's padding scheme
    (the serial reference loops ranks one at a time, R/insider.R:100-131).
    """
    r = state.latent_dim
    if r == k_max:
        return state
    if r > k_max:
        raise ValueError(f"rank {r} > k_max {k_max}")
    pad = k_max - r
    cfd = [jnp.pad(f, ((0, 0), (0, pad))) for f in state.cfd_factors]
    ctns = (None if state.ctns_factor is None
            else jnp.pad(state.ctns_factor, ((0, 0), (0, pad))))
    F = jnp.pad(state.column_factor, ((0, pad), (0, 0)))
    return InsiderState(cfd, ctns, F, state.key)


def run_batched_rank_trials(
    problem: als.Problem,
    ranks: Sequence[int],
    lam: float,
    alpha: float,
    tuning_iter: int,
    global_tol: float,
    sub_tol: float,
    seeds: Sequence[int],
    check_every: int = 10,
    col_solver: str = "auto",
) -> List[dict]:
    """Stage-1 rank sweep, all ranks in ONE batched program.

    Each trial initializes at its own rank r (same N(0, 0.001^2) draws as
    the serial path under the same seed) and is zero-padded to max(ranks);
    padding is exact (see pad_state_rank), so per-rank results match the
    serial sweep up to vectorization-order float effects.

    Requires lam > 0 (the padded row-side solve needs the ridge on the
    diagonal); the reference's stage-1 always uses lambda=0.1
    (R/insider.R:120-121).
    """
    if not lam > 0.0:
        raise ValueError("batched rank sweep requires lambda > 0 "
                         "(padded coordinates need the ridge diagonal)")
    k_max = int(max(ranks))
    M = problem.shape[1]
    n_ctns = 0 if problem.ctns is None else problem.ctns.shape[1]
    states = _stack_states([
        pad_state_rank(
            init_state(jax.random.PRNGKey(s), problem.n_levels, M, int(r),
                       n_ctns=n_ctns),
            k_max,
        )
        for r, s in zip(ranks, seeds)
    ])
    grid = [(float(lam), float(alpha))] * len(ranks)
    out = run_batched_trials(problem, k_max, grid, tuning_iter, global_tol,
                             sub_tol, seeds, check_every=check_every,
                             states=states, col_solver=col_solver)
    for r, o in zip(ranks, out):
        o["rank"] = int(r)
    return out


@partial(jax.jit, static_argnums=(1, 2, 5))
def _batched_steps(arrays, statics, step_statics, hypers, states, n_steps,
                   sub_tols):
    """n_steps ALS iterations for all trials at once."""

    def one(state, hy, tol):
        def body(_, st):
            return als._als_iteration(arrays, statics, step_statics, hy, st,
                                      tol)
        return lax.fori_loop(0, n_steps, body, state)

    return jax.vmap(one)(states, hypers, sub_tols)


@partial(jax.jit, static_argnums=(1,))
def _batched_eval(arrays, statics, states):
    def one(state):
        R = als._row_factor(arrays, state)
        residual = arrays.data - losses.predict(R, state.column_factor)
        ev = losses.evaluate_masked(residual, arrays.train_mask,
                                    arrays.test_mask)
        reg = losses.regularization_sums(state.cfd_factors, state.ctns_factor,
                                         state.column_factor)
        return ev, reg

    return jax.vmap(one)(states)


def run_batched_trials(
    problem: als.Problem,
    rank: int,
    grid: Sequence[Tuple[float, float]],   # [(lambda, alpha), ...]
    tuning_iter: int,
    global_tol: float,
    sub_tol: float,
    seeds: Sequence[int],
    check_every: int = 10,
    states=None,
    col_solver: str = "auto",
) -> List[dict]:
    """Run all grid points of one rank simultaneously.

    Returns one dict per grid point: {lambda, alpha, train_rmse, test_rmse,
    loss, n_iter, diverged}.  A trial whose loss goes NaN/Inf is killed at
    the next check boundary (marked diverged; the rest of the batch keeps
    running) — the per-grid-point analog of the driver's divergence abort.

    check_every: convergence-check cadence (src/optimize.cpp:381's
    `iter % 10`, configurable like FitConfig.check_every).
    states: optional pre-stacked initial states (leading axis G); defaults
    to fresh per-seed N(0, 0.001^2) inits.
    col_solver: column sub-solver, as FitConfig.col_solver ("auto" = fss +
    polish; "cd" = the reference's strong-rule CD) — explicit so batched and
    serial comparisons exercise the same code path.
    """
    G = len(grid)
    M = problem.shape[1]
    arrays, statics = problem.arrays, problem.statics
    n_ctns = 0 if problem.ctns is None else problem.ctns.shape[1]

    if states is None:
        states = _stack_states([
            init_state(jax.random.PRNGKey(s), problem.n_levels, M, rank,
                       n_ctns=n_ctns)
            for s in seeds
        ])
    lam = np.asarray([g[0] for g in grid], np.float32)
    alpha = np.asarray([g[1] for g in grid], np.float32)
    hypers = als.Hypers(lam1=jnp.asarray(lam), lam2=jnp.asarray(lam),
                        alpha=jnp.asarray(alpha))
    # alpha==0 trials inside a CD batch would need the ridge dispatch; batch
    # them separately (caller splits the grid).
    if not (all(g[1] > 0 for g in grid) or all(g[1] == 0 for g in grid)):
        raise ValueError(
            "grid mixes alpha == 0 (ridge dispatch) with alpha > 0 (CD) "
            "trials; split it into separate batches")
    cfg = FitConfig(latent_dim=rank, alpha=float(alpha[0]), masked=True,
                    use_pallas=False, col_solver=col_solver)
    step_statics = als.StepStatics.from_config(cfg)

    def eval_all(states):
        evs, regs = _batched_eval(arrays, statics, states)
        # ONE device->host transfer for the whole batch, then finalize each
        # trial from the host copies (was: G x 7 scalar pulls per boundary).
        evs, regs = jax.device_get((evs, regs))
        out = []
        for g in range(G):
            ev = jax.tree.map(lambda x: x[g], evs)
            reg = jax.tree.map(lambda x: x[g], regs)
            out.append(losses.finalize_loss(
                ev, reg, float(lam[g]), float(lam[g]), float(alpha[g]),
                masked=True,
            ))
        return out

    metrics = eval_all(states)
    loss = np.array([m["loss"] for m in metrics])
    decay = np.ones(G)
    diverged = ~np.isfinite(loss)
    stopped = diverged.copy()
    stop_iter = np.full(G, tuning_iter)
    stop_iter[diverged] = 0

    it = 0
    while (not stopped.all()) and it <= tuning_iter:
        boundary = it if it % check_every == 0 else (
            (it // check_every + 1) * check_every
        )
        boundary = min(boundary, tuning_iter)
        n = boundary - it + 1
        sub_tols = jnp.asarray(sub_tol * decay, jnp.float32)
        states = _batched_steps(arrays, statics, step_statics, hypers, states,
                                n, sub_tols)
        it = boundary + 1

        pre = loss.copy()
        metrics = eval_all(states)
        loss = np.array([m["loss"] for m in metrics])
        delta = pre - loss
        decay = np.array([decay_from_delta_loss(d) for d in delta])
        newly_diverged = (~stopped) & (~np.isfinite(loss))
        diverged |= newly_diverged
        stop_iter[newly_diverged] = boundary
        with np.errstate(invalid="ignore"):
            newly = (~stopped) & np.isfinite(loss) & (
                (pre - loss) / pre < global_tol
            )
        stop_iter[newly] = boundary
        stopped |= newly | newly_diverged
        if stopped.all() or boundary >= tuning_iter:
            break

    return [
        {
            "lambda": float(lam[g]),
            "alpha": float(alpha[g]),
            "train_rmse": metrics[g]["train_rmse"],
            "test_rmse": metrics[g]["test_rmse"],
            "loss": metrics[g]["loss"],
            "n_iter": int(stop_iter[g]),
            "diverged": bool(diverged[g]),
        }
        for g in range(G)
    ]
