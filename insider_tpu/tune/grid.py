"""Hyperparameter tuning: two-stage rank then (lambda, alpha) grid.

Transliteration of `tune()` (R/insider.R:81-176): stage 1 sweeps latent rank
with a fresh init per trial and short `tuning_iter` runs, writing
`insider_rank_tuning_result.csv` incrementally; the rank minimizing held-out
test RMSE wins (:135-139).  Stage 2 sweeps expand.grid(lambda, alpha) —
lambda varying fastest, as R's expand.grid — writing
`insider_R<rank>_reg_tuning_result.csv`.

When the rank sweep is followed by a reg sweep, rank trials run with
(lambda=0.1, alpha=0) exactly as the reference (:120-121).

Each grid point is an independent short optimize() run and results are
flushed after every trial, so a killed sweep is resumable by hand — same
operational behavior as the reference.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence

import jax
import numpy as np

from insider_tpu.config import FitConfig
from insider_tpu.model.state import init_state
from insider_tpu.train import als


def _as_list(x):
    if np.isscalar(x):
        return [x]
    return list(x)


def _run_trial(problem, obj, rank, lam, alpha, trial_seed, tuning_iter,
               col_solver="auto"):
    cfg = FitConfig(
        latent_dim=int(rank),
        lambda1=float(lam),
        lambda2=float(lam),
        alpha=float(alpha),
        masked=True,
        global_tol=obj.params["global_tol"],
        sub_tol=obj.params["sub_tol"],
        max_iter=int(tuning_iter),
        seed=trial_seed,
        col_solver=col_solver,
    )
    state = init_state(
        jax.random.PRNGKey(trial_seed),
        problem.n_levels,
        problem.shape[1],
        cfg.latent_dim,
        n_ctns=0 if problem.ctns is None else problem.ctns.shape[1],
        init_std=cfg.init_std,
    )
    res = als.optimize(problem, cfg, state=state, verbose=False)
    return res


def _append_csv(path, header, row):
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(header)
        w.writerow(row)


def tune(obj, latent_dimension, lambda_=0.1, alpha=0.0, out_dir=".",
         batch_grid=True, batch_size=16):
    """Returns dict(rank_tuning, latent_rank, reg_tuning) like R/insider.R:175.

    batch_grid: run the stage-2 (lambda, alpha) grid device-batched (vmapped
    trials, tune/batched.py) in chunks of `batch_size` instead of serially.
    """
    ranks = [int(r) for r in _as_list(latent_dimension)]
    lambdas = [float(x) for x in _as_list(lambda_)]
    alphas = [float(a) for a in _as_list(alpha)]

    if len(ranks) <= 1 and len(lambdas) <= 1 and len(alphas) <= 1:
        raise ValueError(
            "TUNING: either latent_dimension or (lambda, alpha) must have "
            "length > 1 (R/insider.R:87-89)"
        )

    problem = obj.tuning_problem()
    tuning_iter = obj.params["tuning_iter"]
    will_reg_sweep = len(lambdas) > 1 or len(alphas) > 1

    rank_tuning: List[list] = []
    rank_csv = os.path.join(out_dir, "insider_rank_tuning_result.csv")
    if len(ranks) > 1:
        if will_reg_sweep:
            lam_t, alpha_t = 0.1, 0.0          # R/insider.R:120-121
        else:
            lam_t, alpha_t = lambdas[0], alphas[0]
        if batch_grid and lam_t > 0.0:
            # Device-batched rank sweep: ranks padded to a shared K and run
            # as one vmapped program per chunk (tune/batched.py).
            from insider_tpu.tune.batched import run_batched_rank_trials

            for s in range(0, len(ranks), batch_size):
                chunk = ranks[s:s + batch_size]
                out = run_batched_rank_trials(
                    problem, chunk, lam_t, alpha_t, tuning_iter,
                    obj.params["global_tol"], obj.params["sub_tol"],
                    seeds=[obj.seed + s + i for i in range(len(chunk))],
                )
                for rank, r in zip(chunk, out):
                    row = [rank, r["train_rmse"], r["test_rmse"]]
                    rank_tuning.append(row)
                    _append_csv(rank_csv,
                                ["latent_rank", "train_rmse", "test_rmse"],
                                row)
        else:
            for t, rank in enumerate(ranks):
                res = _run_trial(problem, obj, rank, lam_t, alpha_t,
                                 trial_seed=obj.seed + t,
                                 tuning_iter=tuning_iter)
                row = [rank, res.train_rmse, res.test_rmse]
                rank_tuning.append(row)
                _append_csv(rank_csv,
                            ["latent_rank", "train_rmse", "test_rmse"], row)

    if len(ranks) > 1:
        best = int(np.argmin([r[2] for r in rank_tuning]))
        latent_rank = ranks[best]               # argmin test rmse, :135-139
    else:
        latent_rank = ranks[0]

    reg_tuning: List[list] = []
    if will_reg_sweep:
        reg_csv = os.path.join(
            out_dir, f"insider_R{latent_rank}_reg_tuning_result.csv"
        )
        # expand.grid: first factor (lambda) varies fastest (R/insider.R:145).
        # Values pass through untouched — the reference does not round, and
        # rounding to 2 decimals collapsed e.g. a 0.125-vs-0.1251 sweep.
        grid = [(l, a) for a in alphas for l in lambdas]
        if batch_grid:
            from insider_tpu.tune.batched import run_batched_trials

            # alpha==0 points use the ridge dispatch — batch separately.
            zero = [(i, g) for i, g in enumerate(grid) if g[1] == 0.0]
            nonzero = [(i, g) for i, g in enumerate(grid) if g[1] != 0.0]
            results = [None] * len(grid)
            for group in (zero, nonzero):
                for s in range(0, len(group), batch_size):
                    chunk = group[s:s + batch_size]
                    out = run_batched_trials(
                        problem, latent_rank, [g for _, g in chunk],
                        tuning_iter, obj.params["global_tol"],
                        obj.params["sub_tol"],
                        seeds=[obj.seed + 1000 + i for i, _ in chunk],
                    )
                    for (i, _), r in zip(chunk, out):
                        results[i] = r
            for (lam, al), r in zip(grid, results):
                row = [lam, al, r["train_rmse"], r["test_rmse"]]
                reg_tuning.append(row)
                _append_csv(reg_csv,
                            ["lambda", "alpha", "train_rmse", "test_rmse"],
                            row)
        else:
            for t, (lam, al) in enumerate(grid):
                res = _run_trial(problem, obj, latent_rank, lam, al,
                                 trial_seed=obj.seed + 1000 + t,
                                 tuning_iter=tuning_iter)
                row = [lam, al, res.train_rmse, res.test_rmse]
                reg_tuning.append(row)
                _append_csv(reg_csv,
                            ["lambda", "alpha", "train_rmse", "test_rmse"],
                            row)

    return {
        "rank_tuning": np.asarray(rank_tuning) if rank_tuning else None,
        "latent_rank": latent_rank,
        "reg_tuning": np.asarray(reg_tuning) if reg_tuning else None,
    }
