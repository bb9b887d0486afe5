"""Benchmark: ALS iteration time on the flagship masked workload, one GPU.

Config mirrors the full ageing workload (tests/ageing.R:13-40 and
README.md:30): a 377 x 44477 matrix, 4 discrete confounders with the
reference's level structure (2/16/8/107 — pid, interaction, sid, did),
K=24, lambda=11, alpha=0.4, 10% held-out element mask.

Both column solvers are timed — "fss" (the default exact active-set solve)
and "cd" (FSS-warm-started coordinate descent) — after each is warmed into
its converged regime by the driver's own protocol (sub_tol decay ladder,
10-iter check cadence) until the relative loss delta falls below 1e-7.

Per solver:
  sec_per_iter             steady-state ALS iteration at the settled decay
  nnz_per_s                observed training entries x factor-update blocks
                           per iteration (4 row blocks + 1 column block),
                           over sec_per_iter
  fit_regime_sec_per_iter  the driver's boundary chain at decay <= 0.1,
                           every-10-iteration evaluation included

Every time ends in jax.block_until_ready.  A run that finds no GPU fails,
as does any failure of a solver.  Prints ONE JSON line naming the card and
its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_ROWS, N_COLS, K = 377, 44477, 24
LEVELS = (2, 16, 8, 107)
LAMBDA, ALPHA = 11.0, 0.4
TIMED_ITERS = 50
MAX_WARM_CHUNKS = 20          # x check_every iterations
WARM_REL_DELTA = 1e-7


def card():
    """(device_kind, nvidia-smi 'name, power.limit') of the first GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return dev.device_kind, smi.stdout.strip().splitlines()[0]


def build():
    import insider_tpu as it
    from insider_tpu.train import als

    sim = it.simulate_scale(N_ROWS, N_COLS, K, level_counts=LEVELS,
                            noise_std=1.0, seed=0)
    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1,
                              rm_na_col=False)
    problem = als.build_problem(split.data, sim.confounder,
                                split.train_indicator, split.test_indicator,
                                masked=True)
    return problem, int(np.asarray(split.train_indicator).sum())


def run_solver(problem, solver: str):
    """Warm to the converged regime under the driver's protocol, then time
    TIMED_ITERS at the settled decay.  Returns (sec_per_iter, detail)."""
    import jax
    import jax.numpy as jnp

    from insider_tpu.config import FitConfig, decay_from_delta_loss
    from insider_tpu.model.state import init_state
    from insider_tpu.ops import losses
    from insider_tpu.train import als

    config = FitConfig(latent_dim=K, lambda1=LAMBDA, lambda2=LAMBDA,
                       alpha=ALPHA, masked=True, col_solver=solver)
    state = init_state(jax.random.PRNGKey(0), problem.n_levels, N_COLS, K)
    ss = als.StepStatics.from_config(config)
    hy = als.Hypers(jnp.float32(LAMBDA), jnp.float32(LAMBDA),
                    jnp.float32(ALPHA))
    arrays, statics = problem.arrays, problem.statics

    def loss_of(st):
        ev, reg = als._evaluate(arrays, statics, st)
        vec = np.asarray(losses.pack_metrics(ev, reg))
        return losses.finalize_metrics_vec(vec, LAMBDA, LAMBDA, ALPHA,
                                           True)["loss"]

    decay = 1.0
    loss = loss_of(state)
    chunks = 0
    for _ in range(MAX_WARM_CHUNKS):
        sub_tol = jnp.float32(config.sub_tol * decay)
        state = als._run_steps(arrays, statics, ss, hy, state, sub_tol,
                               jnp.int32(config.check_every))
        pre, loss = loss, loss_of(state)
        delta = pre - loss
        decay = decay_from_delta_loss(delta)
        chunks += 1
        if abs(delta) / max(abs(pre), 1e-30) < WARM_REL_DELTA:
            break
    jax.block_until_ready(state)

    sub_tol = jnp.float32(config.sub_tol * decay)
    t0 = time.perf_counter()
    state = als._run_steps(arrays, statics, ss, hy, state, sub_tol,
                           jnp.int32(TIMED_ITERS))
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / TIMED_ITERS

    # Fit regime: decay <= 0.1 (tighter inner solves) through the driver's
    # own boundary chain, evaluation included.
    fit_decay = min(decay, 0.1)
    n_per = config.check_every
    bpd = config.boundaries_per_dispatch

    def dispatch(st, cur_loss):
        pre_pair = jnp.asarray(
            [np.float32(cur_loss),
             np.float32(cur_loss - np.float64(np.float32(cur_loss)))],
            jnp.float32)
        st, mbuf, _ = als._run_boundary_chain(
            arrays, statics, ss, hy, st, jnp.float32(config.sub_tol),
            jnp.float32(fit_decay), pre_pair, (bpd, n_per, 0.0))
        m = losses.finalize_metrics_vec(np.asarray(mbuf)[-1, :-1], LAMBDA,
                                        LAMBDA, ALPHA, True)
        return st, m["loss"]

    cur = loss_of(state)
    state, cur = dispatch(state, cur)   # compile at this decay
    n_disp = 2
    t0 = time.perf_counter()
    for _ in range(n_disp):
        state, cur = dispatch(state, cur)
    fit_dt = (time.perf_counter() - t0) / (n_disp * bpd * n_per)
    return dt, {"warm_iters": chunks * n_per, "decay": decay,
                "fit_regime_sec_per_iter": fit_dt,
                "fit_regime_decay": fit_decay,
                "fit_regime_boundaries_per_dispatch": bpd}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=["fss", "cd", "both"],
                    default="both")
    args = ap.parse_args()

    from insider_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    kind, smi = card()
    problem, nnz = build()
    blocks = len(LEVELS) + 1
    per_solver = {}
    for s in (["fss", "cd"] if args.solver == "both" else [args.solver]):
        dt, det = run_solver(problem, s)
        per_solver[s] = {"sec_per_iter": dt, "nnz_per_s": blocks * nnz / dt,
                         **det}
    primary = per_solver.get("fss") or next(iter(per_solver.values()))
    import jax

    print(json.dumps({
        "metric": "factor_update_nnz_per_s",
        "value": primary["nnz_per_s"],
        "unit": "nnz/s",
        "detail": {
            "config": f"{N_ROWS}x{N_COLS} K={K} levels={LEVELS} "
                      f"lambda={LAMBDA} alpha={ALPHA} masked 10%",
            "train_nnz": nnz,
            "device": {"platform": jax.devices()[0].platform, "kind": kind,
                       "count": len(jax.devices())},
            "nvidia_smi_name_power_limit": smi,
            "solvers": per_solver,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
