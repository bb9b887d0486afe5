"""Flagship parity run (SURVEY.md gate M5).

Fits the flagship ageing configuration (reference tests/ageing.R:13-46:
377 samples, confounders pid/sid/did + interaction(pid, sid) inserted as
column 2 -> level structure (2, 16, 8, 107), K=24, lambda=11, alpha=0.4,
global_tol=1e-10, sub_tol=1e-5, checked every 10 iterations) on the attached
device with both column solvers: col_solver="cd" (the reference's strong-rule
coordinate descent, coordinate_descent.cpp:57-127) and col_solver="fss" (this
framework's default exact active-set solver).

The real Allen ageing matrix is an external .RData the reference repo itself
does not ship (.MISSING_LARGE_BLOBS); the artifact therefore runs the
reference's synthetic-generator analog at the full 377 x 44477 shape with a
10% held-out element mask (seed-123 splitter parity, R/utils.R:78-117).  R is
not installed in this image, so cd-vs-fss agreement is the standing
substitute for R-package parity: two independent solvers must trace the same
trajectory to the same fit.

Three protocols (all from the identical problem and identical init):

A. **Reference budget** — the reference's own flagship run caps at
   max_iter=1000 with global_tol=1e-10 (tests/ageing.R:40).  At that budget
   the relative 10-iter loss delta is ~1e-5, four orders of magnitude above
   global_tol, so the stop cannot fire within the reference's own budget
   regardless of arithmetic — the published ageing fit is a budget-capped
   run.  The gate is therefore *fixed-budget trajectory agreement*: both
   solvers complete the exact reference budget and agree on loss/RMSE.
B. **Stop fires** — run-to-convergence at global_tol=2e-7, the tightest
   tolerance the f32 iterates resolve (the measured 10-iter relative delta
   plateaus near 1.5e-7 by ~iter 12000 as factor updates reach f32
   quantization; the loss itself is accounted in compensated double-single,
   ops/precise.py, so the *measurement* resolves ~1e-14).  Both solvers'
   relative-loss stop (src/optimize.cpp:405) must actually fire
   (OptimizeResult.converged, not inferred from n_iter) and the
   converged fits must agree.
C. **Continuous covariates at scale** — same flagship shape with P=3
   continuous confounders planted in the data (optimize_continuous_v2,
   src/optimize.cpp:77-137,341-350), fixed reference-budget run (CTNS_ITERS
   iters), cd-vs-fss agreement + per-iter cost of the host-unrolled
   covariate loop (train/als.py _als_iteration) vs protocol A's.

Also reports the fit-regime wall clock: sec/iter in the decay<=0.01
convergence regime, from protocol B's elapsed_s deltas.

Writes <prefix>.md (summary + checks) and <prefix>.jsonl (full per-boundary
histories of every run).  tests/test_parity_replay.py replays protocols A
and B at reduced scale in CI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_ROWS, N_COLS, K = 377, 44477, 24
LEVELS = (2, 8, 107)        # pid, sid, did; interaction(pid, sid) -> 16
LAMBDA, ALPHA = 11.0, 0.4
GLOBAL_TOL, SUB_TOL = 1e-10, 1e-5
REF_BUDGET = 1000           # tests/ageing.R:40
FIRES_TOL = 2e-7            # protocol B: tightest f32-resolvable stop
FIRES_MAX_ITER = 25000
CTNS_P, CTNS_ITERS = 3, 1000

# Agreement bounds per protocol (relative cd-vs-fss gaps; the gap shrinks
# monotonically with iterations).  The md records the measured gaps next to
# the bounds.
BOUNDS = {
    "A": {"loss": 3e-4, "train_rmse": 1e-5, "test_rmse": 2e-5},
    "B": {"loss": 5e-5, "train_rmse": 1e-5, "test_rmse": 2e-5},
    "C": {"loss": 2e-3, "train_rmse": 5e-5, "test_rmse": 5e-5},
}


def rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-prefix", default="parity_flagship")
    ap.add_argument("--fires-max-iter", type=int, default=FIRES_MAX_ITER)
    args = ap.parse_args()

    import jax

    from insider_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    import insider_tpu as it
    from insider_tpu.api import build_interaction_codes
    from insider_tpu.config import FitConfig
    from insider_tpu.train import als

    # Ageing-shaped problem: 3 confounders + interaction of the first two
    # inserted as column 2 (R/insider.R:40) -> 4 factor matrices.
    sim = it.simulate_scale(N_ROWS, N_COLS, K, level_counts=LEVELS,
                            noise_std=1.0, seed=0)
    conf = sim.confounder                              # (N, 3)
    inter = build_interaction_codes(conf, [0, 1])
    conf_full = np.column_stack([conf[:, 0], inter, conf[:, 1:]])

    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1,
                              rm_na_col=False)
    problem = als.build_problem(
        split.data, conf_full, split.train_indicator, split.test_indicator,
        masked=True,
    )
    n_levels = problem.n_levels
    print(f"levels: {n_levels}", file=sys.stderr)

    # Protocol C problem: plant P continuous covariates with a real (P, K)
    # coefficient block so W fits genuine structure, not noise.
    rng = np.random.default_rng(7)
    ctns = rng.standard_normal((N_ROWS, CTNS_P)).astype(np.float32)
    w_true = rng.standard_normal((CTNS_P, K)).astype(np.float32)
    data_c = sim.data + (ctns @ w_true) @ sim.gene_factor
    split_c = it.ratio_splitter(data_c.astype(np.float64), ratio=0.1,
                                rm_na_col=False)
    problem_c = als.build_problem(
        split_c.data, conf_full, split_c.train_indicator,
        split_c.test_indicator, ctns_confounder=ctns, masked=True,
    )

    jsonl_path = args.out_prefix + ".jsonl"
    if os.path.exists(jsonl_path):
        os.remove(jsonl_path)

    def run(tag, prob, solver, max_iter, global_tol):
        cfg = FitConfig(latent_dim=K, lambda1=LAMBDA, lambda2=LAMBDA,
                        alpha=ALPHA, masked=True, global_tol=global_tol,
                        sub_tol=SUB_TOL, max_iter=max_iter,
                        col_solver=solver, seed=0,
                        # parity pins the reference ALGORITHM's trajectory:
                        # run cd cold (no FSS warm start)
                        cd_warm_start=False)
        with open(jsonl_path, "a") as fh:
            fh.write(json.dumps({"run": tag, "solver": solver,
                                 "config": dataclasses.asdict(cfg)}) + "\n")
        t0 = time.time()
        res = als.optimize(prob, cfg, log_jsonl=jsonl_path, verbose=False)
        wall = time.time() - t0
        final = res.history[-1]
        out = {
            "tag": tag,
            "solver": solver,
            "converged": res.converged,
            "diverged": res.diverged,
            "n_iter": res.n_iter,
            "wall_s": wall,
            "loss": res.loss,
            "train_rmse": res.train_rmse,
            "test_rmse": res.test_rmse,
            "sum_residual": final["sum_residual"],
            "factor_shapes": [list(np.asarray(f).shape)
                              for f in res.row_matrices],
            "column_factor_shape": list(res.column_factor.shape),
            "f_exact_zero_frac": float((res.column_factor == 0).mean()),
            "history": res.history,
        }
        if res.ctns_factor is not None:
            out["ctns_factor_shape"] = list(res.ctns_factor.shape)
        print(json.dumps({k: v for k, v in out.items() if k != "history"}),
              file=sys.stderr)
        return out

    runs = {}
    for solver in ("cd", "fss"):
        runs["A", solver] = run(f"A_{solver}", problem, solver,
                                REF_BUDGET, GLOBAL_TOL)
    for solver in ("cd", "fss"):
        runs["B", solver] = run(f"B_{solver}", problem, solver,
                                args.fires_max_iter, FIRES_TOL)
    for solver in ("cd", "fss"):
        runs["C", solver] = run(f"C_{solver}", problem_c, solver,
                                CTNS_ITERS, GLOBAL_TOL)

    def agreement(proto):
        cd, fss = runs[proto, "cd"], runs[proto, "fss"]
        return {m: rel(cd[m], fss[m])
                for m in ("loss", "train_rmse", "test_rmse")}

    def agree_pass(proto):
        gaps = agreement(proto)
        return all(gaps[m] <= BOUNDS[proto][m] for m in gaps)

    def fit_regime_sec_per_iter(r):
        # sec/iter over the last 40% of protocol B boundaries (decay<=0.01
        # convergence regime), from elapsed_s deltas.
        h = [x for x in r["history"] if x["iter"] >= 0]
        a, b = h[int(len(h) * 0.6)], h[-1]
        return (b["elapsed_s"] - a["elapsed_s"]) / max(b["iter"] - a["iter"], 1)

    fss_fit_sec = fit_regime_sec_per_iter(runs["B", "fss"])
    cd_fit_sec = fit_regime_sec_per_iter(runs["B", "cd"])

    cdA = runs["A", "cd"]
    shapes_ok = (
        [s[0] for s in cdA["factor_shapes"]] == list(n_levels)
        and n_levels[0] == 2 and n_levels[1] == 16 and n_levels[2] == 8
        and n_levels[3] >= 100
        and all(s[1] == K for s in cdA["factor_shapes"])
        and cdA["column_factor_shape"] == [K, N_COLS]
        and runs["C", "cd"].get("ctns_factor_shape") == [CTNS_P, K]
    )

    checks = {
        "A_both_completed_reference_budget": all(
            (not runs["A", s]["diverged"])
            and runs["A", s]["n_iter"] == REF_BUDGET for s in ("cd", "fss")),
        "A_agreement": agreement("A"),
        "A_pass": agree_pass("A"),
        "B_both_converged": all(
            runs["B", s]["converged"] for s in ("cd", "fss")),
        "B_iters_to_tol": {s: runs["B", s]["n_iter"] for s in ("cd", "fss")},
        "B_agreement": agreement("B"),
        "B_pass": agree_pass("B"),
        "C_both_completed": all(
            not runs["C", s]["diverged"] for s in ("cd", "fss")),
        "C_agreement": agreement("C"),
        "C_pass": agree_pass("C"),
        "shapes_match_reference": shapes_ok,
        "fit_regime_sec_per_iter": {"fss": fss_fit_sec, "cd": cd_fit_sec},
    }
    checks["pass"] = bool(
        checks["A_both_completed_reference_budget"] and checks["A_pass"]
        and checks["B_both_converged"] and checks["B_pass"]
        and checks["C_both_completed"] and checks["C_pass"]
        and checks["shapes_match_reference"]
    )

    md = []
    md.append(f"# {args.out_prefix} — ageing flagship parity (gate M5)\n")
    md.append(
        f"Device: `{jax.devices()[0]}`; config: 377x44477, confounders "
        f"(pid, interaction, sid, did) = levels {tuple(n_levels)}, K={K}, "
        f"lambda={LAMBDA}, alpha={ALPHA}, sub_tol={SUB_TOL} with the "
        f"reference decay ladder, 10% held-out element mask (seed 123).  "
        f"Synthetic ageing-shaped matrix (the real .RData is absent from "
        f"the reference repo too); per protocol, both solvers fit the "
        f"identical problem from the identical init.\n")
    md.append(
        "**Protocol honesty note.** The reference's own flagship run "
        f"(tests/ageing.R:40) caps at max_iter={REF_BUDGET} with "
        f"global_tol={GLOBAL_TOL:g}; at that budget the relative 10-iter "
        "loss delta is ~1e-5 — four orders above the tolerance — so the "
        "stop cannot fire within the reference's own budget in any "
        "arithmetic, and the published ageing fit is a budget-capped run.  "
        "Protocol A therefore gates on fixed-budget trajectory agreement "
        "at the reference's exact budget.  Protocol B proves the stop "
        f"machinery fires: at global_tol={FIRES_TOL:g} (the tightest "
        "tolerance f32 iterates resolve — the measured delta plateaus near "
        "1.5e-7 as factor updates hit f32 quantization; the loss "
        "*measurement* is compensated double-single, ops/precise.py) both "
        "solvers' relative-loss stop fires and the converged fits agree.  "
        "Protocol C adds P=3 planted continuous covariates "
        "(optimize_continuous_v2, src/optimize.cpp:77-137) at the full "
        "flagship shape.\n")

    for proto, desc in (
        ("A", f"reference budget (max_iter={REF_BUDGET}, tol={GLOBAL_TOL:g})"),
        ("B", f"stop fires (tol={FIRES_TOL:g})"),
        ("C", f"continuous covariates (P={CTNS_P}, {CTNS_ITERS} iters)"),
    ):
        cd, fs = runs[proto, "cd"], runs[proto, "fss"]
        gaps = agreement(proto)
        md.append(f"## Protocol {proto} — {desc}\n")
        md.append("| metric | cd (reference algorithm) | fss (default) | "
                  "rel diff | bound |")
        md.append("|---|---|---|---|---|")
        for m in ("loss", "train_rmse", "test_rmse"):
            md.append(f"| {m} | {cd[m]:.10g} | {fs[m]:.10g} | "
                      f"{gaps[m]:.3g} | {BOUNDS[proto][m]:g} |")
        md.append(f"| n_iter (stop fired) | {cd['n_iter']} "
                  f"({cd['converged']}) | {fs['n_iter']} "
                  f"({fs['converged']}) | — | — |")
        md.append(f"| wall_s | {cd['wall_s']:.1f} | {fs['wall_s']:.1f} "
                  f"| — | — |")
        md.append(f"| exact-zero frac of F | {cd['f_exact_zero_frac']:.4f} "
                  f"| {fs['f_exact_zero_frac']:.4f} | — | — |")
        md.append("")

    # Trajectory-agreement evidence: the cd-vs-fss gap shrinks as both runs
    # converge toward the same fit (protocol B histories).
    hb_cd = {h["iter"]: h for h in runs["B", "cd"]["history"]}
    hb_fs = {h["iter"]: h for h in runs["B", "fss"]["history"]}
    md.append("## Trajectory agreement (protocol B)\n")
    md.append("| iter | rel loss gap | rel test_rmse gap |")
    md.append("|---|---|---|")
    common = sorted(set(hb_cd) & set(hb_fs))
    picks = [i for i in (500, 1000, 2000, 4000, 8000, 12000, 16000, 20000)
             if i in common]
    for i in picks:
        md.append(f"| {i} | {rel(hb_cd[i]['loss'], hb_fs[i]['loss']):.3g} | "
                  f"{rel(hb_cd[i]['test_rmse'], hb_fs[i]['test_rmse']):.3g} |")
    md.append("")
    md.append(
        f"Fit-regime wall clock: {fss_fit_sec * 1e3:.2f} ms/iter (fss) / "
        f"{cd_fit_sec * 1e3:.2f} ms/iter (cd) over the last 40% of "
        f"protocol B — boundary eval and host round-trip included.\n")
    md.append(f"Factor shapes: {cdA['factor_shapes']} + column_factor "
              f"{cdA['column_factor_shape']} + ctns_factor "
              f"{runs['C', 'cd'].get('ctns_factor_shape')} — the reference "
              f"structural contract (README.md:113-118 at K=24: interaction "
              f"factor in position 2 per R/insider.R:40).\n")
    md.append(f"## Checks\n\n```json\n{json.dumps(checks, indent=2)}\n```\n")
    md.append(f"Full per-boundary histories: `{jsonl_path}`.  Protocols A "
              f"and B are replayed at reduced scale in CI by "
              f"`tests/test_parity_replay.py`.\n")
    with open(args.out_prefix + ".md", "w") as fh:
        fh.write("\n".join(md))
    print(json.dumps(checks))
    sys.exit(0 if checks["pass"] else 1)


if __name__ == "__main__":
    main()
