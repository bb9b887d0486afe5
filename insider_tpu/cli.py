"""Command-line entrypoints mirroring the reference workload scripts.

The reference ships per-dataset R scripts (tests/ageing.R, gtex.R, ...) that
all follow one recipe: load a table whose first columns are covariates and
the rest expression values, log2(x+1)-transform, build the insider object,
tune and/or fit, save the fitted object (SURVEY.md §2c).  This CLI is that
recipe as one tool:

    python -m insider_tpu fit --data expr.csv --confounder-cols 3 \
        --interaction 0,1 --rank 24 --lam 11 --alpha 0.4 --out fitted.npz
    python -m insider_tpu tune --data expr.csv --confounder-cols 2 \
        --ranks 10:31:2 --lambdas 1:21:2 --alphas 0.2,0.3,0.4,0.5
    python -m insider_tpu simulate --rows 250 --cols 200 --rank 5 --out sim.npz

Data formats: .csv/.tsv (header optional, numeric), .npy, or .npz with
arrays 'data' and optionally 'confounder'.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _parse_seq(spec: str, integer=False):
    """'1,2,3' or 'start:stop:step' (python slice semantics, stop exclusive)."""
    if ":" in spec:
        parts = [float(x) for x in spec.split(":")]
        start, stop = parts[0], parts[1]
        step = parts[2] if len(parts) > 2 else 1.0
        vals = list(np.arange(start, stop, step))
    else:
        vals = [float(x) for x in spec.split(",")]
    return [int(v) for v in vals] if integer else vals


def _looks_like_header(line: str, delim: str) -> bool:
    """A first line is a header iff any of its fields is neither numeric nor
    an NA token.  (The old one-character `isalpha` heuristic misread "1e5"
    as a header and "NA" data as one too"""
    for tok in line.rstrip("\r\n").split(delim):
        tok = tok.strip().strip('"')
        if tok == "" or tok.upper() in ("NA", "NAN", "N/A"):
            continue
        try:
            float(tok)
        except ValueError:
            return True
    return False


def _load_table(path: str, confounder_cols: int, log2: bool, skip_cols: int):
    if path.endswith(".npz"):
        z = np.load(path)
        data = np.asarray(z["data"], np.float64)
        conf = np.asarray(z["confounder"]) if "confounder" in z else None
        if conf is None and confounder_cols:
            conf, data = data[:, :confounder_cols], data[:, confounder_cols:]
    elif path.endswith(".npy"):
        raw = np.load(path)
        conf, data = raw[:, skip_cols:skip_cols + confounder_cols], \
            np.asarray(raw[:, skip_cols + confounder_cols:], np.float64)
    else:
        delim = "\t" if path.endswith((".tsv", ".txt")) else ","
        with open(path) as fh:
            first = fh.readline()
        has_header = _looks_like_header(first, delim)
        from insider_tpu.data.native import load_csv

        raw = np.asarray(load_csv(path, delim, skip_header=has_header),
                         np.float64)
        raw = raw[:, skip_cols:]
        conf = raw[:, :confounder_cols]
        data = np.asarray(raw[:, confounder_cols:], np.float64)
    if conf is not None:
        conf = conf.astype(np.int64)
    if log2:
        # README.md:47 — log2(x + 1) transform on raw expression
        data = np.log2(np.maximum(data, 0.0) + 1.0)
    return data, conf


def _build_object(args):
    import insider_tpu as it

    data, conf = _load_table(args.data, args.confounder_cols, args.log2,
                             args.skip_cols)
    if conf is None or conf.shape[1] == 0:
        # README "no covariates" mode: every row its own category
        conf = np.arange(1, data.shape[0] + 1)[:, None]
    interaction = (
        [int(x) for x in args.interaction.split(",")]
        if args.interaction else None
    )
    return it.Insider(
        data, conf, interaction_idx=interaction,
        split_ratio=args.split_ratio, global_tol=args.global_tol,
        sub_tol=args.sub_tol, tuning_iter=args.tuning_iter,
        max_iter=args.max_iter, split_seed=args.split_seed, seed=args.seed,
    )


def _save_fitted(path: str, obj):
    arrays = {f"factor{i}": f for i, f in enumerate(obj.cfd_matrices)}
    arrays["column_factor"] = obj.column_factor
    np.savez(path, **arrays)
    meta = {
        "test_rmse": obj.test_rmse,
        "loss": obj.fit_result.loss,
        "n_iter": obj.fit_result.n_iter,
        "train_rmse": obj.fit_result.train_rmse,
    }
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh, indent=2)
    print(json.dumps(meta))


def cmd_fit(args):
    obj = _build_object(args)
    obj = obj.fit(args.rank, args.lam, args.alpha, partition=args.partition,
                  log_jsonl=args.log_jsonl)
    _save_fitted(args.out, obj)


def cmd_tune(args):
    obj = _build_object(args)
    result = obj.tune(
        latent_dimension=_parse_seq(args.ranks, integer=True),
        lambda_=_parse_seq(args.lambdas),
        alpha=_parse_seq(args.alphas),
        out_dir=args.out_dir,
    )
    print(json.dumps({
        "latent_rank": int(result["latent_rank"]),
        "rank_tuning": None if result["rank_tuning"] is None
        else result["rank_tuning"].tolist(),
        "reg_tuning": None if result["reg_tuning"] is None
        else result["reg_tuning"].tolist(),
    }))


def cmd_simulate(args):
    import insider_tpu as it

    if args.preset == "insider":
        sim = it.simulate_insider_data(
            v1_num=args.v1, v2_num=args.v2, gene_num=args.cols,
            latent_dim=args.rank, noise_std=args.noise, seed=args.seed,
        )
    else:
        sim = it.simulate_scale(
            args.rows, args.cols, args.rank,
            level_counts=tuple(int(x) for x in args.levels.split(",")),
            noise_std=args.noise, seed=args.seed,
        )
    np.savez(args.out, data=sim.data, confounder=sim.confounder,
             gene_factor=sim.gene_factor)
    print(json.dumps({"out": args.out, "shape": list(sim.data.shape),
                      "confounders": sim.confounder.shape[1]}))


def _common(p):
    p.add_argument("--data", required=True)
    p.add_argument("--confounder-cols", type=int, default=1)
    p.add_argument("--skip-cols", type=int, default=0,
                   help="leading id columns to drop (tests/ageing.R:33)")
    p.add_argument("--interaction", default=None,
                   help="comma-separated 0-based confounder indices")
    p.add_argument("--log2", action="store_true",
                   help="apply log2(x+1) (README.md:47)")
    p.add_argument("--split-ratio", type=float, default=0.1)
    p.add_argument("--split-seed", type=int, default=123)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--global-tol", type=float, default=1e-9)
    p.add_argument("--sub-tol", type=float, default=1e-5)
    p.add_argument("--tuning-iter", type=int, default=30)
    p.add_argument("--max-iter", type=int, default=50000)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="insider_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("fit", help="final fit (R/insider.R:190)")
    _common(pf)
    pf.add_argument("--rank", type=int, required=True)
    pf.add_argument("--lam", type=float, required=True)
    pf.add_argument("--alpha", type=float, required=True)
    pf.add_argument("--partition", type=int, default=0, choices=[0, 1])
    pf.add_argument("--out", default="insider_fitted.npz")
    pf.add_argument("--log-jsonl", default=None)
    pf.set_defaults(fn=cmd_fit)

    pt = sub.add_parser("tune", help="two-stage tuning (R/insider.R:81)")
    _common(pt)
    pt.add_argument("--ranks", default="10:31:2")
    pt.add_argument("--lambdas", default="0.1")
    pt.add_argument("--alphas", default="0.0")
    pt.add_argument("--out-dir", default=".")
    pt.set_defaults(fn=cmd_tune)

    ps = sub.add_parser("simulate", help="synthetic data (simulation.rmd)")
    ps.add_argument("--preset", choices=["insider", "scale"],
                    default="insider")
    ps.add_argument("--rows", type=int, default=250)
    ps.add_argument("--cols", type=int, default=200)
    ps.add_argument("--rank", type=int, default=5)
    ps.add_argument("--v1", type=int, default=50)
    ps.add_argument("--v2", type=int, default=5)
    ps.add_argument("--levels", default="8,32")
    ps.add_argument("--noise", type=float, default=1.0)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--out", default="insider_sim.npz")
    ps.set_defaults(fn=cmd_simulate)

    args = ap.parse_args(argv)
    from insider_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
