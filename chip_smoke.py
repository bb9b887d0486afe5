"""Smoke test of the whole system on one NVIDIA GPU, at flagship width.

    python chip_smoke.py                 # one card: phases 1-7
    python chip_smoke.py --four-cards    # four cards: the sharded fits only

Phases (one line each; any failure exits nonzero and prints no result):
  1. device       - JAX must see GPUs; prints nvidia-smi's name/power limit
  2. flagship fit - Insider(...).fit at the ageing flagship width
                    (377 x 44477, confounders 2/8/107 + their 16-level
                    interaction, K=24, lambda=11, alpha=0.4, 10% split)
  3. dense, cd    - partition=0, and col_solver="cd", on the same data
  4. tune         - a small two-stage tune() sweep
  5. cli          - insider_tpu.cli.main(["fit", ...]) in this process
  6. kernel       - the Triton FSS kernel against the XLA reference solve
  7. oracle       - the driver against the f64 numpy oracle (tests/oracles.py)
  8. four cards   - (--four-cards only) meshes (1, 4) and (2, 2) against the
                    single-card fit of the same problem

The last line of stdout is {"ok": true, "device": {...}}.  One process owns
the card(s): every phase runs in this process (the CLI is called in-process).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
N_ROWS, N_COLS, K = 377, 44477, 24
LEVELS = (2, 8, 107)
LAM, ALPHA = 11.0, 0.4
NA_FRACTION = 0.02        # missing cells: the held-out set of partition=1

# Kernel vs reference (phase 6): both solve the same strictly convex
# problems in f32 with different reduction orders, so per-column objectives
# agree to f32 rounding; a coordinate within rounding of its KKT boundary
# may be zero in one and tiny in the other.
KERNEL_OBJ_RTOL = 1e-6
KERNEL_ZERO_PATTERN_FRAC = 1e-3
# Driver vs f64 oracle (phase 7): the CPU suite's tolerances
# (tests/test_driver_oracle.py), which f32 arithmetic meets and TF32 would
# not (TF32 keeps ~3 decimal digits).
ORACLE_RTOL = {"fss": 3e-5, "cd": 2e-5}
# Sharded vs single card (phase 8): the psums and the per-shard matmuls add
# in another order than one card does.  The loss at every boundary is held
# to dryrun_multichip's 2e-4.  The column factor is held to 1e-2 of its
# largest entry: the soft threshold turns a rounding-level change in a
# coordinate's |u| - l1 into a much larger relative change of its value
# (measured on four H100s, power limit 400 W: 2.6e-3 on (1, 4) and 2.0e-3
# on (2, 2) after 20 iterations, while every boundary loss agreed within
# 8.8e-5).
MESH_LOSS_RTOL = 2e-4
MESH_FACTOR_RTOL = 1e-2


class PhaseFailed(Exception):
    pass


def phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        detail = fn(*args)
    except Exception as exc:  # noqa: BLE001 - report and stop
        traceback.print_exc()
        print(f"PHASE {name}: FAILED ({type(exc).__name__}: {exc})",
              flush=True)
        raise PhaseFailed(name) from exc
    print(f"PHASE {name}: ok ({time.perf_counter() - t0:.1f} s) {detail}",
          flush=True)
    return detail


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_phase(n_cards):
    import jax

    devs = jax.devices()
    check(len(devs) >= n_cards,
          f"needs {n_cards} GPUs, JAX sees {len(devs)} device(s)")
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    return f"device_kind={devs[0].device_kind!r} count={len(devs)}"


def flagship_data(seed):
    import numpy as np

    import insider_tpu as it

    sim = it.simulate_scale(N_ROWS, N_COLS, K, level_counts=LEVELS,
                            noise_std=1.0, seed=seed)
    data = sim.data.astype(np.float64)
    rng = np.random.default_rng(seed + 1)
    data[rng.random(data.shape) < NA_FRACTION] = np.nan
    return data, sim.confounder


def check_fit(obj, n_levels, max_iter):
    import numpy as np

    res = obj.fit_result
    shapes = [f.shape for f in obj.cfd_matrices]
    check(shapes == [(L, K) for L in n_levels],
          f"row factor shapes {shapes}")
    check(obj.column_factor.shape == (K, N_COLS),
          f"column factor shape {obj.column_factor.shape}")
    losses = [h["loss"] for h in res.history]
    check(len(losses) >= 1 + max_iter // 10,
          f"{len(losses)} boundaries logged")
    check(all(np.isfinite(losses)), f"non-finite loss in {losses}")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:])),
          f"loss increased: {losses}")
    return losses


def fit_phase(state, seed):
    import numpy as np

    import insider_tpu as it

    data, conf = flagship_data(seed)
    obj = it.Insider(data, conf, interaction_idx=[0, 1], split_ratio=0.1,
                     tuning_iter=20, seed=seed)
    n_levels = [len(np.unique(obj.confounder[:, c]))
                for c in range(obj.confounder.shape[1])]
    max_iter = 40
    t0 = time.perf_counter()
    obj.fit(K, LAM, ALPHA, partition=1, max_iter=max_iter, verbose=False)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    obj.fit(K, LAM, ALPHA, partition=1, max_iter=max_iter, verbose=False)
    steady = time.perf_counter() - t0
    losses = check_fit(obj, n_levels, max_iter)
    zeros = float(np.mean(obj.column_factor == 0.0))
    check(zeros > 0.0, "alpha>0 left no exact zeros in column_factor")
    check(np.isfinite(obj.test_rmse), f"test RMSE {obj.test_rmse}")
    state.update(obj=obj, n_levels=n_levels, result=obj.fit_result)
    return (f"levels={n_levels} iters={obj.fit_result.n_iter} "
            f"compile~{first - steady:.1f}s steady_wall={steady:.3f}s "
            f"({steady / obj.fit_result.n_iter * 1e3:.2f} ms/iter) "
            f"loss {losses[0]:.6g}->{losses[-1]:.9g} "
            f"test_rmse={obj.test_rmse:.6f} zero_frac={zeros:.4f}")


def dense_cd_phase(state):
    obj, n_levels = state["obj"], state["n_levels"]
    out = []
    for label, kw in (("dense", dict(partition=0)),
                      ("cd", dict(partition=1, col_solver="cd"))):
        t0 = time.perf_counter()
        obj.fit(K, LAM, ALPHA, max_iter=30, verbose=False, **kw)
        losses = check_fit(obj, n_levels, 30)
        out.append(f"{label}: {time.perf_counter() - t0:.1f}s "
                   f"loss {losses[0]:.6g}->{losses[-1]:.9g}")
    return "; ".join(out)


def tune_phase(state):
    import numpy as np

    obj = state["obj"]
    with tempfile.TemporaryDirectory() as tmp:
        result = obj.tune(latent_dimension=[10, 24], lambda_=[1, 11],
                          alpha=[0.4, 0.9], out_dir=tmp)
        csvs = sorted(os.listdir(tmp))
    rank = result["latent_rank"]
    check(rank in (10, 24), f"best rank {rank}")
    rmse = [float(r[2]) for r in result["reg_tuning"]]
    check(all(np.isfinite(rmse)), f"reg tuning test RMSE {rmse}")
    return (f"latent_rank={rank} reg_test_rmse="
            f"{[round(x, 6) for x in rmse]} csv={csvs}")


def cli_phase(seed):
    import numpy as np

    from insider_tpu import cli

    rng = np.random.default_rng(seed)
    n, m = 60, 200
    conf = np.stack([rng.integers(1, 3, n), rng.integers(1, 4, n)], axis=1)
    expr = rng.gamma(2.0, 4.0, size=(n, m))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "expr.csv")
        np.savetxt(path, np.column_stack([conf, expr]), delimiter=",",
                   fmt="%.6g")
        out = os.path.join(tmp, "fitted.npz")
        cli.main(["fit", "--data", path, "--confounder-cols", "2",
                  "--interaction", "0,1", "--log2", "--rank", "4",
                  "--lam", "1", "--alpha", "0.4", "--partition", "1",
                  "--max-iter", "30", "--out", out])
        with open(out + ".json") as fh:
            meta = json.load(fh)
        F = np.load(out)["column_factor"]
    check(F.shape == (4, m), f"column factor {F.shape}")
    check(np.isfinite(meta["loss"]), f"loss {meta['loss']}")
    return f"loss={meta['loss']:.6g} n_iter={meta['n_iter']}"


def kernel_phase(state):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from insider_tpu.kernels.fss_triton import feature_sign_triton
    from insider_tpu.ops import col_update
    from insider_tpu.ops.fss import feature_sign_batched
    from insider_tpu.train import als

    obj = state["obj"]
    problem = als.build_problem(
        obj.data, obj.confounder, obj.train_indicator + obj.test_indicator,
        obj.na_indicator, masked=True)
    st = state["result"].state
    R = als._row_factor(problem.arrays, st)
    F = st.column_factor
    mask = problem.train_mask
    XtX = col_update.col_gram_masked(R, mask)
    Xty = jnp.matmul(R.T, mask * problem.data, precision="highest")
    tol = jnp.float32(1e-7)
    sweeps = 32
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    perms = col_update.make_sweep_perms(sub, K, sweeps)

    @jax.jit
    def reference(XtX, Xty, F):
        b, _ = feature_sign_batched(XtX, Xty, F, LAM, ALPHA, 48)
        b, _, _ = col_update.elastic_net_cd(
            XtX, Xty, b, LAM, ALPHA, tol, jax.random.PRNGKey(0),
            max_sweeps=sweeps, use_strong_rule=False)
        return b

    @jax.jit
    def kernel(XtX, Xty, F):
        return feature_sign_triton(XtX, Xty, F, LAM, ALPHA, tol, perms,
                                   max_outer=48, polish_sweeps=sweeps)[0]

    def timed(fn):
        jax.block_until_ready(fn(XtX, Xty, F))
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(XtX, Xty, F))
            best = min(best, time.perf_counter() - t0)
        return np.asarray(out, np.float64), best

    with jax.default_matmul_precision("highest"):
        b_ref, t_ref = timed(reference)
        b_k, t_k = timed(kernel)
    G = np.asarray(XtX, np.float64)
    y = np.asarray(Xty, np.float64)

    def objective(B):
        q = (0.5 * np.einsum("km,mkl,lm->m", B, G, B)
             - np.einsum("km,km->m", y, B))
        return (q + LAM * (1 - ALPHA) / 2 * (B * B).sum(0)
                + LAM * ALPHA * np.abs(B).sum(0))

    o_ref, o_k = objective(b_ref), objective(b_k)
    gap = float(np.max((o_k - o_ref) / np.maximum(np.abs(o_ref), 1.0)))
    zdiff = int(np.sum(np.any((b_k == 0) != (b_ref == 0), axis=0)))
    check(gap <= KERNEL_OBJ_RTOL, f"objective gap {gap:.3e}")
    check(zdiff <= KERNEL_ZERO_PATTERN_FRAC * N_COLS,
          f"{zdiff} columns differ in zero pattern")
    return (f"M={N_COLS} K={K}: max rel objective gap {gap:.3e} "
            f"(tol {KERNEL_OBJ_RTOL:g}), zero pattern differs in {zdiff} "
            f"columns (tol {int(KERNEL_ZERO_PATTERN_FRAC * N_COLS)}), "
            f"kernel {t_k * 1e3:.3f} ms vs XLA {t_ref * 1e3:.3f} ms")


def oracle_phase():
    import jax

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracles

    import insider_tpu as it
    from insider_tpu.config import FitConfig
    from insider_tpu.model.state import init_state
    from insider_tpu.train import als

    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=40,
                                   latent_dim=3, seed=7,
                                   with_interaction=True)
    import numpy as np

    ctns = np.random.default_rng(8).normal(size=(sim.data.shape[0], 2))
    obj = it.Insider(sim.data, sim.confounder, ctns_confounder=ctns,
                     interaction_idx=(0, 1), split_ratio=0.1)
    problem = obj.tuning_problem()
    out = []
    for solver, tail_from in (("fss", 40), ("cd", 0)):
        cfg = FitConfig(latent_dim=3, lambda1=2.0, lambda2=2.0, alpha=0.4,
                        masked=True, max_iter=50, global_tol=0.0,
                        col_solver=solver, cd_warm_start=False)

        def state0():
            return init_state(jax.random.PRNGKey(cfg.seed), problem.n_levels,
                              problem.shape[1], 3, n_ctns=2,
                              init_std=cfg.init_std)

        s0 = state0()
        ref = oracles.reference_optimize(
            np.asarray(problem.data), np.asarray(problem.train_mask),
            np.asarray(problem.test_mask),
            [np.asarray(c) for c in problem.codes], list(problem.n_levels),
            np.asarray(s0.column_factor),
            [np.asarray(f) for f in s0.cfd_factors], 2.0, 2.0, 0.4,
            max_iter=50, global_tol=0.0, sub_tol=cfg.sub_tol,
            ctns=np.asarray(problem.ctns), W0=np.asarray(s0.ctns_factor),
            masked=True)
        res = als.optimize(problem, cfg, state=state0(), verbose=False)
        o_by_iter = {h["iter"]: h for h in ref["history"]}
        gap = 0.0
        for h in res.history:
            o = o_by_iter.get(h["iter"])
            if o is None or h["iter"] < tail_from:
                continue
            for fld in ("loss", "train_rmse", "test_rmse"):
                gap = max(gap, abs(h[fld] - o[fld]) / abs(o[fld]))
        check(gap <= ORACLE_RTOL[solver],
              f"{solver}: gap {gap:.3e} > {ORACLE_RTOL[solver]:g}")
        out.append(f"{solver}: max rel gap {gap:.3e} "
                   f"(CPU tolerance {ORACLE_RTOL[solver]:g})")
    return "; ".join(out)


def four_card_phase(seed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import insider_tpu as it
    from insider_tpu.config import ShardingConfig
    from insider_tpu.train import als

    data, conf = flagship_data(seed)
    # A mesh places equal shards only (sharding/mesh.check_divisible):
    # drop one sample and one gene, 377 x 44477 -> 376 x 44476.
    data, conf = data[:N_ROWS - N_ROWS % 2, :N_COLS - N_COLS % 4], \
        conf[:N_ROWS - N_ROWS % 2]
    max_iter = 20
    fits = {}
    for mesh in (None, (1, 4), (2, 2)):
        sharding = None if mesh is None else ShardingConfig(*mesh)
        obj = it.Insider(data, conf, interaction_idx=[0, 1],
                         split_ratio=0.1, seed=seed, sharding=sharding)
        obj.fit(K, LAM, ALPHA, partition=1, max_iter=max_iter,
                verbose=False)                       # compiles
        t0 = time.perf_counter()
        obj.fit(K, LAM, ALPHA, partition=1, max_iter=max_iter,
                verbose=False)
        fits[mesh] = (obj, time.perf_counter() - t0)

    # placement: the distributed build puts one shard on each card
    split = fits[None][0].split
    x = np.asarray(split.data, np.float32)
    tr = np.asarray(split.train_indicator, np.uint8)
    codes = [np.unique(conf[:, c], return_inverse=True)[1].astype(np.int32)
             for c in range(conf.shape[1])]
    prob = als.build_problem_distributed(
        data=lambda idx: x[idx], train_indicator=lambda idx: tr[idx],
        test_indicator=lambda idx: tr[idx],
        codes=[(lambda c: (lambda idx: c[idx]))(c) for c in codes],
        n_levels=tuple(len(np.unique(conf[:, c]))
                       for c in range(conf.shape[1])),
        global_shape=x.shape, sharding=ShardingConfig(2, 2),
        mask_dtype=jnp.uint8)
    placed = {s.device for s in prob.arrays.data.addressable_shards}
    in_use = [(d.memory_stats() or {}).get("bytes_in_use", 0)
              for d in jax.devices()[:4]]

    def gap(F, F1):
        return float(np.max(np.abs(F - F1)) / np.max(np.abs(F1)))

    ref, t_ref = fits[None]
    l_ref = [h["loss"] for h in ref.fit_result.history]
    rows = {}
    out = [f"{x.shape[0]}x{x.shape[1]}: single card "
           f"{t_ref / max_iter * 1e3:.2f} ms/iter"]
    for mesh in ((1, 4), (2, 2)):
        obj, steady = fits[mesh]
        losses = [h["loss"] for h in obj.fit_result.history]
        lgap = max(abs(a - b) / abs(b) for a, b in zip(losses, l_ref))
        F, F1 = obj.column_factor, ref.column_factor
        fgap = gap(F, F1) if F.shape == F1.shape else float("inf")
        rows[mesh] = (len(losses), lgap, fgap, F.shape)
        frob = float(np.linalg.norm(F - F1) / np.linalg.norm(F1))
        out.append(
            f"mesh {mesh}: max loss gap over {len(losses)} boundaries "
            f"{lgap:.3e} (tol {MESH_LOSS_RTOL:g}), column factor "
            f"max|dF|/max|F| {fgap:.3e} (tol {MESH_FACTOR_RTOL:g}), "
            f"|dF|_F/|F|_F {frob:.3e}, {steady / max_iter * 1e3:.2f} ms/iter")
    out.append(f"distributed build placed shards on {sorted(str(d) for d in placed)}, "
               f"bytes in use per card {in_use}")
    print("four-card detail: " + "; ".join(out), flush=True)

    check(len(placed) == 4 and all(d.platform == "gpu" for d in placed),
          f"data shards on {placed}")
    check(all(b > x.nbytes // 8 for b in in_use),
          f"bytes in use per card {in_use}")
    for mesh, (n, lgap, fgap, shape) in rows.items():
        check(n == len(l_ref), f"{mesh}: {n} boundaries vs {len(l_ref)}")
        check(shape == ref.column_factor.shape, f"{mesh}: shape {shape}")
        check(lgap <= MESH_LOSS_RTOL, f"{mesh}: loss gap {lgap:.3e}")
        check(fgap <= MESH_FACTOR_RTOL, f"{mesh}: factor gap {fgap:.3e}")
    return "sharded fits match the single card"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded fits")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "insider_tpu")):
        print("chip_smoke.py must run from the insider-tpu repository "
              f"(no insider_tpu/ beside it in {REPO})", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from insider_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    import jax

    n_cards = 4 if args.four_cards else 1
    state = {}
    try:
        phase("device", device_phase, n_cards)
        if args.four_cards:
            phase("four cards", four_card_phase, args.seed)
        else:
            phase("flagship fit", fit_phase, state, args.seed)
            phase("dense + cd", dense_cd_phase, state)
            phase("tune", tune_phase, state)
            phase("cli", cli_phase, args.seed)
            phase("kernel vs reference", kernel_phase, state)
            phase("f64 oracle", oracle_phase)
    except PhaseFailed:
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
