"""CLI round-trips and checkpoint/resume determinism."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import insider_tpu as it
from insider_tpu.checkpoint import load_checkpoint, save_checkpoint
from insider_tpu.config import FitConfig
from insider_tpu.train import als


def test_checkpoint_roundtrip(tmp_path):
    sim = it.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                   latent_dim=2, seed=0,
                                   with_interaction=False)
    obj = it.Insider(sim.data, sim.confounder, split_ratio=0.1, max_iter=20)
    problem = obj.tuning_problem()
    cfg = FitConfig(latent_dim=2, lambda1=1.0, lambda2=1.0, alpha=0.3,
                    masked=True, max_iter=20)
    ck = str(tmp_path / "state.npz")
    res = als.optimize(problem, cfg, verbose=False, checkpoint_path=ck)
    assert os.path.exists(ck) and os.path.exists(ck + ".json")
    state, meta = load_checkpoint(ck)
    np.testing.assert_array_equal(np.asarray(state.column_factor),
                                  res.column_factor)
    assert meta["iter"] == res.n_iter
    assert meta["loss"] == pytest.approx(res.loss)


def test_resume_continues_not_restarts(tmp_path):
    sim = it.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                   latent_dim=2, seed=1,
                                   with_interaction=False)
    obj = it.Insider(sim.data, sim.confounder, split_ratio=0.1, max_iter=10)
    problem = obj.tuning_problem()
    cfg = FitConfig(latent_dim=2, lambda1=1.0, lambda2=1.0, alpha=0.3,
                    masked=True, max_iter=10, global_tol=0.0)
    ck = str(tmp_path / "state.npz")
    r1 = als.optimize(problem, cfg, verbose=False, checkpoint_path=ck)
    import dataclasses
    cfg2 = dataclasses.replace(cfg, max_iter=30)
    r2 = als.optimize(problem, cfg2, verbose=False, checkpoint_path=ck,
                      resume=True)
    # resumed run starts past the checkpointed iteration
    assert r2.history[1]["iter"] > r1.n_iter
    assert r2.loss <= r1.loss + 1e-9


def test_resume_reproduces_uninterrupted_trajectory(tmp_path):
    """Kill-at-boundary + resume == uninterrupted run, bit for bit.

    The sub_tol decay ladder is part of the trajectory
    (src/optimize.cpp:389-403); the checkpoint persists it, so the resumed run's sub_tol_eff — and hence every subsequent
    boundary loss — matches the uninterrupted run exactly.
    """
    import dataclasses

    sim = it.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                   latent_dim=2, seed=3,
                                   with_interaction=False)
    obj = it.Insider(sim.data, sim.confounder, split_ratio=0.1)
    problem = obj.tuning_problem()
    cfg_full = FitConfig(latent_dim=2, lambda1=1.0, lambda2=1.0, alpha=0.3,
                         masked=True, max_iter=50, global_tol=0.0)
    full = als.optimize(problem, cfg_full, verbose=False)

    # interrupted run: stop at iter 20, checkpoint at every boundary
    ck = str(tmp_path / "state.npz")
    cfg_short = dataclasses.replace(cfg_full, max_iter=20)
    als.optimize(problem, cfg_short, verbose=False, checkpoint_path=ck)
    _, meta = load_checkpoint(ck)
    # the ladder must actually have engaged for this test to mean anything
    assert meta["extra"]["decay"] < 1.0
    resumed = als.optimize(problem, cfg_full, verbose=False,
                           checkpoint_path=ck, resume=True)

    full_by_iter = {h["iter"]: h for h in full.history if h["iter"] >= 0}
    res_by_iter = {h["iter"]: h for h in resumed.history if h["iter"] > 20}
    assert res_by_iter, "resumed run recorded no post-resume boundaries"
    for i, h in res_by_iter.items():
        assert h["loss"] == full_by_iter[i]["loss"], f"iter {i}"
        assert h["decay"] == full_by_iter[i]["decay"], f"iter {i}"
    assert resumed.loss == full.loss


def test_fit_api_knobs(tmp_path):
    """Insider.fit forwards solver/kernel/checkpoint/memory knobs."""
    import jax.numpy as jnp

    sim = it.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                   latent_dim=2, seed=4,
                                   with_interaction=False)
    obj = it.Insider(sim.data, sim.confounder, split_ratio=0.1)
    ck = str(tmp_path / "fit_ck.npz")
    obj.fit(2, 1.0, 0.3, partition=1, verbose=False, col_solver="cd",
            use_pallas=False, checkpoint_path=ck, mask_dtype=jnp.uint8,
            precompute=False, max_iter=20)
    assert os.path.exists(ck) and os.path.exists(ck + ".json")
    assert np.isfinite(obj.fit_result.loss)
    # resume picks up from the checkpoint instead of restarting
    obj2 = it.Insider(sim.data, sim.confounder, split_ratio=0.1)
    obj2.fit(2, 1.0, 0.3, partition=1, verbose=False, col_solver="cd",
             use_pallas=False, checkpoint_path=ck, resume=True,
             max_iter=40)
    assert obj2.fit_result.history[1]["iter"] > 20


CLI_ENV = dict(os.environ,
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))


def _run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "insider_tpu"] + args,
        capture_output=True, text=True, env=CLI_ENV, cwd=str(cwd),
        timeout=300,
    )


def test_cli_simulate_then_fit(tmp_path):
    r = _run_cli(["simulate", "--preset", "insider", "--v1", "6", "--v2",
                  "2", "--cols", "30", "--rank", "2", "--out", "sim.npz"],
                 tmp_path)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["shape"] == [12, 30]

    r = _run_cli(["fit", "--data", "sim.npz", "--rank", "2", "--lam", "1.0",
                  "--alpha", "0.3", "--partition", "1", "--max-iter", "20",
                  "--out", "fitted.npz"], tmp_path)
    assert r.returncode == 0, r.stderr
    meta = json.loads(r.stdout.strip().splitlines()[-1])
    assert np.isfinite(meta["loss"])
    z = np.load(tmp_path / "fitted.npz")
    assert z["column_factor"].shape == (2, 30)
    # 3 discrete confounders (v1, v2, interaction col 2)
    assert {k for k in z.files if k.startswith("factor")} == {
        "factor0", "factor1", "factor2"}


def test_cli_tune_writes_csvs(tmp_path):
    _run_cli(["simulate", "--preset", "insider", "--v1", "5", "--v2", "2",
              "--cols", "25", "--rank", "2", "--out", "sim.npz"], tmp_path)
    r = _run_cli(["tune", "--data", "sim.npz", "--ranks", "2,3",
                  "--lambdas", "0.5,1.0", "--alphas", "0.3",
                  "--tuning-iter", "5"], tmp_path)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["latent_rank"] in (2, 3)
    assert (tmp_path / "insider_rank_tuning_result.csv").exists()
    assert (tmp_path /
            f"insider_R{out['latent_rank']}_reg_tuning_result.csv").exists()
