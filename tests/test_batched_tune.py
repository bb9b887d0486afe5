"""Device-batched tuning vs serial trials."""

import numpy as np
import pytest

import insider_tpu as it
from insider_tpu.tune.batched import run_batched_trials
from insider_tpu.tune.grid import _run_trial


@pytest.fixture(scope="module")
def small():
    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=40,
                                   latent_dim=3, seed=0,
                                   with_interaction=False)
    obj = it.Insider(sim.data, sim.confounder, split_ratio=0.1,
                     tuning_iter=20)
    return obj, obj.tuning_problem()


@pytest.mark.parametrize("col_solver", ["fss", "cd"])
def test_batched_matches_serial(small, col_solver):
    """Batched and serial trials must agree PER SOLVER (the batched tuner
    once silently ran fss while the docstring claimed cd)."""
    obj, problem = small
    grid = [(0.5, 0.3), (2.0, 0.3), (1.0, 0.8)]
    seeds = [11, 12, 13]
    batched = run_batched_trials(problem, 3, grid, tuning_iter=20,
                                 global_tol=obj.params["global_tol"],
                                 sub_tol=obj.params["sub_tol"], seeds=seeds,
                                 col_solver=col_solver)
    for (lam, al), seed, b in zip(grid, seeds, batched):
        serial = _run_trial(problem, obj, 3, lam, al, trial_seed=seed,
                            tuning_iter=20, col_solver=col_solver)
        assert b["train_rmse"] == pytest.approx(serial.train_rmse, rel=2e-2)
        assert b["test_rmse"] == pytest.approx(serial.test_rmse, rel=2e-2)


def test_padded_rank_coords_stay_exactly_zero(small):
    """pad_state_rank's invariant: padded coordinates are exact fixed points
    of the ALS updates (row ridge decouples them; column update sees
    Xty == 0)."""
    import jax
    import jax.numpy as jnp
    from insider_tpu.config import FitConfig
    from insider_tpu.model.state import init_state
    from insider_tpu.train import als
    from insider_tpu.tune.batched import pad_state_rank

    obj, problem = small
    st = pad_state_rank(
        init_state(jax.random.PRNGKey(3), problem.n_levels,
                   problem.shape[1], 3), 6)
    cfg = FitConfig(latent_dim=6, lambda1=0.5, lambda2=0.5, alpha=0.3,
                    masked=True, use_pallas=False)
    ss = als.StepStatics.from_config(cfg)
    hy = als.Hypers(jnp.float32(0.5), jnp.float32(0.5), jnp.float32(0.3))
    out = als._run_steps(problem.arrays, problem.statics, ss, hy, st,
                         jnp.float32(1e-5), jnp.int32(4))
    assert np.all(np.asarray(out.column_factor)[3:] == 0.0)
    for f in out.cfd_factors:
        assert np.all(np.asarray(f)[:, 3:] == 0.0)


def test_batched_rank_sweep_matches_serial(small):
    from insider_tpu.tune.batched import run_batched_rank_trials

    obj, problem = small
    ranks, seeds = [2, 3, 4], [obj.seed + i for i in range(3)]
    batched = run_batched_rank_trials(
        problem, ranks, lam=0.1, alpha=0.0, tuning_iter=20,
        global_tol=obj.params["global_tol"], sub_tol=obj.params["sub_tol"],
        seeds=seeds)
    for r, seed, b in zip(ranks, seeds, batched):
        serial = _run_trial(problem, obj, r, 0.1, 0.0, trial_seed=seed,
                            tuning_iter=20)
        assert b["rank"] == r
        assert b["train_rmse"] == pytest.approx(serial.train_rmse, rel=2e-2)
        assert b["test_rmse"] == pytest.approx(serial.test_rmse, rel=2e-2)


def test_tune_api_batched_rank_csv(small, tmp_path):
    obj, _ = small
    res = obj.tune(latent_dimension=[2, 3, 4], lambda_=1.0, alpha=0.3,
                   out_dir=str(tmp_path))
    assert res["rank_tuning"].shape == (3, 3)
    assert (tmp_path / "insider_rank_tuning_result.csv").exists()
    assert res["latent_rank"] in (2, 3, 4)


def test_tune_api_batched_csv(small, tmp_path):
    obj, _ = small
    res = obj.tune(latent_dimension=3, lambda_=[0.5, 1.0], alpha=[0.3, 0.6],
                   out_dir=str(tmp_path))
    assert res["reg_tuning"].shape == (4, 4)
    assert (tmp_path / "insider_R3_reg_tuning_result.csv").exists()
    # grid order: lambda fastest (R expand.grid)
    lams = res["reg_tuning"][:, 0]
    assert list(lams) == [0.5, 1.0, 0.5, 1.0]
