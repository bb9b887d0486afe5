"""Sharded against unsharded on the 8 virtual CPU devices, every mesh shape.

The driver's XLA path (GSPMD inserts the collectives) for masked and dense
problems, and the Triton column-solve kernel under shard_map over 'cols'
(interpret mode), must reproduce the single-device result up to f32
reduction order (the psums add in another order than one device does).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import insider_tpu as it
from insider_tpu.config import FitConfig, ShardingConfig
from insider_tpu.kernels import fss_triton
from insider_tpu.model.state import init_state
from insider_tpu.ops import col_update
from insider_tpu.sharding.mesh import make_mesh
from insider_tpu.train import als

MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]
N, M, K = 16, 64, 3


def _steps(masked, sharding):
    sim = it.simulate_scale(N, M, K, level_counts=(2, 5), seed=3)
    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1)
    problem = als.build_problem(
        split.data, sim.confounder, split.train_indicator,
        split.test_indicator, masked=masked, sharding=sharding,
        mask_dtype=jnp.uint8)
    cfg = FitConfig(latent_dim=K, lambda1=1.0, lambda2=1.0, alpha=0.4,
                    masked=masked)
    state = init_state(jax.random.PRNGKey(1), problem.n_levels, M, K)
    hy = als.Hypers(jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.4))
    st = als._run_steps(problem.arrays, problem.statics,
                        als.StepStatics.from_config(cfg), hy, state,
                        jnp.float32(1e-5), jnp.int32(2))
    ev, _ = als._evaluate(problem.arrays, problem.statics, st)
    return st, ev


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mesh", MESHES)
def test_driver_steps_sharded_match_single_device(mesh, masked):
    ref, ev_ref = _steps(masked, None)
    shd, ev = _steps(masked, ShardingConfig(*mesh))
    np.testing.assert_allclose(np.asarray(shd.column_factor),
                               np.asarray(ref.column_factor),
                               rtol=2e-4, atol=2e-5)
    for a, b in zip(shd.cfd_factors, ref.cfd_factors):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)
    assert int(ev.n_train) == int(ev_ref.n_train)
    assert float(ev.train_sse[0]) == pytest.approx(float(ev_ref.train_sse[0]),
                                                   rel=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_kernel_column_update_under_shard_map(mesh, monkeypatch):
    monkeypatch.setattr(fss_triton, "feature_sign_triton",
                        partial(fss_triton.feature_sign_triton,
                                interpret=True))
    rng = np.random.default_rng(5)
    R = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    data = jnp.asarray(rng.standard_normal((N, M)), jnp.float32)
    mask = jnp.asarray(rng.random((N, M)) > 0.2, jnp.float32)
    F0 = jnp.asarray(rng.standard_normal((K, M)) * 0.01, jnp.float32)
    kw = dict(lam=1.0, alpha=0.4, tol=jnp.float32(1e-9),
              key=jax.random.PRNGKey(0), solver="fss")
    F_ref, _, _ = col_update.update_columns_masked(data, mask, R, F0,
                                                   use_pallas=False, **kw)
    mesh_ = make_mesh(ShardingConfig(*mesh))
    F, _, outers = jax.jit(partial(col_update.update_columns_masked,
                                   use_pallas=True, mesh=mesh_, **kw))(
        data, mask, R, F0)
    np.testing.assert_allclose(np.asarray(F), np.asarray(F_ref), atol=2e-5)
    assert int(outers) >= 1


def test_uneven_mesh_is_refused():
    with pytest.raises(ValueError, match="divisible"):
        _steps(True, ShardingConfig(1, 3))
