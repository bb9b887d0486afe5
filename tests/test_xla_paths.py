"""The XLA paths that the GPU runs without a hand-written kernel, against the
f64 numpy oracle: the masked row update, the column grams and Xty, and the
evaluation sums with exact counts."""

import jax.numpy as jnp
import numpy as np
import pytest

import oracles
from insider_tpu.ops import col_update, losses, row_update

LEVELS = (2, 16, 8, 107)


@pytest.fixture(scope="module")
def row_problem():
    rng = np.random.default_rng(0)
    n, m, k = 240, 60, 5
    residual = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.85).astype(np.float64)
    F = rng.standard_normal((k, m))
    R_minus = rng.standard_normal((n, k)) * 0.3
    data = residual + R_minus @ F
    codes = []
    for L in LEVELS:
        c = rng.integers(0, L, n)
        c[:L] = np.arange(L)
        codes.append(c)
    return data, mask, F, R_minus, codes


@pytest.mark.parametrize("v", range(len(LEVELS)))
def test_masked_row_fast_path_matches_oracle(row_problem, v):
    """update_row_factor_masked_fast — the driver's row update at the
    flagship's level structure (2/16/8/107) — against the f64 oracle."""
    data, mask, F, R_minus, codes = row_problem
    L, lam = LEVELS[v], 0.9
    want = oracles.ridge_row_update_masked(data - R_minus @ F, mask, F,
                                           codes[v], L, lam)
    E = row_update.one_hot_levels(jnp.asarray(codes[v], jnp.int32), L)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    mw = jnp.matmul(E.T, f32(mask), precision="highest")
    d = jnp.matmul(E.T, f32(mask * data), precision="highest")
    got = row_update.update_row_factor_masked_fast(
        E, mw, d, f32(mask), f32(R_minus), f32(F), lam)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mask_dtype", [jnp.uint8, jnp.float32])
def test_col_gram_and_xty_match_f64(mask_dtype):
    rng = np.random.default_rng(1)
    n, m, k = 50, 70, 6
    R = rng.standard_normal((n, k))
    data = rng.standard_normal((n, m))
    mask = rng.random((n, m)) < 0.8
    mask_d = jnp.asarray(mask, mask_dtype)
    mask_f = mask_d.astype(jnp.float32)
    got = col_update.col_gram_masked(jnp.asarray(R, jnp.float32), mask_f)
    want = np.einsum("nm,nk,nl->mkl", mask, R, R)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)
    xty = jnp.matmul(jnp.asarray(R.T, jnp.float32),
                     mask_f * jnp.asarray(data, jnp.float32),
                     precision="highest")
    np.testing.assert_allclose(np.asarray(xty), R.T @ (mask * data),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mask_dtype", [jnp.uint8, jnp.float32])
def test_eval_counts_exact_above_2_pow_24(mask_dtype):
    """An f32 sum of the mask loses count at 2^24 + 1; int32 does not."""
    n, m = 4097, 4096                     # 2^24 + 4096 elements
    mask = np.ones((n, m), np.uint8)
    mask[0, :3] = 0                       # 2^24 + 4093 observed
    test = 1 - mask
    ev = losses.evaluate_masked(jnp.zeros((n, m), jnp.float32),
                                jnp.asarray(mask, mask_dtype),
                                jnp.asarray(test, mask_dtype))
    assert ev.n_train.dtype == jnp.int32
    assert int(ev.n_train) == 2**24 + 4093
    assert int(ev.n_test) == 3
    vec = losses.pack_metrics(ev, losses.regularization_sums(
        [jnp.zeros((2, 2))], None, jnp.zeros((2, 2))))
    assert vec.shape == (losses.N_METRICS,)
    got = losses.finalize_metrics_vec(np.asarray(vec), 1.0, 1.0, 0.5, True)
    assert got["train_rmse"] == 0.0 and got["test_rmse"] == 0.0


@pytest.mark.parametrize("count", [0, 1, 2**24 + 1, 2**31 - 1])
def test_metrics_vector_carries_counts_exactly(count):
    z = (jnp.float32(1.0), jnp.float32(0.0))
    ev = losses.EvalSums(z, z, jnp.int32(count), jnp.int32(count // 3))
    reg = losses.LossSums(z, z, z)
    vec = np.asarray(losses.pack_metrics(ev, reg))
    v = vec.astype(np.float64)
    rebuilt = [int(v[i]) * 4096 + int(v[i + 1]) for i in (4, 6)]
    assert rebuilt == [count, count // 3]


def test_dense_eval_counts_every_element():
    ev = losses.evaluate_dense(jnp.ones((30, 7), jnp.float32))
    assert int(ev.n_train) == 210 and int(ev.n_test) == 0
