"""The Triton feature-sign kernel (kernels/fss_triton.py) in interpret mode.

The kernel runs ops/fss.feature_sign_batched and the plain-CD polish of
ops/col_update.elastic_net_cd step for step, with the same coordinate
orders, so in interpret mode it must match the jnp reference to f32
rounding on every case below: K not a power of two, M not a multiple of
the block, the shared (dense) gram, the polish on and off, and the outer
step cap.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from insider_tpu.kernels import fss_triton
from insider_tpu.kernels.fss_triton import feature_sign_triton
from insider_tpu.ops import col_update
from insider_tpu.ops.col_update import elastic_net_cd, make_sweep_perms
from insider_tpu.ops.fss import feature_sign_batched

kernel = partial(feature_sign_triton, interpret=True)


def _problem(K, M, seed=0, N=60, shared=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, K))
    XtX = np.einsum("nk,nl->kl", X, X)[None].repeat(1 if shared else M, 0)
    if not shared:
        XtX = XtX + rng.normal(size=(M, K, K)) * 0.01
        XtX = (XtX + XtX.transpose(0, 2, 1)) / 2
    Xty = X.T @ (rng.normal(size=(N, M)) * 2)
    beta0 = rng.normal(size=(K, M)) * 0.1
    return (jnp.asarray(XtX, jnp.float32), jnp.asarray(Xty, jnp.float32),
            jnp.asarray(beta0, jnp.float32))


def _objective(B, XtX, Xty, lam, alpha):
    B, G, y = (np.asarray(a, np.float64) for a in (B, XtX, Xty))
    G = np.broadcast_to(G, (B.shape[1],) + G.shape[-2:])
    q = 0.5 * np.einsum("km,mkl,lm->m", B, G, B) - np.einsum("km,km->m", y, B)
    return (q + lam * (1 - alpha) / 2 * np.sum(B * B, 0)
            + lam * alpha * np.sum(np.abs(B), 0))


def _assert_same(bk, bj, XtX, Xty, lam, alpha):
    np.testing.assert_allclose(np.asarray(bk), np.asarray(bj), atol=2e-5)
    ok = _objective(bk, XtX, Xty, lam, alpha)
    oj = _objective(bj, XtX, Xty, lam, alpha)
    assert float(np.max(np.abs(ok - oj) / np.maximum(np.abs(oj), 1.0))) < 1e-6


def test_kkt_rtol_matches_reference():
    import inspect

    default = inspect.signature(feature_sign_batched).parameters["kkt_rtol"]
    assert fss_triton.KKT_RTOL == default.default


@pytest.mark.parametrize("alpha", [0.3, 0.7, 1.0])
@pytest.mark.parametrize("K", [3, 8, 24, 48])
def test_kernel_matches_fss(K, alpha):
    M = 29 if K == 48 else 41
    XtX, Xty, beta0 = _problem(K, M, seed=K)
    lam = 3.0
    bj, oj = feature_sign_batched(XtX, Xty, beta0, lam, alpha, max_outer=64)
    bk, ok = kernel(XtX, Xty, beta0, lam, alpha, 0.0, None, max_outer=64)
    _assert_same(bk, bj, XtX, Xty, lam, alpha)
    assert int(ok) == int(oj)


@pytest.mark.parametrize("sweeps", [4, 32])
@pytest.mark.parametrize("K", [3, 8, 24])
def test_kernel_polish_matches_elastic_net_cd(K, sweeps):
    XtX, Xty, beta0 = _problem(K, 37, seed=100 + K)
    lam, alpha, tol = 2.0, 0.5, jnp.float32(1e-9)
    key = jax.random.PRNGKey(K)
    bj, _ = feature_sign_batched(XtX, Xty, beta0, lam, alpha, max_outer=48)
    bj, _, _ = elastic_net_cd(XtX, Xty, bj, lam, alpha, tol, key,
                              max_sweeps=sweeps, use_strong_rule=False)
    _, sub = jax.random.split(key)
    perms = make_sweep_perms(sub, K, sweeps)
    bk, _ = kernel(XtX, Xty, beta0, lam, alpha, tol, perms, max_outer=48,
                   polish_sweeps=sweeps)
    _assert_same(bk, bj, XtX, Xty, lam, alpha)


@pytest.mark.parametrize("block", [1, 2, 4, 8])
def test_tail_block_columns(block):
    # M = 37 is a multiple of no block but 1: the padded columns of the last
    # block must neither be written nor disturb the real ones.
    XtX, Xty, beta0 = _problem(6, 37, seed=block)
    lam, alpha = 2.0, 0.5
    bj, _ = feature_sign_batched(XtX, Xty, beta0, lam, alpha, max_outer=48)
    bk, _ = kernel(XtX, Xty, beta0, lam, alpha, 0.0, None, max_outer=48,
                   block=block)
    _assert_same(bk, bj, XtX, Xty, lam, alpha)


@pytest.mark.parametrize("polish", [0, 16])
def test_shared_gram_matches_broadcast(polish):
    XtX, Xty, beta0 = _problem(5, 33, seed=12, shared=True)
    lam, alpha, tol = 2.0, 0.6, jnp.float32(1e-8)
    key = jax.random.PRNGKey(4)
    bj, _ = feature_sign_batched(XtX, Xty, beta0, lam, alpha, max_outer=48)
    if polish:
        bj, _, _ = elastic_net_cd(XtX, Xty, bj, lam, alpha, tol, key,
                                  max_sweeps=polish, use_strong_rule=False)
    perms = make_sweep_perms(jax.random.split(key)[1], 5, max(polish, 1))
    bk, _ = kernel(XtX[0], Xty, beta0, lam, alpha, tol, perms, max_outer=48,
                   polish_sweeps=polish)
    _assert_same(bk, bj, XtX, Xty, lam, alpha)


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_max_outer_cap(cap):
    # From a cold start most columns need several outer steps: the cap
    # stops kernel and reference at the same iterate.
    XtX, Xty, _ = _problem(8, 33, seed=21)
    beta0 = jnp.zeros_like(Xty)
    lam, alpha = 1.0, 0.5
    bj, oj = feature_sign_batched(XtX, Xty, beta0, lam, alpha, max_outer=cap)
    bk, ok = kernel(XtX, Xty, beta0, lam, alpha, 0.0, None, max_outer=cap)
    np.testing.assert_allclose(np.asarray(bk), np.asarray(bj), atol=2e-5)
    assert int(ok) == int(oj) == cap


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route the column update's kernel call through interpret mode."""
    monkeypatch.setattr(fss_triton, "feature_sign_triton", kernel)


@pytest.mark.parametrize("solver", ["fss", "cd"])
@pytest.mark.parametrize("masked", [True, False])
def test_column_update_kernel_dispatch(interpret_kernel, masked, solver):
    """update_columns_*(use_pallas=True) == the jnp path, key included."""
    rng = np.random.default_rng(8)
    N, K, M = 40, 5, 96
    R = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    data = jnp.asarray(rng.standard_normal((N, M)), jnp.float32)
    F0 = jnp.asarray(rng.standard_normal((K, M)) * 0.01, jnp.float32)
    kw = dict(lam=1.5, alpha=0.4, tol=jnp.float32(1e-9),
              key=jax.random.PRNGKey(2), max_sweeps=40, solver=solver,
              max_fss_polish_sweeps=32)
    if masked:
        mask = jnp.asarray(rng.random((N, M)) > 0.15, jnp.uint8)
        run = partial(col_update.update_columns_masked, data, mask, R, F0)
    else:
        run = partial(col_update.update_columns_dense, data, R, F0)
    Fa, key_a, _ = run(use_pallas=True, **kw)
    Fb, key_b, _ = run(use_pallas=False, **kw)
    np.testing.assert_allclose(np.asarray(Fa), np.asarray(Fb), atol=2e-5)
    np.testing.assert_array_equal(np.asarray(key_a), np.asarray(key_b))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [8, 24])
def test_compiled_kernel_matches_fss(gpu, K):
    """The kernel as compiled for the card (no interpret mode)."""
    XtX, Xty, beta0 = _problem(K, 1000, seed=K)
    lam, alpha = 3.0, 0.5
    with jax.default_matmul_precision("highest"):
        bj, _ = feature_sign_batched(XtX, Xty, beta0, lam, alpha,
                                     max_outer=64)
    bk, _ = feature_sign_triton(XtX, Xty, beta0, lam, alpha, 0.0, None,
                                max_outer=64)
    ok = _objective(bk, XtX, Xty, lam, alpha)
    oj = _objective(bj, XtX, Xty, lam, alpha)
    assert float(np.max((ok - oj) / np.maximum(np.abs(oj), 1.0))) < 1e-6
