"""Feature-sign search solver (ops/fss.py + kernels/fss_triton.py).

Validation strategy: FSS must land on the SAME optimum as long-run
coordinate descent (the subproblem is strictly convex), satisfy KKT exactly,
and the Triton kernel must reproduce the jnp reference in interpret mode
(more cases in tests/test_fss_triton.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from insider_tpu.ops.col_update import elastic_net_cd, update_columns_masked
from insider_tpu.ops.fss import feature_sign_batched
from insider_tpu.kernels.fss_triton import feature_sign_triton


def _problem(K=10, M=300, N=70, seed=0, ill=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, K))
    if ill:
        X[:, K // 2:] = (X[:, :K // 2] @ rng.normal(size=(K // 2, K - K // 2))
                         * 0.9 + 0.1 * X[:, K // 2:])
    Y = rng.normal(size=(N, M)) * 2
    XtX = np.einsum("nk,nl->kl", X, X)[None].repeat(M, 0)
    XtX += rng.normal(size=(M, K, K)) * 0.01
    XtX = (XtX + XtX.transpose(0, 2, 1)) / 2
    Xty = X.T @ Y
    beta0 = (rng.normal(size=(K, M)) * 0.1).astype(np.float32)
    return (jnp.asarray(XtX, jnp.float32), jnp.asarray(Xty, jnp.float32),
            jnp.asarray(beta0))


def _objective(B, XtX, Xty, lam, alpha):
    B = np.asarray(B, np.float64)
    XtX = np.asarray(XtX, np.float64)
    Xty = np.asarray(Xty, np.float64)
    q = (0.5 * np.einsum("km,mkl,lm->m", B, XtX, B)
         - np.einsum("km,km->m", Xty, B))
    return (q + lam * (1 - alpha) / 2 * np.sum(B * B, 0)
            + lam * alpha * np.sum(np.abs(B), 0))


@pytest.mark.parametrize("lam,alpha", [(3.0, 0.6), (1.0, 0.3), (5.0, 1.0)])
def test_fss_matches_cd_optimum(lam, alpha):
    XtX, Xty, beta0 = _problem()
    bf, outers = feature_sign_batched(XtX, Xty, beta0, lam, alpha,
                                      max_outer=64)
    bc, _, _ = elastic_net_cd(XtX, Xty, beta0, lam, alpha, jnp.float32(1e-12),
                              jax.random.PRNGKey(0), 3000)
    of = _objective(bf, XtX, Xty, lam, alpha)
    oc = _objective(bc, XtX, Xty, lam, alpha)
    # FSS is exact: never worse than CD beyond f32 noise, usually better.
    # (beta itself can differ more on near-degenerate columns where distinct
    # near-optimal points tie in objective — compare objectives, not iterates.)
    assert float(np.max(of - oc)) < 1e-3
    assert int(outers) < 64
    np.testing.assert_allclose(np.asarray(bf), np.asarray(bc), atol=2e-2)


def test_fss_kkt_conditions():
    XtX, Xty, beta0 = _problem(seed=3)
    lam, alpha = 2.5, 0.5
    bf, _ = feature_sign_batched(XtX, Xty, beta0, lam, alpha)
    B = np.asarray(bf, np.float64)
    grad = (np.einsum("mkl,lm->km", np.asarray(XtX, np.float64), B)
            - np.asarray(Xty, np.float64) + lam * (1 - alpha) * B)
    l1 = lam * alpha
    # inactive: |grad| <= l1 (+ f32 slack); active: grad = -l1 sign(beta)
    scale = np.abs(np.asarray(Xty)).max(axis=0, keepdims=True)
    slack = 2e-4 * (l1 + scale)
    assert (((B == 0) & (np.abs(grad) > l1 + slack)).sum()) == 0
    act_res = np.abs(grad + l1 * np.sign(B))[B != 0]
    assert float(act_res.max()) < 1e-2


def test_fss_exact_zeros_lasso():
    XtX, Xty, beta0 = _problem(seed=5)
    bf, _ = feature_sign_batched(XtX, Xty, beta0, 8.0, 1.0)
    frac0 = float((np.asarray(bf) == 0).mean())
    assert frac0 > 0.2  # strong lasso -> plenty of exact zeros


def test_pallas_kernel_matches_jnp_interpret():
    # Same algorithm step for step; XLA may compile ULP-different arithmetic
    # for the two paths, so compare to tight tolerance + identical
    # objective, not bitwise.
    XtX, Xty, beta0 = _problem(K=12, M=300, seed=1)
    lam, alpha = 3.0, 0.6
    bj, _ = feature_sign_batched(XtX, Xty, beta0, lam, alpha, max_outer=64)
    bp, _ = feature_sign_triton(XtX, Xty, beta0, lam, alpha, 0.0, None,
                                max_outer=64, interpret=True)
    np.testing.assert_allclose(np.asarray(bp), np.asarray(bj), atol=2e-3)
    oj = _objective(bj, XtX, Xty, lam, alpha)
    op = _objective(bp, XtX, Xty, lam, alpha)
    assert float(np.abs(op - oj).max()) < 1e-4


def test_pallas_padding_tail_block():
    # M far from a multiple of the block: padded columns must stay zero.
    XtX, Xty, beta0 = _problem(K=8, M=133, seed=2)
    bp, _ = feature_sign_triton(XtX, Xty, beta0, 2.0, 0.5, 0.0, None,
                                max_outer=48, interpret=True, block=8)
    bj, _ = feature_sign_batched(XtX, Xty, beta0, 2.0, 0.5, max_outer=48)
    np.testing.assert_allclose(np.asarray(bp), np.asarray(bj), atol=2e-3)
    op = _objective(bp, XtX, Xty, 2.0, 0.5)
    oj = _objective(bj, XtX, Xty, 2.0, 0.5)
    assert float(np.abs(op - oj).max()) < 1e-4


@pytest.mark.parametrize("alpha", [0.4, 0.9, 1.0])
@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e6])
def test_fss_kkt_slack_bounded_vs_cd(alpha, kappa):
    """Stress the f32 KKT slack (kkt_rtol=1e-4): over a sweep of Gram
    condition numbers, FSS's objective must never exceed CD-at-tight-tol's
    on ANY column beyond f32 noise — i.e. the slack only ever admits
    sub-resolution coordinates, never a materially sub-optimal sign pattern
    (reference's strict f64 check: coordinate_descent.cpp:118-124)."""
    K, M = 12, 256
    rng = np.random.default_rng(int(kappa) % 7919 + int(alpha * 10))
    # Controlled-conditioning SPD Grams: Q diag(lambda) Q^T with eigenvalues
    # log-spaced over [1/kappa, 1], plus per-column jitter.
    evals = np.logspace(0, -np.log10(kappa), K)
    XtX = np.empty((M, K, K))
    for m in range(M):
        Q, _ = np.linalg.qr(rng.normal(size=(K, K)))
        XtX[m] = (Q * evals) @ Q.T
    Xty = rng.normal(size=(K, M)) * 2
    beta0 = (rng.normal(size=(K, M)) * 0.1).astype(np.float32)
    lam = 0.05  # weak ridge: the hard regime for conditioning
    XtX_j = jnp.asarray(XtX, jnp.float32)
    Xty_j = jnp.asarray(Xty, jnp.float32)

    bf, outers = feature_sign_batched(XtX_j, Xty_j, jnp.asarray(beta0),
                                      lam, alpha, max_outer=128)
    assert int(outers) < 128  # every column converged (no livelock)
    bc, _, _ = elastic_net_cd(XtX_j, Xty_j, jnp.asarray(beta0), lam, alpha,
                              jnp.float32(1e-13), jax.random.PRNGKey(0), 5000)
    of = _objective(bf, XtX, Xty, lam, alpha)
    oc = _objective(bc, XtX, Xty, lam, alpha)
    # Per-column: FSS never worse than CD beyond f32 solve noise, which
    # scales with the column objective magnitude.
    tol = 1e-4 * (1.0 + np.abs(oc))
    worst = float(np.max(of - oc - tol))
    assert worst <= 0.0, (
        f"FSS objective exceeds CD on {int(np.sum(of > oc + tol))} columns; "
        f"worst excess {np.max(of - oc):.3e} (kappa={kappa}, alpha={alpha})"
    )


def test_update_columns_fss_dispatch():
    rng = np.random.default_rng(11)
    N, M, K = 60, 257, 7
    data = jnp.asarray(rng.normal(size=(N, M)), jnp.float32)
    mask = jnp.asarray(rng.random((N, M)) < 0.9, jnp.float32)
    R = jnp.asarray(rng.normal(size=(N, K)), jnp.float32)
    F0 = jnp.asarray(rng.normal(size=(K, M)) * 0.1, jnp.float32)
    lam, alpha = 2.0, 0.4
    F_fss, _, outers = update_columns_masked(
        data, mask, R, F0, lam, alpha, jnp.float32(1e-9),
        jax.random.PRNGKey(0), solver="fss")
    F_cd, _, _ = update_columns_masked(
        data, mask, R, F0, lam, alpha, jnp.float32(1e-11),
        jax.random.PRNGKey(0), max_sweeps=3000, solver="cd")
    np.testing.assert_allclose(np.asarray(F_fss), np.asarray(F_cd), atol=5e-3)
    assert int(outers) > 0


def test_als_with_fss_monotone_and_recovers():
    import insider_tpu as it
    from insider_tpu.config import FitConfig
    from insider_tpu.train import als

    sim = it.simulate_insider_data(seed=0)
    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1)
    problem = als.build_problem(split.data, sim.confounder,
                                split.train_indicator, split.test_indicator,
                                masked=True)
    config = FitConfig(latent_dim=5, lambda1=5.0, lambda2=5.0, alpha=0.6,
                       max_iter=60, col_solver="fss", use_pallas=False)
    res = als.optimize(problem, config, verbose=False)
    losses = [h["loss"] for h in res.history]
    assert all(np.isfinite(losses))
    assert all(b <= a + 1e-6 * abs(a) for a, b in zip(losses, losses[1:]))
    assert res.test_rmse < 1.6  # noise_std=1.0 -> near-oracle RMSE


def test_fss_polish_removes_kkt_slack_excess():
    """update_columns_masked(solver='fss', fss_polish=True) must match the
    tight-tol CD objective on every column — the polish exists to remove the
    f32 KKT-slack excess FSS can leave on ill-scaled columns."""
    rng = np.random.default_rng(11)
    N, K, M = 80, 8, 150
    R = rng.normal(size=(N, K)).astype(np.float32) * 3.0
    data = (rng.normal(size=(N, M)) * 20.0).astype(np.float32)
    mask = (rng.random((N, M)) < 0.9).astype(np.float32)
    F0 = (rng.normal(size=(K, M)) * 0.1).astype(np.float32)
    lam, alpha = 4.0, 0.5
    key = jax.random.PRNGKey(0)

    from insider_tpu.ops.col_update import col_gram_masked

    def run(polish):
        F, _, _ = update_columns_masked(
            jnp.asarray(data), jnp.asarray(mask), jnp.asarray(R),
            jnp.asarray(F0), lam, alpha, jnp.float32(1e-9), key,
            max_sweeps=400, solver="fss", fss_polish=polish)
        return F

    XtX = col_gram_masked(jnp.asarray(R), jnp.asarray(mask))
    Xty = jnp.matmul(R.T, mask * data)
    F_pol = run(True)
    bc, _, _ = elastic_net_cd(XtX, Xty, jnp.asarray(F0), lam, alpha,
                              jnp.float32(1e-12), jax.random.PRNGKey(1),
                              3000)
    o_pol = _objective(F_pol, XtX, Xty, lam, alpha)
    o_cd = _objective(bc, XtX, Xty, lam, alpha)
    scale = np.maximum(np.abs(o_cd), 1.0)
    assert float(np.max((o_pol - o_cd) / scale)) < 1e-5
    # and the polish never makes things worse than raw FSS
    F_raw = run(False)
    o_raw = _objective(F_raw, XtX, Xty, lam, alpha)
    assert float(np.max((o_pol - o_raw) / scale)) < 1e-7


def test_pallas_fused_polish_matches_two_stage():
    """feature_sign_triton(polish_sweeps>0) == the kernel's raw FSS followed
    by plain CD at the same tol and coordinate orders (interpret mode)."""
    from insider_tpu.ops.col_update import make_sweep_perms

    XtX, Xty, beta0 = _problem(K=6, M=40, N=50, seed=5)
    lam, alpha = 2.0, 0.6
    tol = jnp.float32(1e-9)
    key = jax.random.PRNGKey(0)
    perms = make_sweep_perms(jax.random.split(key)[1], 6, 32)
    fused, _ = feature_sign_triton(XtX, Xty, beta0, lam, alpha, tol, perms,
                                   max_outer=48, polish_sweeps=32,
                                   interpret=True)
    raw, _ = feature_sign_triton(XtX, Xty, beta0, lam, alpha, 0.0, None,
                                 max_outer=48, interpret=True)
    two, _, _ = elastic_net_cd(XtX, Xty, raw, lam, alpha, tol, key,
                               max_sweeps=32, use_strong_rule=False)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(two),
                               rtol=1e-5, atol=1e-6)
    o_f = _objective(fused, XtX, Xty, lam, alpha)
    o_r = _objective(raw, XtX, Xty, lam, alpha)
    assert float(np.max(o_f - o_r)) < 1e-6  # polish never hurts


def test_fss_kernel_k48_interpret():
    """The kernel computes the right answer at K=48 (padded to 64)."""
    XtX, Xty, beta0 = _problem(K=48, M=150, N=80, seed=7)
    lam, alpha = 3.0, 0.5
    bj, _ = feature_sign_batched(XtX, Xty, beta0, lam, alpha, max_outer=64)
    bp, _ = feature_sign_triton(XtX, Xty, beta0, lam, alpha, 0.0, None,
                                max_outer=64, interpret=True)
    np.testing.assert_allclose(np.asarray(bp), np.asarray(bj), atol=2e-3)
    op = _objective(bp, XtX, Xty, lam, alpha)
    oj = _objective(bj, XtX, Xty, lam, alpha)
    assert float(np.abs(op - oj).max()) < 1e-4


def test_fss_shared_gram_matches_streamed():
    """Dense path: the kernel fed one shared (K, K) gram (incl. the fused
    polish) matches it fed the broadcast (M, K, K) tensor."""
    from insider_tpu.ops.col_update import make_sweep_perms

    rng = np.random.default_rng(12)
    N, K, M = 60, 6, 700
    R = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    data = jnp.asarray(rng.standard_normal((N, M)), jnp.float32)
    XtX = jnp.matmul(R.T, R, precision=jax.lax.Precision.HIGHEST)
    Xty = jnp.matmul(R.T, data, precision=jax.lax.Precision.HIGHEST)
    beta0 = jnp.asarray(rng.standard_normal((K, M)) * 0.01, jnp.float32)
    perms = make_sweep_perms(jax.random.PRNGKey(3), K, 16)
    kw = dict(max_outer=48, polish_sweeps=16, interpret=True, block=4)
    a, _ = feature_sign_triton(jnp.broadcast_to(XtX, (M, K, K)), Xty, beta0,
                               2.0, 0.5, 1e-8, perms, **kw)
    b, _ = feature_sign_triton(XtX, Xty, beta0, 2.0, 0.5, 1e-8, perms, **kw)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                               atol=1e-5)
