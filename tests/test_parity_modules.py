"""Inventory-parity modules: utils, prototypes, solver entry points,
continuous v1."""

import jax.numpy as jnp
import numpy as np
import pytest

import oracles
import insider_tpu as it
from insider_tpu import utils
from insider_tpu.ops import continuous, prototypes


def _enet_problem(seed=0, n=50, k=7):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, k))
    y = rng.standard_normal(n) * 2
    return X, y


def test_public_solvers_match_oracle():
    X, y = _enet_problem()
    XtX, Xty = X.T @ X, X.T @ y
    w0 = np.zeros(X.shape[1])
    lam, alpha = 1.0, 0.6
    want = oracles.strong_coordinate_descent(X, y, w0, lam, alpha, XtX, Xty,
                                             tol=1e-12)
    got = it.strong_coordinate_descent(X, y, w0, lam, alpha, tol=1e-10)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    got2 = it.coordinate_descent(X, y, w0, lam, alpha, tol=1e-10)
    np.testing.assert_allclose(got2, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("alpha", [0.4, 1.0])
def test_fista_matches_cd(alpha):
    X, y = _enet_problem(1)
    lam = 1.5
    w0 = np.zeros(X.shape[1])
    cd = oracles.strong_coordinate_descent(X, y, w0, lam, alpha, X.T @ X,
                                           X.T @ y, tol=1e-13)
    fista = prototypes.proximal_gradient(X, y, None, lam, alpha, tol=1e-13,
                                         max_iter=20000)
    np.testing.assert_allclose(fista, cd, rtol=1e-4, atol=1e-6)


def test_feature_sign_matches_cd():
    X, y = _enet_problem(2, n=40, k=5)
    lam, alpha = 2.0, 1.0
    cd = oracles.strong_coordinate_descent(X, y, np.zeros(5), lam, alpha,
                                           X.T @ X, X.T @ y, tol=1e-13)
    fs = prototypes.feature_sign(X, y, lam, alpha)
    np.testing.assert_allclose(fs, cd, rtol=1e-4, atol=1e-6)


def test_continuous_v1_close_to_v2():
    rng = np.random.default_rng(3)
    n, m, k = 40, 30, 5
    resid = rng.standard_normal((n, m))
    mask = (rng.random((n, m)) < 0.8).astype(np.float64)
    F = rng.standard_normal((k, m))
    c = rng.standard_normal(n)
    w0 = rng.standard_normal(k) * 0.01
    v1 = continuous.update_ctns_row_masked_v1(
        jnp.asarray(resid, jnp.float32), jnp.asarray(mask, jnp.float32),
        jnp.asarray(F, jnp.float32), jnp.asarray(c, jnp.float32),
        jnp.asarray(w0, jnp.float32), 1.0, tol=1e-6, max_sweeps=500)
    # exact ridge solution as the ground truth both variants approach
    q = (c**2) @ mask
    XtX = (F * q) @ F.T + np.eye(k)
    b = F @ ((mask * resid).T @ c)
    exact = np.linalg.solve(XtX, b)
    np.testing.assert_allclose(np.asarray(v1), exact, rtol=5e-3, atol=5e-3)


def test_utils_parity():
    # calculate_idx: R column-major 1-based (R/utils.R:27-38)
    assert utils.calculate_idx(1, 5) == (1, 1)
    assert utils.calculate_idx(5, 5) == (5, 1)
    assert utils.calculate_idx(6, 5) == (1, 2)

    assert utils.split_str("AD_x_y_v7_Brain_Cortex") == ("AD", "Brain_Cortex")

    t = np.array([[1.0, -2.0], [np.nan, 0.5]])
    ind = utils.obtain_indication_matrix(t)
    assert ind.tolist() == [[1, -1], [0, 1]]
    ind_pos = utils.obtain_indication_matrix(t, only_positive=True)
    assert ind_pos.tolist() == [[1, 1], [0, 1]]

    m = np.array([[1, 2], [1, 2], [3, 4]])
    assert utils.unique_rows(m).tolist() == [[1, 2], [3, 4]]
    assert utils.find_equal_rows(m, np.array([1, 2])).tolist() == [0, 1]

    assert utils.is_converged(100.0, 100.0 + 1e-7, verbose=False)
    assert not utils.is_converged(100.0, 110.0, verbose=False)

    a = np.ones((2, 3))
    np.testing.assert_array_equal(utils.add_by_column(a, [1, 2, 3]),
                                  [[2, 3, 4], [2, 3, 4]])


def test_dump_and_quit_writes_dump(tmp_path):
    import subprocess, sys, os
    p = tmp_path / "dump.pkl"
    code = (
        "from insider_tpu.utils import dump_and_quit\n"
        f"dump_and_quit({str(repr(str(p)))})\n"
        "raise RuntimeError('boom')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       env=env)
    assert r.returncode == 1
    import pickle
    with open(p, "rb") as fh:
        info = pickle.load(fh)
    assert info["type"] == "RuntimeError" and info["message"] == "boom"
