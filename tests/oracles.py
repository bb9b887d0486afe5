"""Float64 numpy transliterations of the reference algorithms.

These are executable specs of the C++ kernels (the same role
R/optimization_functions.R played for the reference authors, SURVEY.md §4)
used as test oracles.  They follow the reference control flow step by step —
including per-column randperm sweeps — but run in numpy float64.
"""

from __future__ import annotations

import numpy as np


def cd_loss(residual, beta, lam, alpha):
    """compute_loss (src/utils.cpp:46-49)."""
    return (
        0.5 * np.sum(residual**2)
        + 0.5 * (1 - alpha) * lam * np.sum(beta**2)
        + alpha * lam * np.sum(np.abs(beta))
    )


def coordinate_descent(X, y, wstart, lam, alpha, XtX, Xty, tol=1e-5, rng=None,
                       max_sweeps=10_000):
    """Plain CD (src/coordinate_descent.cpp:11-54), UB on first pre_loss
    replaced by an always-run-first-sweep rule."""
    rng = rng or np.random.default_rng(0)
    beta = wstart.astype(np.float64).copy()
    residual = y - X @ beta
    iter_loss = np.inf
    for _ in range(max_sweeps):
        pre_loss = iter_loss
        for k in rng.permutation(beta.size):
            u = residual @ X[:, k] + beta[k] * XtX[k, k]
            if abs(u) > lam * alpha:
                w = np.sign(u) * max(abs(u) - lam * alpha, 0.0) / (
                    XtX[k, k] + lam * (1 - alpha)
                )
            else:
                w = 0.0
            if w != beta[k]:
                residual -= (w - beta[k]) * X[:, k]
                beta[k] = w
        iter_loss = cd_loss(residual, beta, lam, alpha)
        if abs(pre_loss - iter_loss) <= tol:
            break
    return beta


def strong_coordinate_descent(X, y, wstart, lam, alpha, XtX, Xty, tol=1e-5,
                              rng=None, max_sweeps=10_000):
    """Strong-rule CD with KKT reactivation (src/coordinate_descent.cpp:57-127)."""
    rng = rng or np.random.default_rng(0)
    beta = wstart.astype(np.float64).copy()
    active = np.ones(beta.size, bool)
    ex = np.abs(Xty) < alpha * (2 * lam - np.max(np.abs(Xty)))
    active[ex] = False
    beta[ex] = 0.0
    residual = y - X @ beta
    iter_loss = cd_loss(residual, beta, lam, alpha)

    while True:
        inc = np.flatnonzero(active)
        exc = np.flatnonzero(~active)
        for _ in range(max_sweeps):
            pre_loss = iter_loss
            for i in rng.permutation(inc.size):
                k = inc[i]
                u = residual @ X[:, k] + beta[k] * XtX[k, k]
                if abs(u) > lam * alpha:
                    w = np.sign(u) * max(abs(u) - lam * alpha, 0.0) / (
                        XtX[k, k] + lam * (1 - alpha)
                    )
                else:
                    w = 0.0
                if w != beta[k]:
                    residual -= (w - beta[k]) * X[:, k]
                    beta[k] = w
            iter_loss = cd_loss(residual, beta, lam, alpha)
            if abs(pre_loss - iter_loss) <= tol:
                break
        grad = XtX[np.ix_(exc, inc)] @ beta[inc] - Xty[exc]
        violated = np.abs(grad) > alpha * lam
        if not violated.any():
            break
        active[exc[violated]] = True
    return beta


def ridge_row_update_masked(residual, mask, F, codes, n_levels, lam):
    """optimize_row masked path (src/optimize.cpp:150-176), direct form."""
    K = F.shape[0]
    V = np.zeros((n_levels, K))
    for l in range(n_levels):
        ids = np.flatnonzero(codes == l)
        XtX = np.zeros((K, K))
        Xty = np.zeros(K)
        for i in ids:
            w = mask[i].astype(np.float64)
            XtX += (F * w) @ F.T
            Xty += F @ (w * residual[i])
        V[l] = np.linalg.solve(XtX + lam * np.eye(K), Xty)
    return V


def ridge_row_update_dense(residual, F, codes, n_levels, lam):
    """optimize_row dense path (src/optimize.cpp:178-191)."""
    K = F.shape[0]
    gram = F @ F.T
    V = np.zeros((n_levels, K))
    for l in range(n_levels):
        ids = np.flatnonzero(codes == l)
        XtX = len(ids) * gram + lam * np.eye(K)
        Xty = F @ residual[ids].sum(axis=0)
        V[l] = np.linalg.solve(XtX, Xty)
    return V


def ctns_update_masked(resid_plus, mask, F, c, w0, lam, tol=1e-1,
                       max_sweeps=1000):
    """optimize_continuous_v2 masked path (src/optimize.cpp:80-126)."""
    K = F.shape[0]
    w = w0.astype(np.float64).copy()
    resid = resid_plus - np.outer(c, w @ F)
    for _ in range(max_sweeps):
        pre = w.copy()
        for k in range(K):
            resid += np.outer(c, w[k] * F[k])
            XtX = np.sum((c**2)[:, None] * mask * (F[k] ** 2)[None, :])
            Xty = c @ ((mask * resid) @ F[k])
            w[k] = Xty / (XtX + lam)
            resid -= np.outer(c, w[k] * F[k])
        if np.sum(np.abs(pre - w)) < tol:
            break
    return w


def reference_optimize(data, mask, test_mask, codes_list, n_levels, F0,
                       cfd0, lam1, lam2, alpha, max_iter=50,
                       global_tol=1e-10, sub_tol=1e-5, ctns=None, W0=None,
                       masked=True, rng_seed=0):
    """END-TO-END f64 transliteration of the reference ALS driver
    (src/optimize.cpp:256-422): the independent implementation the JAX
    driver's boundary trajectory is pinned against (without an R toolchain,
    a numpy f64 rewrite of the C++ loop is the strongest feasible
    cross-check).

    Follows the C++ control flow exactly:
      * initial predict/evaluate/loss before the loop (:320-323);
      * per iteration: gram = F F^T (:332); per-confounder residual
        add-back -> row solve -> subtract, subtraction skipped for the last
        confounder (:335-362); continuous covariates as the last
        pseudo-confounder, per-covariate add-back -> optimize_continuous_v2
        -> subtract except the last (:341-350);
      * row_factor rebuilt from scratch (:365-373);
      * column update against DATA (not the residual) with warm start and
        tol = sub_tol * decay (:376), then residual recompute (:377-379);
      * every-10-iter evaluate + loss + decay ladder + relative stop
        (:381-408).

    Returns a history of boundary records {iter, loss, train_rmse,
    test_rmse, delta_loss, decay} plus the final factors.
    """
    rng = np.random.default_rng(rng_seed)
    data = np.asarray(data, np.float64)
    mask = np.asarray(mask, np.float64)
    test_mask = np.asarray(test_mask, np.float64)
    F = np.asarray(F0, np.float64).copy()
    cfd = [np.asarray(V, np.float64).copy() for V in cfd0]
    W = None if W0 is None else np.asarray(W0, np.float64).copy()
    if ctns is not None:
        ctns = np.asarray(ctns, np.float64)
    N, M = data.shape
    K = F.shape[0]
    n_cfd = len(codes_list)

    def row_factor():
        R = np.zeros((N, K))
        for V, codes in zip(cfd, codes_list):
            R += V[codes]
        if ctns is not None:
            R += ctns @ W
        return R

    def evaluate(residual):
        # src/utils.cpp:56-77
        if masked:
            tr = residual[mask > 0]
            te = residual[test_mask > 0]
            train_rmse = np.sqrt(np.mean(tr**2)) if tr.size else float("nan")
            test_rmse = np.sqrt(np.mean(te**2)) if te.size else float("nan")
            sum_residual = np.sum(tr**2)
        else:
            train_rmse = np.sqrt(np.mean(residual**2))
            test_rmse = float("nan")
            sum_residual = np.sum(residual**2)
        return sum_residual, train_rmse, test_rmse

    def loss_of(sum_residual):
        # src/utils.cpp:79-102
        row_reg = lam1 * sum(np.sum(V**2) for V in cfd)
        if W is not None:
            row_reg += lam1 * np.sum(W**2)
        col_reg = lam2 * (1 - alpha) * np.sum(F**2)
        l1_reg = lam2 * alpha * np.sum(np.abs(F))
        return 0.5 * sum_residual + 0.5 * row_reg + 0.5 * col_reg + l1_reg

    def update_columns(R, tol):
        # optimize_col (src/optimize.cpp:200-253)
        gram = R.T @ R
        if masked:
            for i in range(M):
                sel = mask[:, i] > 0
                Xw = R * mask[:, i:i + 1]
                XtX = Xw.T @ R
                Xty = R[sel].T @ data[sel, i]
                if alpha == 0.0:
                    F[:, i] = np.linalg.solve(XtX + lam2 * np.eye(K), Xty)
                else:
                    F[:, i] = strong_coordinate_descent(
                        R[sel], data[sel, i], F[:, i], lam2, alpha, XtX,
                        Xty, tol=tol, rng=rng)
        else:
            Xty = R.T @ data
            if alpha == 0.0:
                F[:] = np.linalg.solve(gram + lam2 * np.eye(K), Xty)
            else:
                for i in range(M):
                    F[:, i] = strong_coordinate_descent(
                        R, data[:, i], F[:, i], lam2, alpha, gram,
                        Xty[:, i], tol=tol, rng=rng)

    # --- initial eval (:320-323) ---
    residual = data - row_factor() @ F
    sum_residual, train_rmse, test_rmse = evaluate(residual)
    loss = loss_of(sum_residual)
    history = [{"iter": -1, "loss": loss, "train_rmse": train_rmse,
                "test_rmse": test_rmse}]

    decay = 1.0
    it = 0
    while it <= max_iter:
        gram = F @ F.T  # noqa: F841 — cancels in the masked row solve
        for v in range(n_cfd):
            residual += cfd[v][codes_list[v]] @ F
            if masked:
                cfd[v] = ridge_row_update_masked(residual, mask, F,
                                                 codes_list[v], n_levels[v],
                                                 lam1)
            else:
                cfd[v] = ridge_row_update_dense(residual, F, codes_list[v],
                                                n_levels[v], lam1)
            last = (v == n_cfd - 1) and ctns is None
            if not last:
                residual -= cfd[v][codes_list[v]] @ F
        if ctns is not None:
            P = ctns.shape[1]
            for j in range(P):
                c = ctns[:, j]
                residual += np.outer(c, W[j] @ F)
                if masked:
                    W[j] = ctns_update_masked(residual, mask, F, c, W[j],
                                              lam1)
                else:
                    # optimize_continuous_v2 dense path (:127-131): the
                    # "data" argument is the add-back residual.
                    XtX = (c @ c) * (F @ F.T) + lam1 * np.eye(K)
                    W[j] = np.linalg.solve(XtX, F @ (residual.T @ c))
                if j != P - 1:
                    residual -= np.outer(c, W[j] @ F)

        R = row_factor()
        update_columns(R, sub_tol * decay)
        residual = data - R @ F

        if it % 10 == 0:
            pre_loss = loss
            sum_residual, train_rmse, test_rmse = evaluate(residual)
            loss = loss_of(sum_residual)
            delta_loss = pre_loss - loss
            # decay ladder (:389-403)
            d = delta_loss / 1000.0
            for exp in (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1):
                if d <= exp:
                    decay = exp
                    break
            else:
                decay = 1.0
            history.append({"iter": it, "loss": loss,
                            "train_rmse": train_rmse,
                            "test_rmse": test_rmse,
                            "delta_loss": delta_loss, "decay": decay})
            if (pre_loss - loss) / pre_loss < global_tol:
                break
        it += 1

    return {"history": history, "cfd": cfd, "F": F, "W": W, "loss": loss,
            "train_rmse": train_rmse, "test_rmse": test_rmse}


def global_loss(data, mask, cfd_factors, codes_list, F, lam1, lam2, alpha,
                ctns=None, W=None):
    """compute_loss over all factors (src/utils.cpp:79-102), masked residual."""
    R = np.zeros((data.shape[0], F.shape[0]))
    for V, codes in zip(cfd_factors, codes_list):
        R += V[codes]
    if ctns is not None:
        R += ctns @ W
    resid = (data - R @ F) * mask
    row_reg = lam1 * sum(np.sum(V**2) for V in cfd_factors)
    if W is not None:
        row_reg += lam1 * np.sum(W**2)
    col_reg = lam2 * (1 - alpha) * np.sum(F**2)
    l1_reg = lam2 * alpha * np.sum(np.abs(F))
    return 0.5 * np.sum(resid**2) + 0.5 * row_reg + 0.5 * col_reg + l1_reg
