"""Loss, prediction, and RMSE evaluation.

Equivalent of src/utils.cpp:37-102 (`objective`, `compute_loss`,
`predict`, `evaluate`).  Sums that feed the 1e-9-relative stopping rule use
compensated double-single accumulation (ops/precise.py); each jitted eval
returns (hi, lo) f32 pairs that the host combines in float64.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from insider_tpu.ops import precise

HIGHEST = lax.Precision.HIGHEST


def predict(row_factor: jax.Array, column_factor: jax.Array) -> jax.Array:
    """predictions = row_factor @ column_factor (src/utils.cpp:52-54)."""
    return jnp.matmul(row_factor, column_factor, precision=HIGHEST)


class EvalSums(NamedTuple):
    """Device-side compensated partial sums; finalized on host in f64."""
    train_sse: tuple      # (hi, lo) sum of squared residuals over train mask
    test_sse: tuple       # (hi, lo) over test mask (masked mode only)
    n_train: jax.Array    # int32 scalar: observed train elements
    n_test: jax.Array     # int32 scalar


def evaluate_masked(residual, train_mask, test_mask) -> EvalSums:
    """Masked train/test SSE (src/utils.cpp:64-67).

    Masks may be stored uint8 (memory-lean mode); they are cast to the
    residual dtype for the products, and counted in int32: an f32 sum stops
    being exact above 2^24 elements, which the flagship's 16.77 M reach.
    int32 counts are exact up to 2^31 - 1 elements per mask.
    """
    dt = residual.dtype
    tr = precise.sum_squares_ds(residual * train_mask.astype(dt))
    te = precise.sum_squares_ds(residual * test_mask.astype(dt))
    return EvalSums(tr, te, jnp.sum(train_mask.astype(jnp.int32)),
                    jnp.sum(test_mask.astype(jnp.int32)))


def evaluate_dense(residual) -> EvalSums:
    """Whole-matrix SSE (src/utils.cpp:61-63)."""
    tr = precise.sum_squares_ds(residual)
    n = jnp.asarray(residual.size, jnp.int32)
    z = (jnp.float32(0), jnp.float32(0))
    return EvalSums(tr, z, n, jnp.int32(0))


class LossSums(NamedTuple):
    """Compensated pieces of the global objective (src/utils.cpp:79-102)."""
    row_reg: tuple     # (hi, lo) of sum_v ||V_v||_F^2 (incl. continuous W)
    col_l2: tuple      # (hi, lo) of ||F||_F^2
    col_l1: tuple      # (hi, lo) of sum|F|


def regularization_sums(cfd_factors: List[jax.Array],
                        ctns_factor: Optional[jax.Array],
                        column_factor: jax.Array) -> LossSums:
    all_rows = [f.reshape(-1) for f in cfd_factors]
    if ctns_factor is not None:
        all_rows.append(ctns_factor.reshape(-1))
    flat = jnp.concatenate(all_rows)
    return LossSums(
        row_reg=precise.sum_squares_ds(flat),
        col_l2=precise.sum_squares_ds(column_factor),
        col_l1=precise.sum_abs_ds(column_factor),
    )


# pack_metrics layout: 4 SSE slots, 4 count slots, 6 regularizer slots.
N_METRICS = 14
_COUNT_SPLIT = 4096


def _split_count(n):
    """int32 count -> two f32 slots that are both exact (hi < 2^19)."""
    return [(n // _COUNT_SPLIT).astype(jnp.float32),
            (n % _COUNT_SPLIT).astype(jnp.float32)]


def pack_metrics(ev: EvalSums, reg: LossSums) -> jax.Array:
    """Flatten all eval/reg partial sums into ONE (N_METRICS,) f32 vector so
    a check boundary costs a single device->host transfer.  The int32 counts
    travel as exact (hi, lo) pairs; the host rebuilds them."""
    return jnp.stack([
        ev.train_sse[0], ev.train_sse[1], ev.test_sse[0], ev.test_sse[1],
        *_split_count(ev.n_train), *_split_count(ev.n_test),
        reg.row_reg[0], reg.row_reg[1], reg.col_l2[0], reg.col_l2[1],
        reg.col_l1[0], reg.col_l1[1],
    ])


def finalize_metrics_vec(vec, lambda1: float, lambda2: float, alpha: float,
                         masked: bool) -> dict:
    """Host-side finalize_loss on a pack_metrics vector (numpy, post-transfer)."""
    import numpy as np

    v = np.asarray(vec, np.float64)
    counts = [int(v[i]) * _COUNT_SPLIT + int(v[i + 1]) for i in (4, 6)]
    ev = EvalSums((v[0], v[1]), (v[2], v[3]), *counts)
    reg = LossSums((v[8], v[9]), (v[10], v[11]), (v[12], v[13]))
    return finalize_loss(ev, reg, lambda1, lambda2, alpha, masked)


def finalize_loss(ev: EvalSums, reg: LossSums, lambda1: float, lambda2: float,
                  alpha: float, masked: bool) -> dict:
    """Host-side f64 combination: the reference's printed quantities.

    Returns the loss decomposition of src/utils.cpp:93-100 plus train/test
    RMSE of src/utils.cpp:61-67.
    """
    import math

    sum_residual = precise.finalize(*ev.train_sse)
    n_train = float(ev.n_train)
    train_rmse = math.sqrt(sum_residual / max(n_train, 1.0))
    if masked:
        test_sse = precise.finalize(*ev.test_sse)
        n_test = float(ev.n_test)
        test_rmse = math.sqrt(test_sse / max(n_test, 1.0)) if n_test else float("nan")
    else:
        test_rmse = float("nan")
    row_reg = lambda1 * precise.finalize(*reg.row_reg)
    col_reg = lambda2 * (1.0 - alpha) * precise.finalize(*reg.col_l2)
    l1_reg = lambda2 * alpha * precise.finalize(*reg.col_l1)
    loss = sum_residual / 2.0 + row_reg / 2.0 + col_reg / 2.0 + l1_reg
    return {
        "loss": loss,
        "train_rmse": train_rmse,
        "test_rmse": test_rmse,
        "sum_residual": sum_residual,
        "row_reg_loss": row_reg / 2.0,
        "col_reg_loss": col_reg / 2.0,
        "l1_reg_loss": l1_reg,
    }
