"""Device mesh construction and sharding layout.

The reference has no distributed story (single process + OpenMP,
src/Makevars:11-13).  Here scaling is SPMD over a ('rows', 'cols') mesh
(SURVEY.md §2d):

  * 'cols' shards the gene axis: data, masks, the column factor F, and the
    entire CD inner loop (per-column Grams, beta, s) are column-local —
    zero communication in the hot loop, the tensor-parallel analog.
  * 'rows' shards the sample axis (data-parallel analog): per-level Grams and
    Xty segment-sums become partial sums that GSPMD combines with psum over
    the interconnect; the K x K / L x K results are tiny.

Factors (V_v, W) are replicated — they are << data.  All collectives are
XLA-inserted; apply_constraints pins the layouts GSPMD should preserve.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from insider_tpu.config import ShardingConfig


def make_mesh(cfg: ShardingConfig) -> Mesh:
    devices = list(cfg.devices) if cfg.devices else jax.devices()
    n = cfg.n_devices
    if len(devices) < n:
        raise ValueError(
            f"ShardingConfig wants {n} devices, only {len(devices)} available"
        )
    dev = np.asarray(devices[:n]).reshape(cfg.rows, cfg.cols)
    return Mesh(dev, ("rows", "cols"))


def check_divisible(mesh: Optional[Mesh], shape: Tuple[int, int]) -> None:
    """A sharded (N, M) problem needs N divisible by the 'rows' axis and M
    by the 'cols' axis (jax places equal shards only)."""
    if mesh is None:
        return
    rows, cols = mesh.shape["rows"], mesh.shape["cols"]
    if shape[0] % rows or shape[1] % cols:
        raise ValueError(
            f"a ({rows}, {cols}) mesh needs the sample count divisible by "
            f"{rows} and the gene count by {cols}; got {shape[0]} x "
            f"{shape[1]}")


def _put(x, mesh: Optional[Mesh], spec: P, dtype=None):
    if dtype is not None:
        x = np.asarray(x, dtype=np.dtype(jnp.dtype(dtype).name))
    if mesh is None:
        return jnp.asarray(x)
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_problem_arrays(
    mesh: Optional[Mesh],
    data: np.ndarray,
    train_mask: np.ndarray,
    test_mask: np.ndarray,
    codes: List[np.ndarray],
    ctns: Optional[np.ndarray],
    dtype,
    mask_dtype=None,
):
    check_divisible(mesh, data.shape)
    mat = P("rows", "cols")
    mdt = dtype if mask_dtype is None else mask_dtype
    data_d = _put(data, mesh, mat, dtype)
    train_d = _put(train_mask, mesh, mat, mdt)
    test_d = _put(test_mask, mesh, mat, mdt)
    codes_d = [_put(c, mesh, P("rows")) for c in codes]
    ctns_d = None if ctns is None else _put(ctns, mesh, P("rows", None), dtype)
    return data_d, train_d, test_d, codes_d, ctns_d


def apply_constraints(mesh: Optional[Mesh], state):
    """Pin factor shardings inside jit: F column-sharded, V_v/W replicated."""
    if mesh is None:
        return state
    from insider_tpu.model.state import InsiderState

    wsc = jax.lax.with_sharding_constraint
    F = wsc(state.column_factor, NamedSharding(mesh, P(None, "cols")))
    cfd = [wsc(f, NamedSharding(mesh, P(None, None))) for f in state.cfd_factors]
    W = state.ctns_factor
    if W is not None:
        W = wsc(W, NamedSharding(mesh, P(None, None)))
    return InsiderState(cfd, W, F, state.key)
