"""Distributed ingestion: per-process/per-shard loading without full
materialization, uint8 memory-lean masks.

Single-process here (8 virtual CPU devices), so the process block equals the
full matrix — but the layout math is exercised against the REAL sharding
objects (addressable_devices_indices_map), and the callback path proves that
no allocation larger than one device shard is ever created.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import insider_tpu as it
from insider_tpu.config import FitConfig, ShardingConfig
from insider_tpu.sharding.distributed import (
    host_col_block,
    host_row_block,
    make_global_array,
    make_global_array_from_callback,
    process_block,
)
from insider_tpu.sharding.mesh import make_mesh
from insider_tpu.train import als


MESHES = [(1, 8), (2, 4), (8, 1)]


@pytest.mark.parametrize("rows,cols", MESHES)
def test_process_block_matches_addressable_shards(rows, cols):
    mesh = make_mesh(ShardingConfig(rows=rows, cols=cols))
    shape = (16, 24)
    blk = process_block(mesh, P("rows", "cols"), shape)
    # single process: the union of addressable shards is the whole matrix
    assert blk == ((0, 16), (0, 24))
    # and the per-device index map must tile exactly that box
    sh = NamedSharding(mesh, P("rows", "cols"))
    idxs = sh.addressable_devices_indices_map(shape)
    covered = np.zeros(shape, np.int32)
    for idx in idxs.values():
        covered[idx] += 1
    # every element covered the same number of times (replication factor)
    assert covered.min() == covered.max() >= 1


@pytest.mark.parametrize("rows,cols", MESHES)
def test_make_global_array_from_local_block(rows, cols):
    cfg = ShardingConfig(rows=rows, cols=cols)
    mesh = make_mesh(cfg)
    x = np.arange(16 * 24, dtype=np.float32).reshape(16, 24)
    (r0, r1) = host_row_block(16, cfg)
    (c0, c1) = host_col_block(24, cfg)
    local = x[r0:r1, c0:c1]
    g = make_global_array(local, mesh, P("rows", "cols"), global_shape=(16, 24))
    np.testing.assert_array_equal(np.asarray(g), x)


def test_callback_assembly_never_materializes_more_than_one_shard():
    cfg = ShardingConfig(rows=2, cols=4)
    mesh = make_mesh(cfg)
    shape = (16, 32)
    x = np.arange(shape[0] * shape[1], dtype=np.float32).reshape(shape)
    max_elems = {"n": 0}

    def cb(idx):
        blk = x[idx]
        max_elems["n"] = max(max_elems["n"], blk.size)
        return blk

    g = make_global_array_from_callback(shape, mesh, P("rows", "cols"), cb)
    np.testing.assert_array_equal(np.asarray(g), x)
    shard_elems = (shape[0] // 2) * (shape[1] // 4)
    assert max_elems["n"] == shard_elems  # never a full-matrix allocation


def _sim_problem_arrays():
    sim = it.simulate_insider_data(v1_num=8, v2_num=3, gene_num=64,
                                   latent_dim=3, seed=0,
                                   with_interaction=False)
    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1)
    codes, n_levels = [], []
    for c in range(sim.confounder.shape[1]):
        levels, inv = np.unique(sim.confounder[:, c], return_inverse=True)
        codes.append(inv.astype(np.int32))
        n_levels.append(int(levels.size))
    return sim, split, codes, tuple(n_levels)


def _run2(problem, K=3):
    from insider_tpu.model.state import init_state

    cfg = FitConfig(latent_dim=K, lambda1=1.0, lambda2=1.0, alpha=0.4,
                    masked=True, use_pallas=False)
    state = init_state(jax.random.PRNGKey(0), problem.n_levels,
                       problem.shape[1], K)
    ss = als.StepStatics.from_config(cfg)
    hy = als.Hypers(jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.4))
    out = als._run_steps(problem.arrays, problem.statics, ss, hy, state,
                         jnp.float32(1e-5), jnp.int32(2))
    ev, reg = als._evaluate(problem.arrays, problem.statics, out)
    return np.asarray(out.column_factor), float(ev.train_sse[0])


@pytest.mark.parametrize("rows,cols", [(2, 4), (8, 1)])
def test_build_problem_distributed_matches_plain(rows, cols):
    sim, split, codes, n_levels = _sim_problem_arrays()
    N, M = split.data.shape
    cfg = ShardingConfig(rows=rows, cols=cols)

    plain = als.build_problem(split.data, sim.confounder,
                              split.train_indicator, split.test_indicator,
                              masked=True, sharding=cfg)

    x = np.asarray(split.data, np.float32)
    tr = np.asarray(split.train_indicator, np.float32)
    te = np.asarray(split.test_indicator, np.float32)
    dist = als.build_problem_distributed(
        data=lambda idx: x[idx],            # per-shard callbacks
        train_indicator=lambda idx: tr[idx],
        test_indicator=lambda idx: te[idx],
        codes=[(lambda c: (lambda idx: c[idx]))(c) for c in codes],
        n_levels=n_levels,
        global_shape=(N, M),
        sharding=cfg,
    )
    np.testing.assert_array_equal(np.asarray(dist.arrays.data),
                                  np.asarray(plain.arrays.data))
    np.testing.assert_array_equal(np.asarray(dist.arrays.train_mask),
                                  np.asarray(plain.arrays.train_mask))
    for a, b in zip(dist.arrays.codes, plain.arrays.codes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    F_a, sse_a = _run2(plain)
    F_b, sse_b = _run2(dist)
    np.testing.assert_allclose(F_a, F_b, rtol=1e-5, atol=1e-7)
    assert sse_a == pytest.approx(sse_b, rel=1e-6)


def test_uint8_masks_match_f32():
    sim, split, codes, n_levels = _sim_problem_arrays()
    f32p = als.build_problem(split.data, sim.confounder,
                             split.train_indicator, split.test_indicator,
                             masked=True)
    u8p = als.build_problem(split.data, sim.confounder,
                            split.train_indicator, split.test_indicator,
                            masked=True, mask_dtype=jnp.uint8)
    assert u8p.arrays.train_mask.dtype == jnp.uint8
    F_a, sse_a = _run2(f32p)
    F_b, sse_b = _run2(u8p)
    np.testing.assert_allclose(F_a, F_b, rtol=1e-6, atol=1e-8)
    assert sse_a == pytest.approx(sse_b, rel=1e-7)


def test_uint8_lean_no_precompute_optimize():
    """Full optimize() in the memory-lean configuration (uint8 masks, no
    (L, M) precomputes): must agree with the default path."""
    sim, split, codes, n_levels = _sim_problem_arrays()
    lean = als.build_problem(split.data, sim.confounder,
                             split.train_indicator, split.test_indicator,
                             masked=True, mask_dtype=jnp.uint8,
                             precompute=False)
    full = als.build_problem(split.data, sim.confounder,
                             split.train_indicator, split.test_indicator,
                             masked=True)
    cfg = FitConfig(latent_dim=3, lambda1=1.0, lambda2=1.0, alpha=0.4,
                    masked=True, max_iter=30, global_tol=1e-9)
    a = als.optimize(full, cfg, verbose=False)
    b = als.optimize(lean, cfg, verbose=False)
    assert a.loss == pytest.approx(b.loss, rel=1e-5)
    assert a.test_rmse == pytest.approx(b.test_rmse, rel=1e-4)
