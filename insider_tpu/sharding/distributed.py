"""Multi-host runtime: jax.distributed bring-up and global mesh layout.

The reference is a single OpenMP process with no communication backend at all
(src/Makevars:11-13; SURVEY.md §2d).  For the rebuild, multi-host scaling is a
first-class subsystem: each host runs the same SPMD program; XLA places
collectives on the interconnect (NCCL over NVLink between the cards of one
host; gloo between CPU processes).

Design for the INSIDER workload (see also sharding/mesh.py):

  * The gene axis ('cols') carries almost all the data (M >> N in every
    reference workload) — shard it as wide as possible.  The CD column update
    and the per-column Gram build are fully column-local: ZERO bytes on the
    interconnect in the hot loop.
  * The sample axis ('rows') is the data-parallel axis for the huge-N
    synthetic configs (500k x 1M, BASELINE.md).  Its only collectives are
    psums of (L, K, K) level Grams and (L, K) level RHS — kilobytes per
    iteration, latency- not bandwidth-bound.
  * The column factor F lives column-sharded and is NEVER all-gathered: row
    updates need X F^T and the level Grams Mw @ (F*F)^T, both of which
    contract over the gene axis, so each shard contributes a partial (L, K)
    / (L, K, K) term and one tiny psum finishes the job.  This is the
    blockwise-F design SURVEY.md §7 sketches, with the all-gather eliminated
    rather than overlapped — the strictly better version.

Bring-up order (call before any jax array op):

    from insider_tpu.sharding.distributed import initialize_distributed
    initialize_distributed()                       # no-op single-process
    cfg = pod_sharding(rows=..., cols=...)         # global mesh layout
    problem = als.build_problem(..., sharding=cfg)

Per-host data loading: `host_row_block` / `host_col_block` give the slice of
the global matrix this host should read (jax.make_array_from_process_local_data
assembles the global array), so a 500k x 1M matrix is never resident on one
host.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from insider_tpu.config import ShardingConfig


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed if running multi-process; else no-op.

    Detection, in precedence order:
      1. explicit args;
      2. coordinator env (JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS) or a
         multi-task SLURM allocation.
    Elsewhere pass coordinator_address (e.g. "localhost:<port>"),
    num_processes and process_id explicitly.  Returns True iff a
    multi-process runtime is up after the call.
    """
    import jax

    explicit = coordinator_address is not None
    env = ("JAX_COORDINATOR_ADDRESS" in os.environ
           or "COORDINATOR_ADDRESS" in os.environ
           or os.environ.get("SLURM_NTASKS", "1") not in ("", "1"))
    if not (explicit or env):
        return False
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_count() > 1


def pod_sharding(rows: int = 0, cols: int = 0) -> ShardingConfig:
    """A ShardingConfig over ALL global devices (every process's chips).

    With rows/cols both 0, auto-layout: put every device on the gene axis
    (cols), the zero-communication direction, unless the caller asks for a
    rows axis.  rows*cols must equal the global device count when both given;
    a single 0 is inferred.
    """
    import jax

    n = len(jax.devices())
    if rows == 0 and cols == 0:
        rows, cols = 1, n
    elif rows == 0:
        if n % cols:
            raise ValueError(f"{n} devices not divisible by cols={cols}")
        rows = n // cols
    elif cols == 0:
        if n % rows:
            raise ValueError(f"{n} devices not divisible by rows={rows}")
        cols = n // rows
    if rows * cols != n:
        raise ValueError(f"mesh {rows}x{cols} != {n} global devices")
    return ShardingConfig(rows=rows, cols=cols)


def process_block(mesh, spec, global_shape) -> Tuple[Tuple[int, int], ...]:
    """[start, stop) per axis of the region THIS process must provide.

    Derived from the actual sharding layout — the union of this process's
    addressable shards of NamedSharding(mesh, spec) on `global_shape` — not
    from process-id arithmetic, so it is correct for any mesh shape,
    device order, or axis split (and raises if a process's shards do not
    form one contiguous box, in which case per-shard loading via
    jax.make_array_from_callback must be used instead).
    """
    import jax

    sh = jax.sharding.NamedSharding(mesh, spec)
    # jax.Array requires dims divisible by their tiling factor; derive load
    # bounds for uneven shapes by querying the padded shape and clamping.
    # (Assembly of uneven shapes itself still needs caller-side padding —
    # padded rows/cols are inert under the element masks.)
    tiling = [1] * len(global_shape)
    for a, names in enumerate(tuple(spec)[: len(global_shape)]):
        if names is None:
            continue
        for nm in (names,) if isinstance(names, str) else tuple(names):
            tiling[a] *= mesh.shape[nm]
    padded = tuple(-(-d // t) * t for d, t in zip(global_shape, tiling))
    idx_map = sh.addressable_devices_indices_map(padded)
    bounds = []
    for a, dim in enumerate(global_shape):
        ivals = sorted({
            (idx[a].start or 0,
             dim if idx[a].stop is None else idx[a].stop)
            for idx in idx_map.values()
        })
        lo = ivals[0][0]
        hi = max(e for _, e in ivals)
        cur = lo
        for s, e in ivals:
            if s > cur:
                raise ValueError(
                    f"process shards non-contiguous on axis {a}: gap at "
                    f"[{cur}, {s}); load per-shard via "
                    f"jax.make_array_from_callback instead")
            cur = max(cur, e)
        bounds.append((min(lo, dim), min(hi, dim)))
    return tuple(bounds)


def host_row_block(n_rows: int, cfg: ShardingConfig) -> Tuple[int, int]:
    """[start, stop) of the global row axis this process should load, for a
    (N, M) array sharded P('rows', 'cols') on cfg's mesh."""
    from insider_tpu.sharding.mesh import make_mesh
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(cfg)
    # The column extent of the dummy shape is irrelevant to row bounds; use
    # cfg.cols so it is always evenly shardable.
    (r0, r1), _ = process_block(mesh, P("rows", "cols"), (n_rows, cfg.cols))
    return r0, r1


def host_col_block(n_cols: int, cfg: ShardingConfig) -> Tuple[int, int]:
    """[start, stop) of the global gene axis this process should load."""
    from insider_tpu.sharding.mesh import make_mesh
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(cfg)
    _, (c0, c1) = process_block(mesh, P("rows", "cols"), (cfg.rows, n_cols))
    return c0, c1


def make_global_array(local_block, mesh, spec, global_shape=None):
    """Assemble a globally-sharded array from per-process local blocks.

    local_block covers exactly process_block(mesh, spec, global_shape); with
    global_shape=None (single-process convenience) the block IS the global
    array.
    """
    import jax

    return jax.make_array_from_process_local_data(
        jax.sharding.NamedSharding(mesh, spec), local_block, global_shape
    )


def make_global_array_from_callback(global_shape, mesh, spec, cb,
                                    np_dtype=None):
    """Assemble a globally-sharded array by loading each addressable shard
    on demand: cb(index_tuple_of_slices) -> numpy block.

    This is the zero-full-materialization ingestion path: no process (and no
    single allocation) ever holds more than one device shard — the loader
    for the 500k x 1M configs (BASELINE.json configs 4-5), where even one
    host-sized block of the matrix may not fit host RAM.
    """
    import jax
    import numpy as np

    sh = jax.sharding.NamedSharding(mesh, spec)

    def _cb(idx):
        blk = np.asarray(cb(idx))
        return blk if np_dtype is None else np.asarray(blk, np_dtype)

    return jax.make_array_from_callback(tuple(global_shape), sh, _cb)
