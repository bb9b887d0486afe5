"""Real multi-process distributed execution proof.

The reference is a single OpenMP process with no communication backend at all
(src/Makevars:11-13) — multi-host scaling is a subsystem this framework adds,
so it must be *executed*, not just written.  This tool spawns N real OS
processes (default 2), each owning 4 virtual CPU devices, brings up
jax.distributed over a localhost coordinator with gloo CPU collectives,
builds a problem through build_problem_distributed with genuinely per-process
data blocks (each process slices only its process_block of the global
matrix), runs the full ALS step over the (1, 8) global mesh for 3 check
boundaries, and compares the per-boundary loss/RMSE trajectory against a
single-process run of the identical problem on an 8-virtual-device mesh.

Every process runs on the CPU (JAX_PLATFORMS=cpu), so no two processes ever
share a GPU.  Exercises the multi-process branches of
sharding/distributed.py:
multi-process initialize, cross-process make_array_from_process_local_data,
process_block on a mesh where addressable devices are a strict subset, and
cross-process psums in the row update.

Usage:
    python tools/multiprocess_run.py   # launcher: writes multiproc_result.json
    (workers are spawned internally with --worker)

tests/test_multiprocess.py runs the same launcher under pytest (skipped when
process spawning is unavailable).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_ROWS, N_COLS, K = 64, 256, 6
LEVELS = (2, 5)
LAMBDA, ALPHA = 3.0, 0.4
MAX_ITER = 30               # 3 check boundaries
REL_TOL = 1e-5              # multi-process vs single-process agreement


def build_and_fit(num_processes: int, mesh_rows: int, mesh_cols: int):
    """Runs in the worker: build the globally-sharded problem from this
    process's block only, fit, and return the boundary history.

    mesh (1, 8): the gene axis crosses the process boundary (zero-comm CD;
    psums over 'cols' for F F^T).  mesh (2, 4): the SAMPLE axis crosses it —
    the per-level gram/Xty psums over 'rows' (train/als.py) ride gloo
    between real processes, the data-parallel axis the 500k-row BASELINE
    configs need."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import PartitionSpec as P

    import insider_tpu as it
    from insider_tpu.api import build_interaction_codes
    from insider_tpu.config import FitConfig
    from insider_tpu.sharding.distributed import pod_sharding, process_block
    from insider_tpu.sharding.mesh import make_mesh
    from insider_tpu.train import als

    sim = it.simulate_scale(N_ROWS, N_COLS, K, level_counts=LEVELS,
                            noise_std=1.0, seed=11)
    conf = sim.confounder
    inter = build_interaction_codes(conf, [0, 1])
    conf_full = np.column_stack([conf[:, 0], inter, conf[:, 1:]])
    # Densify level codes GLOBALLY (identical on every process — a local
    # np.unique of a row block would renumber levels inconsistently).
    codes, n_levels = [], []
    for c in range(conf_full.shape[1]):
        lv, inv = np.unique(conf_full[:, c], return_inverse=True)
        codes.append(inv.astype(np.int32))
        n_levels.append(int(lv.size))
    split = it.ratio_splitter(sim.data.astype(np.float64), ratio=0.1,
                              rm_na_col=False)

    cfg_sh = pod_sharding(mesh_rows, mesh_cols)
    mesh = make_mesh(cfg_sh)
    (r0, r1), (c0, c1) = process_block(mesh, P("rows", "cols"),
                                       (N_ROWS, N_COLS))
    # The process's block must be a strict sub-block along whichever mesh
    # axis crosses the process boundary.
    assert (r1 - r0) * (c1 - c0) * num_processes == N_ROWS * N_COLS, \
        (r0, r1, c0, c1)

    problem = als.build_problem_distributed(
        data=split.data[r0:r1, c0:c1].astype(np.float32),
        train_indicator=split.train_indicator[r0:r1, c0:c1],
        test_indicator=split.test_indicator[r0:r1, c0:c1],
        codes=[c[r0:r1] for c in codes],
        n_levels=tuple(n_levels),
        global_shape=(N_ROWS, N_COLS),
        sharding=cfg_sh,
        masked=True,
    )
    fit_cfg = FitConfig(latent_dim=K, lambda1=LAMBDA, lambda2=LAMBDA,
                        alpha=ALPHA, masked=True, global_tol=1e-12,
                        sub_tol=1e-5, max_iter=MAX_ITER, col_solver="fss",
                        seed=0)
    res = als.optimize(problem, fit_cfg, verbose=False)
    return {
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "mesh": [mesh_rows, mesh_cols],
        "row_block": [int(r0), int(r1)],
        "col_block": [int(c0), int(c1)],
        "history": [
            {k: rec[k] for k in ("iter", "loss", "train_rmse", "test_rmse")}
            for rec in res.history
        ],
        "f_exact_zero_frac": float((res.column_factor == 0).mean()),
    }


def worker(args):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass

    from insider_tpu.sharding.distributed import initialize_distributed

    if args.num_processes > 1:
        up = initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id)
        assert up, "jax.distributed did not come up multi-process"
    out = build_and_fit(args.num_processes, args.mesh_rows, args.mesh_cols)
    if jax.process_index() == 0:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


def _spawn(num_processes, port, out, n_local_devices, mesh_rows, mesh_cols):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", "").strip()
        + f" --xla_force_host_platform_device_count={n_local_devices}"
    ).strip()
    procs = []
    for i in range(num_processes):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--process-id", str(i), "--num-processes", str(num_processes),
             "--coordinator", f"localhost:{port}", "--out", out,
             "--mesh-rows", str(mesh_rows), "--mesh-cols", str(mesh_cols)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    rcs = [p.returncode for p in procs]
    return rcs, logs


def _run_layout(args, mesh_rows, mesh_cols, port):
    """One (mesh_rows, mesh_cols) layout: N-process run vs single-process
    run of the identical problem on the same mesh shape."""
    multi_out = os.path.join(REPO, ".multiproc_multi.json")
    single_out = os.path.join(REPO, ".multiproc_single.json")
    for f in (multi_out, single_out):
        if os.path.exists(f):
            os.remove(f)

    rcs, logs = _spawn(args.num_processes, port, multi_out,
                       n_local_devices=8 // args.num_processes,
                       mesh_rows=mesh_rows, mesh_cols=mesh_cols)
    if any(rcs) or not os.path.exists(multi_out):
        for i, lg in enumerate(logs):
            print(f"--- worker {i} (rc={rcs[i]}) ---\n{lg[-4000:]}",
                  file=sys.stderr)
        raise SystemExit(f"multi-process run failed (mesh {mesh_rows}x"
                         f"{mesh_cols})")

    rcs1, logs1 = _spawn(1, port + 1 if port < 65535 else port - 1,
                         single_out, n_local_devices=8,
                         mesh_rows=mesh_rows, mesh_cols=mesh_cols)
    if any(rcs1) or not os.path.exists(single_out):
        print(logs1[0][-4000:], file=sys.stderr)
        raise SystemExit("single-process run failed")

    multi = json.load(open(multi_out))
    single = json.load(open(single_out))

    def rel(a, b):
        return abs(a - b) / max(abs(a), abs(b), 1e-30)

    gaps = []
    for m, s in zip(multi["history"], single["history"]):
        assert m["iter"] == s["iter"]
        gaps.append({
            "iter": m["iter"],
            "rel_loss": rel(m["loss"], s["loss"]),
            "rel_train_rmse": rel(m["train_rmse"], s["train_rmse"]),
            "rel_test_rmse": rel(m["test_rmse"], s["test_rmse"]),
        })
    worst = max(max(g["rel_loss"], g["rel_train_rmse"], g["rel_test_rmse"])
                for g in gaps)
    for f in (multi_out, single_out):
        os.remove(f)
    return {
        "multi": {k: multi[k] for k in
                  ("process_count", "global_devices", "local_devices",
                   "mesh", "row_block", "col_block")},
        "single": {k: single[k] for k in
                   ("process_count", "global_devices", "local_devices")},
        "per_boundary_gaps": gaps,
        "worst_rel_gap": worst,
        "pass": bool(multi["process_count"] == args.num_processes
                     and worst <= REL_TOL),
    }


def launcher(args):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    # Both comm layouts: (1, 8) crosses the process
    # boundary on the GENE axis; (2, 4) crosses it on the SAMPLE axis, so
    # the per-level gram/Xty psums over 'rows' run over real gloo.
    layouts = {}
    for mesh_rows, mesh_cols in ((1, 8), (2, 4)):
        layouts[f"{mesh_rows}x{mesh_cols}"] = _run_layout(
            args, mesh_rows, mesh_cols, port)
        port = port + 2 if port < 65530 else port - 2

    result = {
        "config": f"{N_ROWS}x{N_COLS} K={K} levels={LEVELS}+interaction "
                  f"lambda={LAMBDA} alpha={ALPHA} masked, {MAX_ITER} iters",
        "rel_tol": REL_TOL,
        "layouts": layouts,
        "worst_rel_gap": max(r["worst_rel_gap"] for r in layouts.values()),
        "pass": all(r["pass"] for r in layouts.values()),
    }
    with open(args.result, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    sys.exit(0 if result["pass"] else 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--out", default="multiproc_worker.json")
    ap.add_argument("--mesh-rows", type=int, default=1)
    ap.add_argument("--mesh-cols", type=int, default=8)
    ap.add_argument("--result", default="multiproc_result.json")
    args = ap.parse_args()
    if args.worker:
        worker(args)
    else:
        launcher(args)


if __name__ == "__main__":
    main()
