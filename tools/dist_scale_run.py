"""From-file distributed ingestion proof at a non-toy shape.

Two REAL OS processes (gloo collectives, (2, 4) global mesh) build a
problem ONLY through `file_ingest_callbacks` (data/native.py): the data
comes from a raw float32 file via native block pread, the train/test masks
from the deterministic per-block splitter — no process ever materializes
the full matrix or a full mask.  The run's boundary loss/RMSE trajectory
is compared against a single-process run whose problem is built IN MEMORY
from the same file + the same (Bernoulli-block) split.

Every process runs on the CPU (JAX_PLATFORMS=cpu), so no two processes ever
share a GPU.  The result file records, per process:
  * device-resident problem bytes (sum of the local shards actually held —
    one half of the global matrix per process at this mesh);
  * the largest single allocation the ingestion callbacks ever returned
    (must be one shard, not the full matrix);
  * peak RSS (VmHWM) as the end-to-end host-side bound.

Together these show a problem built from a raw file that NO single process
materializes, with the distributed trajectory matching the in-memory build.

Usage:
    python tools/dist_scale_run.py [--result dist_scale_result.json]
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

N_ROWS = int(os.environ.get("DIST_SCALE_ROWS", 2048))
N_COLS = int(os.environ.get("DIST_SCALE_COLS", 8192))
K = 8
LEVELS = (4, 8)
LAMBDA, ALPHA = 3.0, 0.4
RATIO, SEED = 0.1, 77
MAX_ITER = 30
REL_TOL = 1e-5
MESH = (2, 4)


def _codes_for_rows(r0, r1):
    """Deterministic global confounder codes from the row index alone —
    every process derives its block without any global pass."""
    import numpy as np

    rows = np.arange(r0, r1, dtype=np.int64)
    return [(rows * (v + 3) // 7 % L).astype(np.int32)
            for v, L in enumerate(LEVELS)]


def _write_data_file(path):
    import numpy as np

    import insider_tpu as it

    sim = it.simulate_scale(N_ROWS, N_COLS, K, level_counts=LEVELS,
                            noise_std=1.0, seed=5)
    np.ascontiguousarray(sim.data, np.float32).tofile(path)


def _vm_hwm_bytes():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmHWM"):
                return int(line.split()[1]) * 1024
    return None


def worker(args):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    import numpy as np

    from insider_tpu.config import FitConfig
    from insider_tpu.data.native import file_ingest_callbacks
    from insider_tpu.sharding.distributed import initialize_distributed
    from insider_tpu.train import als

    if args.num_processes > 1:
        up = initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id)
        assert up, "jax.distributed did not come up multi-process"

    from insider_tpu.sharding.distributed import pod_sharding

    data_cb, train_cb, test_cb = file_ingest_callbacks(
        args.data_file, (N_ROWS, N_COLS), RATIO, SEED)

    # instrument the callbacks: the largest single block ever returned is
    # the artifact's "no allocation exceeds one shard" evidence
    peak_block = {"bytes": 0}

    def wrap(cb):
        def inner(idx):
            blk = cb(idx)
            peak_block["bytes"] = max(peak_block["bytes"], blk.nbytes)
            return blk
        return inner

    def codes_cb(idx):
        rs = idx[0].indices(N_ROWS)
        return _codes_for_rows(rs[0], rs[1])

    problem = als.build_problem_distributed(
        data=wrap(data_cb),
        train_indicator=wrap(train_cb),
        test_indicator=wrap(test_cb),
        codes=[(lambda v: (lambda idx: codes_cb(idx)[v]))(v)
               for v in range(len(LEVELS))],
        n_levels=LEVELS,
        global_shape=(N_ROWS, N_COLS),
        sharding=pod_sharding(*MESH),
        masked=True,
        mask_dtype="uint8",
    )
    resident = 0
    for leaf in jax.tree_util.tree_leaves(problem.arrays):
        if isinstance(leaf, jax.Array):
            resident += sum(s.data.nbytes for s in leaf.addressable_shards)

    fit_cfg = FitConfig(latent_dim=K, lambda1=LAMBDA, lambda2=LAMBDA,
                        alpha=ALPHA, masked=True, global_tol=1e-12,
                        sub_tol=1e-5, max_iter=MAX_ITER, col_solver="fss",
                        seed=0)
    res = als.optimize(problem, fit_cfg, verbose=False)
    out = {
        "process_count": jax.process_count(),
        "process_id": args.process_id,
        "mesh": list(MESH),
        "split_variant": problem.split_variant,
        "device_resident_problem_bytes": int(resident),
        "full_matrix_plus_masks_bytes": N_ROWS * N_COLS * (4 + 2),
        "largest_single_ingest_block_bytes": peak_block["bytes"],
        "peak_rss_bytes": _vm_hwm_bytes(),
        "history": [
            {k: rec[k] for k in ("iter", "loss", "train_rmse", "test_rmse")}
            for rec in res.history
        ],
    }
    with open(args.out + f".p{args.process_id}", "w") as fh:
        json.dump(out, fh, indent=1)


def single_reference(args):
    """In-memory build of the identical problem (same file, same
    Bernoulli-block split) on one process, 8 virtual devices."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from insider_tpu.config import FitConfig
    from insider_tpu.data.native import split_mask_block
    from insider_tpu.sharding.distributed import pod_sharding
    from insider_tpu.train import als

    data = np.fromfile(args.data_file, np.float32).reshape(N_ROWS, N_COLS)
    train, test, _ = split_mask_block((N_ROWS, N_COLS), (0, N_ROWS),
                                      (0, N_COLS), RATIO, SEED,
                                      data_block=data)
    codes = _codes_for_rows(0, N_ROWS)
    conf = np.column_stack(codes)
    problem = als.build_problem(data, conf, train, test, masked=True,
                                sharding=pod_sharding(*MESH),
                                mask_dtype="uint8")
    fit_cfg = FitConfig(latent_dim=K, lambda1=LAMBDA, lambda2=LAMBDA,
                        alpha=ALPHA, masked=True, global_tol=1e-12,
                        sub_tol=1e-5, max_iter=MAX_ITER, col_solver="fss",
                        seed=0)
    res = als.optimize(problem, fit_cfg, verbose=False)
    out = {
        "history": [
            {k: rec[k] for k in ("iter", "loss", "train_rmse", "test_rmse")}
            for rec in res.history
        ],
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)


def launcher(args):
    import numpy as np  # noqa: F401  (host-side only)

    data_file = os.path.join(REPO, ".dist_scale_data.f32")
    if not os.path.exists(data_file):
        _write_data_file(data_file)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", "").strip()
        + " --xla_force_host_platform_device_count=4").strip()
    multi_out = os.path.join(REPO, ".dist_scale_multi.json")
    procs = []
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--process-id", str(i), "--num-processes", "2",
             "--coordinator", f"localhost:{port}",
             "--data-file", data_file, "--out", multi_out],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=1800)[0].decode() for p in procs]
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for i, lg in enumerate(logs):
            print(f"--- worker {i} (rc={rcs[i]}) ---\n{lg[-4000:]}",
                  file=sys.stderr)
        raise SystemExit("distributed from-file run failed")

    env1 = dict(env)
    env1["XLA_FLAGS"] = env1["XLA_FLAGS"].replace(
        "device_count=4", "device_count=8")
    single_out = os.path.join(REPO, ".dist_scale_single.json")
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--single",
         "--data-file", data_file, "--out", single_out],
        env=env1, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lg = p.communicate(timeout=1800)[0].decode()
    if p.returncode:
        print(lg[-4000:], file=sys.stderr)
        raise SystemExit("single-process reference run failed")

    workers = [json.load(open(multi_out + f".p{i}")) for i in range(2)]
    single = json.load(open(single_out))

    def rel(a, b):
        return abs(a - b) / max(abs(a), abs(b), 1e-30)

    gaps = []
    for m, s in zip(workers[0]["history"], single["history"]):
        assert m["iter"] == s["iter"]
        gaps.append({
            "iter": m["iter"],
            "rel_loss": rel(m["loss"], s["loss"]),
            "rel_train_rmse": rel(m["train_rmse"], s["train_rmse"]),
            "rel_test_rmse": rel(m["test_rmse"], s["test_rmse"]),
        })
    worst = max(max(g.values()) for g in
                [{k: v for k, v in g.items() if k != "iter"} for g in gaps])
    full_bytes = N_ROWS * N_COLS * (4 + 2)
    per_proc = [w["device_resident_problem_bytes"] for w in workers]
    result = {
        "config": f"{N_ROWS}x{N_COLS} K={K} levels={LEVELS} "
                  f"lambda={LAMBDA} alpha={ALPHA} masked "
                  f"Bernoulli({RATIO}) seed={SEED}, {MAX_ITER} iters, "
                  f"mesh {MESH[0]}x{MESH[1]}, 2 real processes (gloo)",
        "data_file_bytes": os.path.getsize(data_file),
        "full_matrix_plus_masks_bytes": full_bytes,
        "per_process": [
            {k: w[k] for k in ("process_id",
                               "device_resident_problem_bytes",
                               "largest_single_ingest_block_bytes",
                               "peak_rss_bytes", "split_variant")}
            for w in workers],
        "no_process_held_full_matrix": bool(
            all(b < full_bytes for b in per_proc)
            and all(w["largest_single_ingest_block_bytes"] < full_bytes / 2
                    for w in workers)),
        "per_boundary_gaps": gaps,
        "worst_rel_gap": worst,
        "rel_tol": REL_TOL,
        "pass": bool(worst <= REL_TOL),
    }
    for f in ([multi_out + f".p{i}" for i in range(2)] + [single_out]):
        if os.path.exists(f):
            os.remove(f)
    with open(args.result, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    sys.exit(0 if result["pass"] else 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--data-file", default=None)
    ap.add_argument("--out", default=os.path.join(REPO, ".dist_scale.json"))
    ap.add_argument("--result", default="dist_scale_result.json")
    args = ap.parse_args()
    if args.worker:
        worker(args)
    elif args.single:
        single_reference(args)
    else:
        launcher(args)


if __name__ == "__main__":
    main()
