"""Real 2-process distributed execution (tools/multiprocess_run.py).

Spawns 2 OS processes with 4 virtual CPU devices each, brings up
jax.distributed + gloo collectives over a localhost coordinator, fits via
build_problem_distributed with genuinely per-process blocks, and requires
the boundary trajectory to match a single-process run of the same problem —
the previously-untested multi-process branches of sharding/distributed.py.

Skipped when subprocess spawning or the localhost coordinator is
unavailable (e.g. restricted sandboxes).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "multiprocess_run.py")


@pytest.mark.slow
def test_two_process_matches_single_process(tmp_path):
    result_path = tmp_path / "multiproc.json"
    try:
        proc = subprocess.run(
            [sys.executable, TOOL, "--result", str(result_path)],
            capture_output=True, timeout=600, cwd=REPO,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        pytest.skip(f"cannot spawn worker processes here: {e!r}")
    out = proc.stdout.decode() + proc.stderr.decode()
    if not result_path.exists():
        if "did not come up multi-process" in out or "Connection" in out:
            pytest.skip(f"multi-process bring-up unavailable: {out[-500:]}")
        pytest.fail(f"launcher failed (rc={proc.returncode}): {out[-2000:]}")
    result = json.loads(result_path.read_text())
    # both comm layouts: gene axis (1x8) AND sample axis (2x4) cross the
    # process boundary
    assert set(result["layouts"]) == {"1x8", "2x4"}
    for name, lay in result["layouts"].items():
        assert lay["multi"]["process_count"] == 2, name
        assert lay["multi"]["global_devices"] == 8, name
        assert lay["multi"]["local_devices"] == 4, name
        assert lay["worst_rel_gap"] <= result["rel_tol"], (name, lay)
    # (2x4): each process owns a row block (32 of 64 rows), all columns
    assert result["layouts"]["2x4"]["multi"]["row_block"] == [0, 32]
    assert result["layouts"]["2x4"]["multi"]["col_block"] == [0, 256]
    assert result["pass"], result
