"""Backend selection, the compile-cache helper, and the GPU-only entry points
refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from insider_tpu import runtime
from insider_tpu.config import FitConfig
from insider_tpu.train import als

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,requested,want", [
    ("gpu", None, True),
    ("gpu", True, True),
    ("gpu", False, False),
    ("cpu", None, False),
    ("cpu", False, False),
])
def test_resolve_use_pallas(backend, requested, want):
    assert als.resolve_use_pallas(requested, backend) is want


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_unknown_backend_is_an_error_naming_it(backend):
    with pytest.raises(ValueError, match=repr(backend)):
        als.resolve_use_pallas(None, backend)


def test_use_pallas_true_on_cpu_raises():
    assert jax.default_backend() == "cpu"
    with pytest.raises(ValueError, match="gpu"):
        als.StepStatics.from_config(FitConfig(use_pallas=True))


def test_cpu_default_is_the_jnp_path():
    assert not als.StepStatics.from_config(FitConfig()).use_pallas


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_env_unset_uses_repo_dir(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(REPO, ".jax_cache")
    assert runtime.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_chip_smoke_refuses_cpu(args):
    r = _run([os.path.join(REPO, "chip_smoke.py")] + args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "PHASE device: FAILED" in r.stdout


def test_chip_smoke_four_cards_needs_four_devices():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--four-cards"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "needs 4 GPUs, JAX sees 2 device(s)" in r.stdout
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run([os.path.join(REPO, "bench.py"), "--solver", "fss"])
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert r.stdout.strip() == ""
