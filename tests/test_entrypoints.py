"""The scripts that measure the card refuse to run without one, and the
compile cache goes where the environment or the fixed default says."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from fhe_study_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_refuses_the_cpu(script):
    res = _run(os.path.join(ROOT, script), ROOT)
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the repository beside it the script cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure()
    assert path == os.path.join(ROOT, "_build", "jaxcache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)
