"""Run tooling: the compile-cache placement shared by chip_smoke.py and
bench.py, and chip_smoke.py's refusal to pass without a GPU."""

import os
import subprocess
import sys

import pytest

from faiss_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and nothing set in
    code (JAX reads the variable itself)."""
    import jax

    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    """No variable: a fixed <repo>/.jax_cache, set through jax.config."""
    import jax

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_fails_without_gpu(argv):
    """On a CPU-only host chip_smoke.py exits non-zero and never prints
    its final ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr
