"""Where the persistent compilation cache lives (utils/cache.py)."""

import os

import jax

from dct_carver_tpu.utils import cache


def test_env_dir_is_used_and_nothing_else_is_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX keeps its cache there and the
    program sets no directory of its own."""
    target = str(tmp_path / "env_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert cache.cache_dir() == target
    assert cache.enable_compilation_cache() == target
    assert "jax_compilation_cache_dir" not in dict(calls)
    assert not os.path.exists(target)


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    path = cache.enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert dict(calls)["jax_compilation_cache_dir"] == path
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_tests_keep_cpu_compiles_out_of_the_cache():
    """conftest turns the persistent cache off for the whole test run."""
    assert jax.config.jax_enable_compilation_cache is False
