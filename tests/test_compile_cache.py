"""The CLI entry points' persistent compilation cache location."""
import jax

from tetra_tpu.utils import cache


def _calls(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_variable_is_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _calls(monkeypatch)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_unset_uses_the_fixed_checkout_directory(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _calls(monkeypatch)
    path = cache.enable_compile_cache()
    assert calls["jax_compilation_cache_dir"] == path
    assert path == str(cache.CACHE_DIR)


def test_directory_is_fixed_and_ignored():
    """Inside the checkout, free of temporary names, and git-ignored."""
    import pathlib
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert cache.CACHE_DIR == repo / ".jax_cache"
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()


def test_tests_run_without_a_persistent_cache():
    assert jax.config.jax_enable_compilation_cache is False
