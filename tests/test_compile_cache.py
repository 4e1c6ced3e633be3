"""The compile-cache helper honours JAX_COMPILATION_CACHE_DIR and otherwise
uses a fixed directory in the checkout."""

import jax
import pytest

from dspmap_tpu.utils.compile_cache import CHECKOUT, enable_compile_cache


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_env_var_set_changes_nothing(tmp_path, monkeypatch,
                                     restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache(tmp_path) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / ".jax_cache").exists()


def test_env_var_unset_uses_fixed_checkout_path(tmp_path, monkeypatch,
                                                restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = enable_compile_cache(tmp_path)
    assert got == str(tmp_path / ".jax_cache")
    assert (tmp_path / ".jax_cache").is_dir()
    assert jax.config.jax_compilation_cache_dir == got
    # the default root is the checkout itself, never a temporary path
    assert (CHECKOUT / "dspmap_tpu").is_dir()
    assert enable_compile_cache() == str(CHECKOUT / ".jax_cache")
