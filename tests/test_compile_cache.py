"""Placement of JAX's persistent compilation cache."""

import os

import jax
import pytest

import gnss_sim_receiver_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax_cache"])
def test_compile_cache_dir(env_dir, monkeypatch):
    saved = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        gnss_sim_receiver_tpu._setup_compilation_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    if env_dir is not None:
        assert got is None          # JAX reads the variable itself
        return
    assert got == os.path.join(REPO, ".jax_cache")
    assert got == gnss_sim_receiver_tpu.COMPILE_CACHE_DIR
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "/.jax_cache" in fh.read().split()
