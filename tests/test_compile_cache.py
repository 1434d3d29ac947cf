"""Persistent compile-cache location (utils.compile_cache)."""

import os

import jax

from kmers_anno_tpu.utils import compile_cache


def _spy(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_dir_wins_and_nothing_is_set(monkeypatch, tmp_path):
    calls = _spy(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_unset_env_uses_checkout_cache(monkeypatch):
    calls = _spy(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
