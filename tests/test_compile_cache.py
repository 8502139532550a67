"""Where the persistent compilation cache lives."""

import os
import subprocess
import sys

from orb_slam2_refactored_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_default_is_one_fixed_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.cache_dir()
    assert first == compile_cache.cache_dir()
    assert first == os.path.join(REPO, ".jax_cache")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    code = ("from orb_slam2_refactored_tpu.compile_cache import cache_dir; "
            "print(cache_dir())")
    outs = {subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, check=True
                           ).stdout.strip() for _ in range(2)}
    assert outs == {first}
