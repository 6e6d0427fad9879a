"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR when set, else the
fixed path inside the checkout."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PROBE = ("import jax; from wrf_tpu.utils import compile_cache; "
         "p = compile_cache.enable(); "
         "print(p); print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [None, "env"])
def test_cache_dir(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(ROOT / ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]
