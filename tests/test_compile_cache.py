"""Persistent compile cache placement: JAX_COMPILATION_CACHE_DIR when it
is set (JAX reads it; the package sets no directory), else build/jax_cache
in the checkout.  Each case imports the package in a fresh process."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, "build", "jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax, lut_ldpc_tpu\n"
         "print(jax.config.jax_compilation_cache_dir)\n"],
        cwd=str(tmp_path), env=dict(env, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == want
