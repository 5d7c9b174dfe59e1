"""dryrun_multichip in a fresh process with the devices configured before
start (XLA_FLAGS + CPU platform): it runs the data-parallel Monte-Carlo
step over the requested mesh, and fails, printing no OK line, when fewer
devices are visible than it was asked for.

Runs in a subprocess because XLA parses XLA_FLAGS once at backend start —
the in-process test interpreter already consumed them (tests/conftest.py).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_devices,ok", [(8, True), (16, False)])
def test_dryrun_multichip_driver_env(n_devices, ok):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax\n"
         "assert len(jax.devices()) == 8, jax.devices()\n"
         "import __graft_entry__ as g\n"
         f"g.dryrun_multichip({n_devices})\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    out = f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert (proc.returncode == 0) == ok, out
    assert ("OK" in proc.stdout) == ok, out
    if not ok:
        assert "need 16 devices, have 8" in proc.stderr, out
