"""chip_smoke.py: it refuses to run, and prints no result line, when JAX
finds no GPU (also when it stands alone, without the repository); on a
card (`gpu` marker) it passes end to end."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "chip_smoke: needs a GPU, JAX found 'cpu'" in proc.stderr


@pytest.fixture
def gpu_env():
    """Environment for a child process that may open the card; skips
    when the machine has no NVIDIA GPU."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # tests/conftest.py pins the CPU
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=gpu_env, capture_output=True, text=True,
                          timeout=1500)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
