import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_subprocess(code: str, devices: int = 8, timeout: int = 420):
    """Run a test body in a fresh interpreter with N host devices.

    Multi-device shard_map/pjit tests need
    --xla_force_host_platform_device_count, which must be set before jax
    initializes — impossible in the already-running pytest process.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices}")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{res.stdout}\nSTDERR:\n"
            f"{res.stderr[-4000:]}")
    return res.stdout


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")


@pytest.fixture
def subproc():
    return run_subprocess
