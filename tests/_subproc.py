"""The one way a test starts a Python subprocess.

The pytest process stays single-device (``conftest.py`` sets no
``XLA_FLAGS``), so a test that needs several JAX devices, or a CLI run end
to end, starts a fresh interpreter.  ``run_python`` gives it the repo's
``src`` on the path, JAX on the CPU, one OpenMP thread (XLA's CPU pool
keeps its threads), the forced device count the test asks for, and a time
limit the caller must name: the test workers share the host's cores, and a
subprocess that hangs fails its own test instead of the whole run.
``tests/test_suite_hygiene.py`` holds the port's test files to this."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
MAX_TIMEOUT = 300          # seconds; the hygiene test's ceiling


def env(devices=None) -> dict:
    """The environment of every test subprocess; ``devices`` forces that
    many host-platform devices."""
    flags = ("" if devices is None else
             f"--xla_force_host_platform_device_count={devices}")
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", XLA_FLAGS=flags)


def run_python(args, *, timeout, devices=None):
    """``python *args`` with ``env(devices)``, output captured as text; a
    run past ``timeout`` seconds raises ``subprocess.TimeoutExpired``."""
    return subprocess.run([sys.executable, *args], env=env(devices),
                          capture_output=True, text=True, timeout=timeout)
