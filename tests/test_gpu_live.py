"""Engine == oracle on a live GPU.

The rest of the suite runs on the virtual CPU mesh (conftest sets
JAX_PLATFORMS=cpu).  This test runs the toy profile in a child process
without that pin, so on a machine with a CUDA device the engine runs on
the card; the child reports whether it found one, and the test skips
where there is none.  On the card: `python -m pytest tests/ -m gpu`.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import sys

import jax

if jax.devices()[0].platform != "gpu":
    print("NO_GPU", jax.devices()[0].platform)
    sys.exit(0)
sys.path.insert(0, sys.argv[1])
from tests.test_engine import assert_states_equal, run_both
from tests.toy import build_toy_dataset

st_o, st_e = run_both(build_toy_dataset(sys.argv[2]))
assert_states_equal(st_o, st_e)
print("GPU_PARITY_OK", jax.devices()[0].device_kind)
"""


@pytest.mark.gpu
def test_profile_file_equals_oracle_on_gpu(tmp_path):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f)
    r = subprocess.run([sys.executable, "-c", CHILD, REPO, str(tmp_path)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=REPO)
    if r.returncode == 0 and r.stdout.startswith("NO_GPU"):
        pytest.skip(f"no CUDA device ({r.stdout.strip()})")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "GPU_PARITY_OK" in r.stdout, r.stdout + r.stderr
