"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device tests without a cluster (SURVEY.md §4): shard-count invariance
of integer histograms makes N-shard runs bit-equal to 1-shard runs.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# the tests compile many tiny programs; a persistent cache shared by the
# parallel test workers would only add file races
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import pytest  # noqa: E402

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="session")
def toy_dir(tmp_path_factory):
    from tests.toy import build_toy_dataset
    d = tmp_path_factory.mktemp("toy")
    return build_toy_dataset(str(d))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; run on the card with "
        "`python -m pytest tests/ -m gpu` (skips where there is none)")
