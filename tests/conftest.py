"""Test harness: 8 virtual CPU devices so mesh-sharded code paths run
without the card — the single-process analogue of the reference's
``mpirun -n 2`` pytest-mpi setup (reference .github/workflows/ci_test.yml).

The platform is forced through jax.config after ``import jax``, which
holds even where jax was imported before this file ran.  Tests that need
the card carry the ``gpu`` marker and decide inside the test.
"""
import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"


def reference_path(*parts):
    p = os.path.join(REFERENCE_DIR, *parts)
    if not os.path.exists(p):
        pytest.skip(f"reference fixture {p} not available")
    return p


@pytest.fixture
def rng():
    return np.random.default_rng(100)
