"""Test harness: an 8-device virtual CPU mesh unless JAX_PLATFORMS says
otherwise.

Multi-device semantics are tested on CPU with
``xla_force_host_platform_device_count`` — "multi-node without a cluster"
(SURVEY §4).  Tests marked ``chip`` take the ``chip`` fixture, which skips
them unless JAX runs on a GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402

# Persistent compilation cache — XLA CPU compiles of scanned towers dominate
# test wall-clock otherwise (CPU entries feature-keyed: see
# utils/compilation_cache).  cache_everything: the suite re-runs many small
# (~0.2 s) CPU programs that the default 1 s threshold would never cache.
from desta25_audio_tpu.utils.compilation_cache import (  # noqa: E402
    setup_compilation_cache,
)

setup_compilation_cache(cache_everything=True)


@pytest.fixture()
def rng():
    # function-scoped: every test draws the same stream regardless of
    # execution order (a session-scoped generator made tolerances flaky)
    return np.random.default_rng(0)


@pytest.fixture()
def chip():
    """Skip unless JAX's default backend is a GPU (tests marked chip)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m chip tests/ on the card")
