"""Test configuration: an 8-device virtual CPU mesh, no persistent cache.

Tests validate bit-exactness and sharding semantics; they run
deterministically on the CPU. Tests that need an NVIDIA GPU carry the
`gpu` marker and skip here (chip_smoke.py runs them on the card).
"""
import os

# the CPU unless the caller names platforms: `JAX_PLATFORMS=cuda,cpu
# pytest -m gpu tests/` runs the gpu-marked tests on a card
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# No persistent compilation cache for tests, even where a CLI entry
# point called in-process (rx.main, receiver.main) points JAX at one:
# the executable (de)serialization path has segfaulted near the end of
# a full-suite run, and entries compiled for another CPU can fault on
# load.
jax.config.update("jax_enable_compilation_cache", False)

import json
import pathlib

import numpy as np
import pytest

GOLDEN_PATH = pathlib.Path(__file__).parent / "golden" / "golden.json"


@pytest.fixture
def gpu():
    """The first NVIDIA GPU, or a skip where there is none. Decided when
    the test runs, never at import or collection time."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return devs[0]


@pytest.fixture(scope="session")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def arr(entry, key):
    return np.asarray(entry[key], dtype=np.uint8)
