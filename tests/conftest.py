"""Test configuration.

Device-dependent tests run on a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without an accelerator (the
reference has no distributed tests to mirror - SURVEY.md section 4).
Tests that need an NVIDIA GPU carry the `chip` marker and skip here.
"""

import os

# Must be set before any backend initializes: tests always run on the
# virtual 8-device CPU mesh for determinism and speed.
os.environ["JAX_PLATFORMS"] = "cpu"
# Isolate the engine-auto accelerator probe from the machine: no
# test may read or poison the user's real cached verdict
# (~/.cache/stringsext-tpu/device_probe.json); probe tests pin
# their own cache path / probe mode on top of these defaults.
os.environ.setdefault("STRINGSEXT_DEVICE_PROBE", "0")
os.environ.setdefault(
    "STRINGSEXT_PROBE_CACHE",
    os.path.join(os.environ.get("TMPDIR", "/tmp"),
                 f"stringsext-test-probe-{os.getpid()}.json"),
)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_FUNCTIONAL = pathlib.Path("/root/reference/tests/functional")


@pytest.fixture(scope="session")
def golden_dir():
    if not REFERENCE_FUNCTIONAL.exists():
        pytest.skip("reference conformance corpus not available")
    return REFERENCE_FUNCTIONAL
