"""Test configuration: force CPU JAX with 8 virtual devices so sharding
paths are exercised without accelerator hardware (SURVEY.md §4
implication (c))."""

import os

# Force CPU even on a GPU host: unit tests must be hermetic and fast.  The
# config update below also wins over a platform list set before startup.
os.environ["JAX_PLATFORMS"] = "cpu"
# keep in-process CLI runs from dropping kmers.anno.log into the repo cwd
# (tests that assert the file appender override this per-test)
os.environ.setdefault("KMERS_ANNO_LOG", "off")
# an empty value keeps JAX's persistent compilation cache off (the CLI
# would otherwise put one in the checkout)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REFERENCE_FIXTURE = "/root/reference/src/test/small.gto"


@pytest.fixture(scope="session")
def small_gto():
    from kmers_anno_tpu.genome import Genome
    return Genome.load(REFERENCE_FIXTURE)
