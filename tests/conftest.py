"""Test env: force CPU backend with 8 virtual devices so sharding tests run
anywhere (the accelerator analogue of a fake backend; the reference has
none — SURVEY.md §4)."""

import os

# Force CPU even when a GPU is attached: tests must be hermetic and fast.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent compilation cache ($JAX_COMPILATION_CACHE_DIR, else
# <repo>/.jax_cache): the shard_map stages of the sharded GCPS pipeline
# cost minutes of CPU compile; cache them across test runs
from alga_tpu.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def random_dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


@pytest.fixture
def make_dna(rng):
    def f(n):
        return random_dna(rng, n)
    return f
