"""Test harness configuration.

Puts JAX on the CPU backend (unless JAX_PLATFORMS names another) with 8
virtual devices BEFORE jax import, so multi-device sharding (shard_map over
a Mesh) is testable on one host — the framework's analog of a fake-backend
distributed test rig (SURVEY.md §4).
"""

import os

# CPU unless the caller names a platform (JAX_PLATFORMS=cuda with -m gpu
# runs the tests that need the card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags +
                               " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from rtjax.utils.cache import enable_compile_cache  # noqa: E402

# persistent compilation cache: the big while-loop programs take a while to
# compile on the CPU; cache them across test runs
enable_compile_cache()

ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, "assets")
BUNNY_PLY = os.path.abspath(os.path.join(ASSETS, "bun_zipper.ply"))


def pytest_collection_modifyitems(config, items):
    """Default run excludes @pytest.mark.slow (long renders and parity
    matrices).  Run them with ``-m slow``; CI runs both."""
    if config.getoption("-m"):
        return  # an explicit marker expression overrides the default skip
    skip = pytest.mark.skip(reason="slow: run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(7)


def random_triangles(rng, n, lo=-1.0, hi=1.0, size=0.4):
    """Random triangle soup for property tests."""
    base = rng.uniform(lo, hi, (n, 3))
    p1 = base + rng.uniform(-size, size, (n, 3))
    p2 = base + rng.uniform(-size, size, (n, 3))
    return base, p1, p2
