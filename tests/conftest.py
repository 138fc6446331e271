import dataclasses
import os

# Force 8 host CPU devices so the multi-device paths (tile/frame sharding,
# shard-drop recovery) run for real in tier-1 instead of degenerating to a
# single-device mesh. Must happen before jax initializes its backend, which
# is why this sits above the `import jax` of this session-scoped conftest.
# Respect an explicit device-count flag from the environment (CI sets one).
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()

import jax                   # noqa: E402  (env mutation must precede this)
import jax.numpy as jnp      # noqa: E402
import pytest                # noqa: E402

from repro.core.gaussians import random_scene, project  # noqa: E402
from repro.core.camera import default_camera            # noqa: E402
from repro.core.culling import TileGrid                 # noqa: E402


@pytest.fixture(scope="session")
def small_scene():
    return random_scene(jax.random.PRNGKey(0), 800,
                        scale_range=(-2.9, -2.2), stretch=4.0,
                        opacity_range=(-1.5, 3.0), spiky_frac=0.4)


@pytest.fixture(scope="session")
def wall_scene():
    """Opaque near 'wall' in front of a large far population.

    Every pixel's transmittance collapses below T_EPS within the first
    ~hundred depth-ordered list entries while the compacted per-tile lists
    stay several K blocks long — the regime tile-level early termination
    targets (front-to-back blending makes everything behind the wall dead
    work)."""
    front = random_scene(jax.random.PRNGKey(1), 600,
                         scale_range=(-1.0, -0.6), stretch=1.2,
                         opacity_range=(3.5, 4.5), spiky_frac=0.0)
    back = random_scene(jax.random.PRNGKey(2), 2500,
                        scale_range=(-2.0, -1.6), stretch=1.5,
                        opacity_range=(0.0, 2.0))
    back = dataclasses.replace(back, means=back.means.at[:, 2].add(5.0))
    return jax.tree.map(lambda a, b: jnp.concatenate([a, b]), front, back)


@pytest.fixture(scope="session")
def cam64():
    return default_camera(64, 64)


@pytest.fixture(scope="session")
def grid64():
    return TileGrid(64, 64)


@pytest.fixture(scope="session")
def proj64(small_scene, cam64):
    return project(small_scene, cam64)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the CUDA kernels run only on "
        "the card); skips where torch.cuda.is_available() is False")
