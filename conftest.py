"""Repo-root pytest conftest: put the package on sys.path and pick the backend.

By default the suite runs on an 8-device *virtual CPU* mesh (SURVEY.md §4.3),
which exercises the real shard_map/collective code paths without a card.
Set RGBD_TESTS_ON_GPU=1 to run on the GPU instead; tests marked ``gpu`` need
the card and skip on any other backend (chip_smoke.py covers what they do on
the card).
"""

import os
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.resolve()))

if os.environ.get("RGBD_TESTS_ON_GPU") != "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests off the card (decided per test, not at
    import time, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU; chip_smoke.py covers this on the card")
