import os
import sys

import pytest

# Tests run on the single real CPU device (the 512-device override belongs to
# the dry-run ONLY — launch/dryrun.py sets it before jax import).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# hypothesis is optional: the property-based tests (test_properties.py) skip
# themselves via pytest.importorskip, but the suite as a whole must collect
# and run on machines without it.
try:
    from hypothesis import HealthCheck, settings
except ImportError:
    settings = None


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA Hopper card (sm_90); skips elsewhere")


@pytest.fixture(autouse=True, scope="module")
def _bounded_compile_cache():
    """jaxlib 0.4.37's CPU compiler segfaults in ``backend_compile`` once
    enough programs accumulate in one process (observed at ~600 tests:
    every module passes standalone, the combined run crashes).  Dropping
    compiled executables at module boundaries keeps the live program
    count bounded; modules recompile what they share, which is cheap
    next to the suite itself."""
    yield
    import jax                      # deferred: keep conftest import free
    jax.clear_caches()              # of jax side effects (see header)

if settings is not None:
    settings.register_profile(
        "ci", max_examples=20, deadline=None, derandomize=True,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile("ci")
