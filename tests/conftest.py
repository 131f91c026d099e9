"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see 1 device;
distributed behaviour is tested via subprocesses (test_distributed.py)."""
import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _clear_jit_caches():
    """Bound resident memory: compiled executables accumulate ~36 GB over
    the full suite on this 35 GB container (OOM-killed twice).  Dropping
    caches after every test keeps RSS flat at the cost of recompiles."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running validation tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips "
        "without one")
