"""Shared fixtures.  NOTE: no XLA_FLAGS here — scripts/tier1.sh scopes
``--xla_force_host_platform_device_count=8`` to the pytest COMMAND only
(so tests/test_sharded_index.py exercises the real shard_map all-to-all
over 8 host devices), while the benchmark smoke step in the same script
still sees the real single CPU device; launch/dryrun.py forces its 512
placeholder devices in its own process.  Every test must also pass at
1 device (plain ``pytest``): the fan-out degenerates to D=1."""

import numpy as np
import pytest


def make_keys(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """Synthetic key sets matching the paper's dataset families (small)."""
    rng = np.random.default_rng(seed)
    if kind == "weblogs":  # bursty periodic timestamps
        base = rng.exponential(1.0, n) * (1.0 + 8.0 * (rng.random(n) < 0.02))
        burst = 5.0 * np.sin(np.linspace(0, 40 * np.pi, n)) ** 2
        return np.unique(np.cumsum(base + burst))
    if kind == "iot":  # noisy multi-source timestamps
        srcs = [np.cumsum(rng.exponential(s, n // 4)) for s in (0.5, 1.0, 2.0, 5.0)]
        return np.unique(np.concatenate(srcs))
    if kind == "longitude":  # beta-mixture coordinates
        a = rng.beta(2, 5, n // 2) * 360 - 180
        b = rng.beta(8, 2, n - n // 2) * 360 - 180
        return np.unique(np.concatenate([a, b]))
    if kind == "uniform_int":  # f32-exact integer grid
        return np.unique(rng.choice(2 ** 22, n, replace=False)).astype(np.float64)
    raise KeyError(kind)


@pytest.fixture(scope="session")
def small_keys():
    return make_keys("weblogs", 20_000, seed=1)


@pytest.fixture(scope="session")
def int_keys():
    return make_keys("uniform_int", 30_000, seed=2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself "
        "without one")
