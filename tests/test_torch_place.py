"""The build's placement on the device (``kernels.place``) against the
verbatim host build (``core.gaps.build_gapped``): every array of the
``GappedArray`` and of its PLM, element for element.

The CPU cases run ``build_gapped_device(..., device="cpu")`` over
sample rates 1.0 and 0.01, PGM and FITing, uniform keys and clustered
keys (whose sampled refit chains most keys), at the default chunk and
at a chunk of 97 keys that crosses hundreds of chunk boundaries,
chunks with no occupied key among them.  The ``gpu`` case holds the
CUDA placement of 2M keys to the host build, and its peak allocation
to the placement's budget scaled to its size; it skips without a
card.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Index
from repro_torch.core.gaps import build_gapped
from repro_torch.core.mechanisms import FITingMechanism, PGMMechanism
from repro_torch.kernels import place

MECHS = {"pgm": PGMMechanism, "fiting": FITingMechanism}
PLM_FIELDS = ("seg_first_key", "slope", "icept", "err_lo", "err_hi")
SMALL_CHUNK = 97
BUDGET_BYTES = 500_000_000    # the placement's device budget at 32M keys
BUDGET_KEYS = 32_000_000


@pytest.fixture(autouse=True)
def one_thread():
    # the CPU path runs hundreds of small torch ops; a thread pool on a
    # shared host costs each of them milliseconds
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return np.unique(rng.choice(1 << 32, n, replace=False)
                         ).astype(np.float64)
    # 40 runs of near-consecutive integers, far apart below 2^40
    starts = np.sort(rng.choice(1 << 40, 40, replace=False))
    run = n // 40
    return np.unique(np.concatenate(
        [s + np.arange(run) * rng.integers(1, 3) for s in starts])
    ).astype(np.float64)


def _builds(x, payloads, method, rate, device):
    """The host build and the device build from one seed, with the
    refit at eps 4, as ``Index.build`` refits eps 64."""
    cls = MECHS[method]
    args = dict(payloads=payloads, rho=0.15, sample_rate=rate,
                refit_factory=lambda: cls(eps=4))
    host = build_gapped(lambda: cls(eps=64), x,
                        rng=np.random.default_rng(3), **args)
    dev = place.build_gapped_device(lambda: cls(eps=64), x,
                                    rng=np.random.default_rng(3),
                                    device=device, **args)
    return host, dev


def _assert_same(host, dev):
    for name in ("slot_key", "occupied", "payload"):
        a, b = getattr(host, name), getattr(dev, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("offsets", "chain_keys", "chain_payloads"):
        a, b = getattr(host.links, name), getattr(dev.links, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert host.links.max_chain == dev.links.max_chain
    for name in PLM_FIELDS:
        a, b = getattr(host.mech.plm, name), getattr(dev.mech.plm, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (host.n_keys, host.rho) == (dev.n_keys, dev.rho)
    assert host.build_timings["n_fit"] == dev.build_timings["n_fit"]


@pytest.mark.parametrize("chunk_keys", [place.CHUNK_KEYS, SMALL_CHUNK],
                         ids=["chunk_default", "chunk_97"])
@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("method", ["pgm", "fiting"])
@pytest.mark.parametrize("rate", [1.0, 0.01])
def test_device_placement_equals_host_build(rate, method, kind, chunk_keys,
                                           monkeypatch):
    monkeypatch.setattr(place, "CHUNK_KEYS", chunk_keys)
    x = _keys(kind, 20_000, seed=1)
    payloads = np.random.default_rng(2).integers(0, 1 << 40, x.size)
    before = place.device_builds
    host, dev = _builds(x, payloads, method, rate, "cpu")
    _assert_same(host, dev)
    assert place.device_builds == before + 1
    assert dev.build_timings["place_device"] == "cpu"
    assert "place_device" not in host.build_timings
    if kind == "clustered" and rate < 1.0:
        assert host.links.total > x.size // 2   # heavy chaining
    if chunk_keys == SMALL_CHUNK and kind == "clustered" and rate < 1.0:
        # some chunk occupies no slot: all its keys chain onto the
        # cursor another chunk left
        slot = np.searchsorted(host.slot_key, x, side="right") - 1
        ends = slot[np.arange(SMALL_CHUNK - 1, x.size, SMALL_CHUNK)]
        assert np.any(ends[1:] == ends[:-1])


def test_cpu_index_build_places_on_the_host():
    x = _keys("uniform", 5_000, seed=4)
    before = place.device_builds
    idx = Index.build(x, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.01, rng=np.random.default_rng(5),
                      device="cpu")
    assert place.device_builds == before
    assert "place_device" not in idx.gapped.build_timings


@pytest.mark.gpu
def test_cuda_placement_equals_host_build_within_budget(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 2_000_000
    x = _keys("uniform", n, seed=6)
    payloads = np.random.default_rng(7).integers(0, 1 << 30, x.size)
    # the 32M-key configuration scaled to n keys: chunk and budget both
    monkeypatch.setattr(place, "CHUNK_KEYS",
                        place.CHUNK_KEYS * x.size // BUDGET_KEYS)
    budget = BUDGET_BYTES * x.size // BUDGET_KEYS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    host, dev = _builds(x, payloads, "pgm", 0.01, "cuda")
    peak = torch.cuda.max_memory_allocated() - base
    _assert_same(host, dev)
    assert dev.build_timings["place_device"] == "cuda"
    assert 0 < peak <= budget, (peak, budget)
    assert torch.cuda.memory_allocated() == base

    before = place.device_builds
    idx = Index.build(x, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.01, rng=np.random.default_rng(3),
                      payloads=payloads, device="cuda")
    assert place.device_builds == before + 1
    assert idx.gapped.build_timings["place_device"] == "cuda"
    _assert_same(host, idx.gapped)
