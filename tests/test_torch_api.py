"""The port's public import surface against the reference's: the
``LearnedIndex`` deprecation facade (a verbatim copy over the port's
``Index``), every name of the ``__all__`` of ``repro.core``,
``repro.kernels``, ``repro.serving`` and ``repro.dist`` on the matching
``repro_torch`` package, ``kernels.resolve_chains`` on hits, chain hits
and misses, and ``BackendSpec.available``.  Inputs are made with numpy
from a seed and handed to both packages."""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_keys
from repro.core import LearnedIndex as RefLearnedIndex
from repro.kernels import ref as ref_ref
from repro_torch.core import BACKENDS, LearnedIndex
from repro_torch.kernels import ref as port_ref

PACKAGES = ("core", "kernels", "serving", "dist")


@pytest.mark.parametrize("gap_rho", [0.0, 0.2], ids=["static", "gapped"])
def test_learned_index_lookup_equals_the_references(gap_rho):
    """``LearnedIndex.build(...).lookup(q)`` returns the reference
    facade's array (positions for a static build, payloads for a gapped
    one, -1 for misses) and warns ``DeprecationWarning``."""
    x = make_keys("weblogs", 8_000, seed=7)
    rng = np.random.default_rng(7)
    q = np.concatenate([rng.choice(x, 500), x[:200] + 0.25])
    ref = RefLearnedIndex.build(x, method="pgm", eps=64, gap_rho=gap_rho)
    port = LearnedIndex.build(x, method="pgm", eps=64, gap_rho=gap_rho,
                              device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = port.lookup(q)
    assert any(issubclass(c.category, DeprecationWarning) for c in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref.lookup(q)
    assert isinstance(out, np.ndarray)
    assert np.array_equal(out, want)
    if gap_rho == 0.0:
        truth = np.where(np.isin(q, x), np.searchsorted(x, q), -1)
        assert np.array_equal(out, truth)


@pytest.mark.parametrize("package", PACKAGES)
def test_every_reference_name_resolves_on_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert missing == []
    assert set(ref.__all__) <= set(port.__all__)


def test_package_level_ingest_place_is_the_write_paths_entry_point():
    from repro_torch import kernels
    from repro_torch.kernels import ops_gap
    assert kernels.ingest_place is ops_gap.ingest_place
    assert kernels.gap_positions_device is ops_gap.gap_positions_device


def _chain_case(seed, n_slots=400):
    """Slot keys 10 apart; chains of 1-5 keys inside random gaps (the
    CSR link tables); queries: first-level hits, chain hits, keys in a
    gap that no chain holds, and keys below every slot."""
    rng = np.random.default_rng(seed)
    slot_key = (np.arange(n_slots) * 10.0).astype(np.float32)
    payload = rng.integers(0, 1 << 30, n_slots).astype(np.int32)
    lens = np.where(rng.random(n_slots) < 0.3,
                    rng.integers(1, 6, n_slots), 0)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    link_keys = np.concatenate(
        [s * 10.0 + np.sort(rng.choice(np.arange(1, 10), k, replace=False))
         for s, k in enumerate(lens) if k] or [np.zeros(0)]
    ).astype(np.float32)
    link_payloads = rng.integers(0, 1 << 30, link_keys.size).astype(np.int32)
    miss = np.setdiff1d(np.arange(n_slots) * 10.0 + 9.5, link_keys)
    q = np.concatenate([rng.choice(slot_key, 300), rng.choice(link_keys, 300),
                        rng.choice(miss, 200), [-5.0, -1.0]])
    q = rng.permutation(q).astype(np.float32)
    slot = (np.searchsorted(slot_key, q, side="right") - 1).astype(np.int32)
    found = (slot >= 0) & (slot_key[np.maximum(slot, 0)] == q)
    return (q, slot, found, payload, offsets, link_keys, link_payloads,
            int(lens.max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_chains_equals_the_references(seed):
    args = _chain_case(seed)
    *arrays, max_chain = args
    want = np.asarray(ref_ref.resolve_chains(
        *[jnp.asarray(a) for a in arrays], max_chain))
    got = port_ref.resolve_chains(
        *[torch.from_numpy(np.asarray(a)) for a in arrays], max_chain)
    assert np.array_equal(got.numpy(), want)
    q, slot, found = args[:3]
    hits = np.isin(q, args[5])
    # every outcome is exercised: first-level hits, chain hits, misses
    assert found.any() and (hits & ~found).any() and (want == -1).any()
    # no chains at all: first-level payloads, -1 elsewhere
    empty = port_ref.resolve_chains(
        *[torch.from_numpy(np.asarray(a)) for a in arrays[:5]],
        torch.zeros(0), torch.zeros(0, dtype=torch.int32), 0)
    assert np.array_equal(empty.numpy(),
                          np.where(found, args[3][np.maximum(slot, 0)], -1))


def test_backend_availability(monkeypatch):
    """Host backends are always available; ``pallas`` is picked only
    where its kernel is native (a CUDA card for the port)."""
    assert BACKENDS["numpy-oracle"].available()
    assert BACKENDS["fused"].available()
    assert BACKENDS["xla-windowed"].available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not BACKENDS["pallas"].available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert BACKENDS["pallas"].available()
