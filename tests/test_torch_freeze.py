"""The port's host build and freeze equal the reference's, array for
array: the verbatim core copies (and the verbatim serving, robustness
and data copies, the trainer's fault primitives, with
``MicroBatchQueue`` held by its syntax tree; ``serving/pipeline.py``
and ``MicroBatchQueue`` keep the index's key dtype for exact 64-bit
keys, and the queue adds spans and two counters: each departure is
named below as text and undone before the comparison),
the copied numpy freeze/sizing helpers and the device freeze's
functions (run on the CPU) on the same builds, the copied ``configs/``,
and whole builds at sample_rate 1.0 and 0.01 with equal seeds.  Inputs are
made with numpy from a seed and handed to both."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Index as RefIndex
from repro.kernels import ops as ref_ops
from repro_torch.core import Index
from repro_torch.kernels import bounds, delta, freeze

ROOT = Path(__file__).resolve().parents[1]
COPIED = ("links", "mechanisms", "sampling", "gaps", "results", "mdl",
          "tuning", "index")
COPIED_OUTSIDE_CORE = ("robustness/__init__.py", "robustness/faults.py",
                       "serving/pipeline.py", "data/__init__.py",
                       "data/token_store.py", "data/pipeline.py",
                       "train/fault.py")
CONFIG_FILES = tuple(sorted(
    p.name for p in (ROOT / "src" / "repro" / "configs").glob("*.py")))


@pytest.mark.parametrize("name", COPIED)
def test_core_copies_are_verbatim(name):
    ref = (ROOT / "src" / "repro" / "core" / f"{name}.py").read_bytes()
    port = (ROOT / "src" / "repro_torch" / "core" / f"{name}.py").read_bytes()
    assert port == ref


# (port text, reference text): each departure of a copied file, undone
# before the byte comparison (each must occur exactly once)
DEPARTURES = {"serving/pipeline.py": (
    ('''is ``serving.wal.recover_index``.

The module is the reference's, with one departure: it keeps the index's
key dtype (``key_dtype``: float64, or uint64 for an index on the exact
64-bit image, ``core.keys64``) through ``IndexSnapshot.lookup``, and
``ingest`` refuses keys that need that image before the WAL logs them
(``keys64.write_keys``), so nothing rounds a 64-bit key.
"""''', '''is ``serving.wal.recover_index``.
"""'''),
    ("from ..core import keys64 as _k64\n", ""),
    ("        self._u64 = _k64.is_u64(index.keys)\n", ""),
    ('''        queries = np.atleast_1d(np.asarray(queries) if self._u64 else
                                np.asarray(queries, np.float64))
        pay, slot, found = self._snap''',
     '''        queries = np.atleast_1d(np.asarray(queries, np.float64))
        pay, slot, found = self._snap'''),
    ('''

    @property
    def key_dtype(self) -> np.dtype:
        return getattr(self.index, "key_dtype", np.dtype(np.float64))''',
     ""),
    ('''        keys = np.atleast_1d(_k64.write_keys(
            keys, "EpochPipeline.ingest", self.key_dtype == np.uint64))''',
     '''        keys = np.atleast_1d(np.asarray(keys, np.float64))'''),
)}


@pytest.mark.parametrize("path", COPIED_OUTSIDE_CORE)
def test_serving_and_robustness_copies_are_verbatim(path):
    ref = (ROOT / "src" / "repro" / path).read_text()
    port = (ROOT / "src" / "repro_torch" / path).read_text()
    for mine, theirs in DEPARTURES.get(path, ()):
        assert port.count(mine) == 1, mine
        port = port.replace(mine, theirs)
    assert port == ref


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_copies_are_verbatim(name):
    """``configs/`` is copied byte for byte: the package, ``base.py``
    and the ten architecture files."""
    ref = (ROOT / "src" / "repro" / "configs" / name).read_bytes()
    port = (ROOT / "src" / "repro_torch" / "configs" / name).read_bytes()
    assert port == ref


def test_config_copies_cover_the_reference():
    port = sorted(p.name for p in
                  (ROOT / "src" / "repro_torch" / "configs").glob("*.py"))
    assert port == list(CONFIG_FILES) and len(CONFIG_FILES) == 12


def _class_tree(text, name):
    tree = ast.parse(text)
    node = next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == name)
    return ast.dump(node, include_attributes=False)


# (port text, reference text): ``MicroBatchQueue``'s departures, undone
# before its syntax tree is compared: the key dtype kept through the
# submits and the staging buffers, the counters ``lookup_keys`` and
# ``lookup_wait_ms_sum`` (with each request's submit time), and the
# lookup dispatch moved into ``_flush_lookups`` under its spans
DEPARTURES["serving/engine.py"] = (
    ('''                      "host_fallbacks": 0, "lookup_keys": 0,
                      "lookup_wait_ms_sum": 0.0}''',
     '''                      "host_fallbacks": 0}'''),
    ('''    def _key_dtype(self):
        return getattr(self.index, "key_dtype", np.dtype(np.float64))

''', ""),
    ('''        keys = np.atleast_1d(_k64.lookup_keys(keys, self._key_dtype()))
        if keys.shape[0] == 0:
            raise ValueError("submit_lookup''',
     '''        keys = np.atleast_1d(np.asarray(keys, np.float64))
        if keys.shape[0] == 0:
            raise ValueError("submit_lookup'''),
    ("            self._lookups.append((t, keys, time.perf_counter()))\n",
     "            self._lookups.append((t, keys))\n"),
    ('''        keys = np.atleast_1d(_k64.write_keys(
            keys, "MicroBatchQueue.submit_ingest",
            self._key_dtype() == np.uint64))''',
     '''        keys = np.atleast_1d(np.asarray(keys, np.float64))'''),
    ('''        key = (name, bucket, np.dtype(dtype).str)
        buf = self._staging.get(key)
        if buf is None:
            buf = np.empty(bucket, dtype)
            self._staging[key] = buf''',
     '''        buf = self._staging.get((name, bucket))
        if buf is None:
            buf = np.empty(bucket, dtype)
            self._staging[(name, bucket)] = buf'''),
    ('''                with span("queue.flush"):
                    self._flush_lookups()
            self.stats["flushes"] += 1

    def _flush_lookups(self) -> None:
        """One coalesced lookup dispatch of everything pending.

        lock-held: _lock (only reached from flush())."""
        t_take = time.perf_counter()
        pend, self._lookups = self._lookups, []
        with span("queue.stage"):
            sizes = [k.shape[0] for _, k, _ in pend]
            n = int(sum(sizes))
            bucket = self._bucket(n)
            buf = self._stage("lookup", bucket, self._key_dtype())
            off = 0
            for _, k, _ in pend:
                buf[off: off + k.shape[0]] = k
                off += k.shape[0]
            buf[off:] = buf[off - 1]  # pad: repeat the last real key
        with span("queue.dispatch"):
            res = self.index.lookup(buf)
        with span("queue.scatter"):
            off = 0
            for (t, k, _), sz in zip(pend, sizes):
                sl = slice(off, off + sz)
                self._results[t] = dataclasses.replace(
                    res, payloads=res.payloads[sl],
                    slots=res.slots[sl], found=res.found[sl])
                off += sz
        self.stats["lookup_dispatches"] += 1
        self.stats["coalesced_lookups"] += len(pend)
        self.stats["lookup_keys"] += n
        self.stats["lookup_wait_ms_sum"] += 1e3 * sum(
            t_take - ts for _, _, ts in pend)
''',
     '''                pend, self._lookups = self._lookups, []
                sizes = [k.shape[0] for _, k in pend]
                n = int(sum(sizes))
                bucket = self._bucket(n)
                buf = self._stage("lookup", bucket, np.float64)
                off = 0
                for _, k in pend:
                    buf[off: off + k.shape[0]] = k
                    off += k.shape[0]
                buf[off:] = buf[off - 1]  # pad: repeat the last real key
                res = self.index.lookup(buf)
                off = 0
                for (t, k), sz in zip(pend, sizes):
                    sl = slice(off, off + sz)
                    self._results[t] = dataclasses.replace(
                        res, payloads=res.payloads[sl],
                        slots=res.slots[sl], found=res.found[sl])
                    off += sz
                self.stats["lookup_dispatches"] += 1
                self.stats["coalesced_lookups"] += len(pend)
            self.stats["flushes"] += 1
'''),
    ("            pending = (any(t == ticket for t, _, _ in self._lookups)\n",
     "            pending = (any(t == ticket for t, _ in self._lookups)\n"),
)


def test_micro_batch_queue_is_the_references_class():
    """``MicroBatchQueue`` is the reference's class: with each named
    departure undone, its syntax tree (body, docstrings and decorators)
    equals the reference's."""
    ref = (ROOT / "src" / "repro" / "serving" / "engine.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "serving" /
            "engine.py").read_text()
    for mine, theirs in DEPARTURES["serving/engine.py"]:
        assert port.count(mine) == 1, mine
        port = port.replace(mine, theirs)
    assert (_class_tree(port, "MicroBatchQueue")
            == _class_tree(ref, "MicroBatchQueue"))


def _keys(seed, span, n=25_000):
    rng = np.random.default_rng(seed)
    return np.unique(rng.choice(span, n, replace=False)).astype(np.float64)


def _pair(seed, span, wide_payloads=False, sample_rate=1.0):
    """The same build in both packages (chains forced by mid inserts)."""
    keys = _keys(seed, span)
    pay = ((np.int64(3) << 40) + np.arange(keys.size, dtype=np.int64)
           if wide_payloads else None)
    kw = dict(method="pgm", eps=64, gap_rho=0.15, payloads=pay,
              sample_rate=sample_rate)
    ref = RefIndex.build(keys, rng=np.random.default_rng(seed), **kw)
    port = Index.build(keys, rng=np.random.default_rng(seed), device="cpu",
                       **kw)
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5),
                        keys)[:2000]
    for idx in (ref, port):
        idx.gapped.insert_batch(mids, 7_000_000 + np.arange(mids.size))
    return keys, ref, port


CASES = [("narrow", 0, 2 ** 22, False), ("wide", 1, 2 ** 40, False),
         ("wide_payload", 2, 2 ** 40, True)]


def _assert_same_build(ref, port):
    rg, pg = ref.gapped, port.gapped
    for f in ("slot_key", "occupied", "payload"):
        assert np.array_equal(getattr(rg, f), getattr(pg, f)), f
    for a, b in zip(rg.export_csr_links(), pg.export_csr_links()):
        assert np.array_equal(a, b)
    rp, pp = ref.mech.plm, port.mech.plm
    for f in ("seg_first_key", "slope", "icept", "err_lo", "err_hi"):
        assert np.array_equal(getattr(rp, f), getattr(pp, f)), f
    assert rp.n_keys == pp.n_keys


@pytest.mark.parametrize("sample_rate", [1.0, 0.01])
def test_build_equals_reference(sample_rate):
    _keys_, ref, port = _pair(3, 2 ** 40, sample_rate=sample_rate)
    _assert_same_build(ref, port)


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def _assert_device_freeze_equals_reference(ref, port, monkeypatch):
    """The device freeze's functions, run on the CPU, against the
    reference on the same build: the window bounds bit for bit, the
    images at the device freeze's headroom element for element, and the
    radix and rank routers of its images; the rank router also at
    chunks of 97 slot keys."""
    slot_key = torch.from_numpy(port.gapped.slot_key.copy())
    rlo, rhi = ref_ops.query_window_bounds(ref)
    dlo, dhi = bounds.query_window_bounds_device(port, slot_key)
    assert np.array_equal(_bits(rlo), _bits(dlo))
    assert np.array_equal(_bits(rhi), _bits(dhi))
    key_wide = freeze.key_wide_device(port, slot_key)
    arrays, statics = freeze.freeze_headroom_device(port, "cpu",
                                                    key_wide=key_wide)
    images, r_statics = ref_ops._freeze_numpy(
        ref, max_chain=statics["max_chain"], link_cap=statics["link_cap"])
    assert r_statics == statics
    for f, img in images.items():
        t = getattr(arrays, f).numpy()
        assert t.dtype == img.dtype and np.array_equal(t, img), f
    for a, b in zip(ref_ops.build_radix_router(
                        ref_ops.from_learned_index(ref)),
                    bounds.build_radix_router(arrays)):
        assert np.array_equal(a, b)
    r_rank = ref_ops.build_rank_router(
        images["slot_key"], images["slot_key_lo"] if key_wide else None)
    for chunk in (bounds.RANK_CHUNK, 97):
        monkeypatch.setattr(bounds, "RANK_CHUNK", chunk)
        p_rank = bounds.build_rank_router(
            arrays.slot_key, arrays.slot_key_lo if key_wide else None)
        for a, b in zip(r_rank, p_rank):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name,seed,span,wpay", CASES,
                         ids=[c[0] for c in CASES])
def test_freeze_helpers_equal_reference(name, seed, span, wpay, monkeypatch):
    keys, ref, port = _pair(seed, span, wide_payloads=wpay)
    _assert_same_build(ref, port)
    # split_key_pair on keys, absent queries and non-finite values
    probe = np.concatenate([keys, keys + 0.5, [np.inf, -np.inf, -3.0]])
    for a, b in zip(ref_ops.split_key_pair(probe),
                    freeze.split_key_pair(probe)):
        assert np.array_equal(a, b)
    for fn in ("keys_need_pair", "keys_pair_exact", "pair_alias_free"):
        assert getattr(ref_ops, fn)(keys) == getattr(freeze, fn)(keys)
    # the padded images, with and without frozen headroom
    for kw in ({}, {"max_chain": 64, "link_cap": 1 << 14}):
        ra, rs = ref_ops._freeze_numpy(ref, **kw)
        pa, ps = freeze._freeze_numpy(port, **kw)
        assert rs == ps
        assert ra.keys() == pa.keys()
        for f in ra:
            assert ra[f].dtype == pa[f].dtype, f
            assert np.array_equal(ra[f], pa[f]), f
    assert ps["key_wide"] == (span > 2 ** 24)
    assert ps["wide"] == wpay
    # window bounds, the radix router and the sizing rules
    rlo, rhi = ref_ops.query_window_bounds(ref)
    plo, phi = bounds.query_window_bounds(port)
    assert np.array_equal(rlo, plo) and np.array_equal(rhi, phi)
    rt, rsc = ref_ops.build_radix_router(ref_ops.from_learned_index(ref))
    pt, psc = bounds.build_radix_router(freeze.from_learned_index(port,
                                                                  "cpu"))
    assert np.array_equal(rt, pt) and np.array_equal(rsc, psc)
    ra = ref_ops.from_learned_index(ref)
    r_rank = ref_ops.build_rank_router(
        np.asarray(ra.slot_key),
        np.asarray(ra.slot_key_lo) if ra.key_wide else None)
    p_rank = bounds.build_rank_router(
        ra.slot_key, ra.slot_key_lo if ra.key_wide else None)
    for a, b in zip(r_rank, p_rank):
        assert np.array_equal(a, b)
    _assert_device_freeze_equals_reference(ref, port, monkeypatch)
    for fn in ("_bisect_trips", "_flat_width", "_fused_flat_width"):
        assert getattr(ref_ops, fn)(rlo, rhi) == getattr(bounds, fn)(plo,
                                                                     phi)
    for n_q in (1, 512, 4096, 1 << 20):
        assert (ref_ops.auto_q_tile(n_q, ref.gapped.n_slots, 2048)
                == bounds.auto_q_tile(n_q, port.gapped.n_slots, 2048))


def test_frozen_tensors_equal_numpy_images():
    _keys_, _ref, port = _pair(4, 2 ** 40)
    engine, mirror = delta.freeze_state(port, "cpu")
    arrays, statics = engine.arrays, mirror.statics
    images, _ = freeze._freeze_numpy(port, max_chain=statics["max_chain"],
                                     link_cap=statics["link_cap"])
    for f, img in images.items():
        assert np.array_equal(getattr(arrays, f).numpy(), img), f
    assert arrays.nbytes() == sum(a.nbytes for a in images.values())
