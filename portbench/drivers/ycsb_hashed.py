"""YCSB workload C over 63-bit hashed record keys: read-only closed-loop
YCSB clients over ``repro_torch.serving``'s ``MicroBatchQueue`` over an
``EpochPipeline``, on an index that holds the keys exactly.

The record keys are YCSB's under ``insertorder=hashed``:
``Utils.fnvhash64(keynum)`` for keynum 0 .. n_keys - 1 (``fnvhash64``),
deduplicated and sorted; payloads come from the configuration's
``data_seed``.  The clients, the window, the set-up's build, warm-up and
checkpoint and the release are ``drivers/serve.py``'s, imported; this
module draws the keys, serves read-only mixes only, and checks the
answers against ``reference_u64.py``, an exact map over 64-bit keys
(``reference.py``'s float64 map would merge neighbouring keys).

Present keys alone cannot tell an exact index from one that rounds keys
to float64: 20M hashed keys almost never share a float64, so rounding
answers every present key right.  So set-up first refuses a program
that rounds (a small index over keys 4,096 apart above 2^62, asked for
their neighbours, on the host), and after the window a probe sends the
neighbours ``k - 1`` and ``k + 1`` of ``PROBE_KEYS`` records drawn from
the seed (nearly all above 2^53, where float64 merges them with ``k``)
through the same queue and index, in requests of the mix's size with
the mix's clients in flight, and the check holds those answers, all but
never present, against the reference too (``neighbour_wrong``).  The
control is the reference at float64, the precision just below the
configuration's exact integers: it answers every present key right and
the neighbours wrong.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import gen
from portbench.harness import PB, load_module
from portbench.reference_u64 import PlainKV, count_wrong

_serve = load_module(PB / "drivers" / "serve.py")

FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
PROBE_KEYS = 1 << 17       # records whose two neighbours the probe asks for


def fnvhash64(keynums) -> np.ndarray:
    """YCSB's ``Utils.fnvhash64`` of non-negative keynums, vectorised:
    FNV-1a 64 over the keynum's 8 bytes, low byte first, then
    ``Math.abs`` of the signed result (``Long.MIN_VALUE`` stays 2^63),
    as uint64."""
    v = np.asarray(keynums, np.int64).astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, np.uint64)
    prime = np.uint64(FNV_PRIME_64)
    for _ in range(8):
        h ^= v & np.uint64(0xFF)
        h *= prime
        v >>= np.uint64(8)
    neg = h >= np.uint64(1 << 63)
    return np.where(neg, ~h + np.uint64(1), h)


def record_keys(n: int):
    """The sorted distinct record keys of keynums 0 .. n - 1 and the
    number of keynums whose key another keynum already took (a sort and
    a neighbour compare: ``np.unique`` takes 46 s at 20M uint64 keys
    under NumPy 2.3, where the sort takes 0.3 s)."""
    keys = np.sort(fnvhash64(np.arange(n, dtype=np.int64)))
    keys = keys[np.r_[True, keys[1:] != keys[:-1]]]
    return keys, int(n - keys.size)


class ControlFront(_serve.ControlFront):
    """``serve.py``'s control with ``reference_u64.py``'s map at
    float64 in the place of the serving stack."""

    def __init__(self, keys, payloads):
        super().__init__(keys[:1], payloads[:1])   # its float map, replaced
        self.ref = PlainKV(keys, payloads, torch.float64)


def refuse_rounding() -> None:
    """Raise unless the program holds 64-bit keys exactly: an index on
    the host over 256 keys 4,096 apart from 2^62 (distinct in float64)
    must answer each key found and each ``k + 1`` (which float64 rounds
    onto ``k``) not found."""
    from repro_torch.core import Index
    keys = np.uint64(1 << 62) + np.arange(256, dtype=np.uint64) * np.uint64(
        4096)
    try:
        idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                          sample_rate=1.0, payloads=np.arange(keys.size),
                          rng=np.random.default_rng(0), device="cpu")
        found = idx.lookup(np.concatenate([keys, keys + np.uint64(1)])).found
    except (TypeError, ValueError) as e:
        raise RuntimeError(f"the program cannot build or read 64-bit keys "
                           f"exactly: {e}") from e
    if not (found[:keys.size].all() and not found[keys.size:].any()):
        raise RuntimeError("the program rounds 64-bit keys: this "
                           "configuration's guarantee is exact equality "
                           "over 64-bit integer keys")


def setup(run) -> None:
    cfg, mix = run.config, run.mix
    if float(mix["write_request_share"]) > 0:
        raise ValueError("ycsb_hashed serves read-only mixes: the index's "
                         "64-bit image serves lookups only")
    if not run.control:
        refuse_rounding()
    t0 = time.perf_counter()
    run.keys, dups = record_keys(int(cfg["n_keys"]))
    t1 = time.perf_counter()
    run.payloads = gen.draw_payloads(gen.rng_for(cfg["data_seed"], 0),
                                     run.keys.size, int(cfg["payload_bits"]))
    run.zipf = gen.Zipf(run.keys.size, float(cfg["zipf_theta"]),
                        gen.rng_for(cfg["data_seed"], 5))
    clients = int(mix["clients"])
    run.warm_keys = run.keys[:0]
    run.client_fresh = [run.keys[:0]] * clients
    run.read_pools = [run.keys[run.zipf.draw(
        gen.rng_for(run.seed, 300 + i),
        (int(mix["read_pool"]), int(mix["read_keys"])))]
        for i in range(clients)]
    run.writes = []
    run.setup.update(inputs_s=time.perf_counter() - t0, keys_s=t1 - t0,
                     duplicate_keynums=dups, n_records=int(run.keys.size))
    run.tmp = tempfile.mkdtemp(prefix="portbench_ycsb_")
    if run.control:
        run.queue = ControlFront(run.keys, run.payloads)
        return
    queue = _serve._build(run)
    run.system = run.idx    # the set-up stage counters' readers read it
    t0 = time.perf_counter()
    _serve._warm(run, queue)
    run.setup["warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.pipe.checkpoint(Path(run.tmp) / "checkpoint", step=0)
    run.setup["checkpoint_s"] = time.perf_counter() - t0
    run.gaps_at_open = run.idx.gapped.gap_fraction


def window(run) -> None:
    """``serve.py``'s window; its record adds the index's lookups in the
    window, and those on the 64-bit image (``lookups_u64``, where the
    program counts them)."""
    idx = getattr(run, "idx", None)
    s0 = dict(idx.stats) if idx is not None else {}
    _serve.window(run)
    if idx is not None:
        info = run.layer["info"]
        info["lookups"] = idx.stats["lookups"] - s0["lookups"]
        if "lookups_u64" in idx.stats:
            info["lookups_u64"] = (idx.stats["lookups_u64"]
                                   - s0.get("lookups_u64", 0))


def probe(run) -> None:
    """The neighbours ``k - 1`` and ``k + 1`` of ``PROBE_KEYS`` records
    drawn from the seed, shuffled, through the serving stack as the
    window left it: requests of ``read_keys``, ``clients`` of them in
    flight at a time, as the clients send them.  Their answers go to
    ``run.probe``."""
    mix = run.mix
    rng = gen.rng_for(run.seed, 400)
    pick = run.keys[rng.integers(0, run.keys.size, PROBE_KEYS)]
    pick = pick[pick > 0]
    q = np.concatenate([pick - np.uint64(1), pick + np.uint64(1)])
    q = q[rng.permutation(q.size)]
    rk, clients = int(mix["read_keys"]), int(mix["clients"])
    reqs = [q[i:i + rk] for i in range(0, q.size, rk)]
    run.probe = []
    for i in range(0, len(reqs), clients):
        group = reqs[i:i + clients]
        tickets = [run.queue.submit_lookup(r) for r in group]
        for r, t in zip(group, tickets):
            res = run.queue.result(t)
            run.probe.append((r, res.payloads, res.found))


def release(run) -> None:
    """The neighbour probe, where the window ran, then ``serve.py``'s
    release."""
    try:
        if getattr(run, "kept", None) is not None and hasattr(run, "queue"):
            probe(run)
    finally:
        run.__dict__.pop("system", None)
        _serve.release(run)


def check(run) -> dict:
    ref = PlainKV(run.keys, run.payloads)
    wrong = sum(count_wrong(ref, q, pay, found)
                for q, pay, found, _epoch in run.kept)
    stale = sum(r[5] < r[4] for r in run.reads)
    probed = getattr(run, "probe", [])
    answered = sum(r[0].size for r in probed)
    # a probe that did not run counts every neighbour it would have asked
    neighbour = (sum(count_wrong(ref, *r) for r in probed) if probed
                 else 2 * PROBE_KEYS)
    info = run.layer.setdefault("info", {})
    info["checked_answers"] = sum(k[0].size for k in run.kept)
    info["probe_answers"] = answered
    return {"wrong_answers": (wrong, 0), "stale_reads": (stale, 0),
            "neighbour_wrong": (neighbour, 0)}
