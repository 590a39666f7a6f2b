"""Serving: closed-loop YCSB clients over ``repro_torch.serving``'s
``MicroBatchQueue`` over an ``EpochPipeline`` with an ``IngestWAL``.

Each client is a thread of its own with one request in flight, as the
program's callers run: it submits, waits out the queue's deadline (the
queue's timer thread flushes every pending request as one dispatch per
kind) and takes its result, which flushes the request itself where the
timer has not.  A request is a write (a batch of fresh keys, the
midpoints of gaps, with payloads) with the mix's probability, else a
multi-get of zipfian record keys from the client's pool of
``read_pool`` reads drawn in set-up (in turn), of which a share is
replaced by keys this client wrote earlier.  Each client draws from its
own generators, so the k-th request of a client is the same in every
run of a seed; how requests meet in a dispatch is the program's doing.

Set-up builds and freezes the index, warms the lookup buckets the mix
can coalesce to (and, where the mix writes, the write path with two
ingests of the sizes the clients coalesce to), then takes one
checkpoint.  The WAL and the checkpoint live in a temporary directory
under ``TMPDIR``, removed at the end.

The check holds a sample of the reads, drawn from the seed, against the
plain reference as of the epoch each answer reports; counts reads that
report an epoch older than a write acknowledged before they were
submitted; and counts acknowledged written keys that the WAL, as it
stood when the write was acknowledged, had not logged below a fence.
"""

from __future__ import annotations

import gc
import os
import shutil
import statistics
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np

from portbench import gen, walread
from portbench.harness import Reservoir, p95, per_second
from portbench.reference import KVReference, count_wrong

CHECK_KEYS = 1 << 23       # read answers held against the reference a run


class ControlFront:
    """The reference at float32 in the place of the serving stack: a
    queue whose tickets resolve on ``result``."""

    max_wait_ms = 0.0

    def __init__(self, keys, payloads):
        self.ref = KVReference(keys, payloads, np.float32)
        self.epoch = 0
        self.writes = ([], [], [])
        self._lock = threading.Lock()
        self._pending = {}
        self._next = 0

    def _submit(self, item) -> int:
        with self._lock:
            t, self._next = self._next, self._next + 1
            self._pending[t] = item
            return t

    def submit_lookup(self, keys):
        return self._submit(("lookup", np.asarray(keys, np.float64)))

    def submit_ingest(self, keys, payloads):
        return self._submit(("ingest", keys, payloads))

    def result(self, ticket):
        with self._lock:
            item = self._pending.pop(ticket)
            if item[0] == "lookup":
                pay, found = self.ref.answer(item[1])
                return types.SimpleNamespace(payloads=pay, found=found,
                                             epoch=self.epoch)
            self.epoch += 1
            for acc, part in zip(self.writes,
                                 (item[1], item[2],
                                  np.full(item[1].size, self.epoch))):
                acc.append(part)
            self.ref.set_writes(*(np.concatenate(a) for a in self.writes))
            return types.SimpleNamespace(epoch=self.epoch)


def _build(run):
    from repro_torch.core import Index
    from repro_torch.serving import EpochPipeline, IngestWAL, MicroBatchQueue
    cfg = run.config
    ix = dict(cfg["index"])
    idx = Index.build(run.keys, method=ix.pop("method"),
                      sample_rate=ix.pop("sample_rate"),
                      gap_rho=ix.pop("gap_rho"), payloads=run.payloads,
                      rng=gen.rng_for(cfg["data_seed"], 2),
                      device=run.device, **ix)
    idx.sync_device()
    run.setup.update(build_s=idx.build_seconds,
                     freeze_s=idx.stats["freeze_seconds"],
                     n_slots=int(idx.gapped.n_slots),
                     device_bytes=int(idx.device_bytes()))
    srv = cfg["serving"]
    run.wal_path = Path(run.tmp) / "serve.wal"
    wal = IngestWAL(run.wal_path, sync_every=srv["wal_sync_every"])
    pipe = EpochPipeline(idx, wal=wal, publish_every=srv["publish_every"])
    queue = MicroBatchQueue(pipe, max_wait_ms=srv["max_wait_ms"],
                            max_depth=srv["max_depth"])
    run.idx, run.pipe, run.queue = idx, pipe, queue
    return queue


def _warm(run, queue) -> None:
    """Every lookup bucket the clients can coalesce to, until a call
    meets no oracle escape (at most five); where the mix writes, two
    ingests: one client's batch and all clients' together."""
    mix = run.mix
    clients, rk, wk = (int(mix["clients"]), int(mix["read_keys"]),
                       int(mix["write_keys"]))
    rng = gen.rng_for(run.seed, 6)
    if mix["write_request_share"] > 0:
        warm = run.warm_keys
        for lo, hi in ((0, wk), (wk, wk * clients)):
            k = warm[lo:hi]
            p = gen.draw_payloads(rng, k.size, int(run.config["payload_bits"]))
            rep = queue.result(queue.submit_ingest(k, p))
            run.writes.append((k, p, int(rep.epoch), None, None, None))
    for n in range(1, clients + 1):
        for _ in range(5):
            tickets = [queue.submit_lookup(
                run.keys[run.zipf.draw(rng, rk)]) for _ in range(n)]
            # the first result flushes what the deadline has not
            res = [queue.result(t) for t in tickets]
            if res[0].oracle_escapes == 0:
                break


def setup(run) -> None:
    cfg, mix = run.config, run.mix
    t0 = time.perf_counter()
    rng = gen.rng_for(cfg["data_seed"], 0)   # the deployment's data
    run.keys = gen.draw_keys(rng, int(cfg["n_keys"]), int(cfg["key_bits"]))
    run.payloads = gen.draw_payloads(rng, run.keys.size,
                                     int(cfg["payload_bits"]))
    run.zipf = gen.Zipf(run.keys.size, float(cfg["zipf_theta"]),
                        gen.rng_for(cfg["data_seed"], 5))
    clients, wk = int(mix["clients"]), int(mix["write_keys"])
    fresh = gen.fresh_keys(gen.rng_for(run.seed, 4), run.keys)
    n_warm = wk * clients if mix["write_request_share"] > 0 else 0
    run.warm_keys = fresh[:n_warm]
    run.client_fresh = [fresh[n_warm + i::clients] for i in range(clients)]
    # each client's reads, drawn in set-up: a client's request costs the
    # server's process nothing before it is submitted
    run.read_pools = [run.keys[run.zipf.draw(
        gen.rng_for(run.seed, 300 + i),
        (int(mix["read_pool"]), int(mix["read_keys"])))]
        for i in range(clients)]
    # (keys, payloads, epoch, submit_t, ack_t, the WAL's end at the ack)
    run.writes = []
    run.setup["inputs_s"] = time.perf_counter() - t0
    run.tmp = tempfile.mkdtemp(prefix="portbench_serve_")
    if run.control:
        run.queue = ControlFront(run.keys, run.payloads)
        return
    queue = _build(run)
    t0 = time.perf_counter()
    _warm(run, queue)
    run.setup["warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.pipe.checkpoint(Path(run.tmp) / "checkpoint", step=0)
    run.setup["checkpoint_s"] = time.perf_counter() - t0
    run.gaps_at_open = run.idx.gapped.gap_fraction


class _Client:
    """One client's request stream: its own generator, read pool and
    fresh keys, so its k-th request is the same in every run of a
    seed."""

    def __init__(self, run, i):
        mix = run.mix
        self.rng = gen.rng_for(run.seed, 100 + i)
        self.rk, self.wk = int(mix["read_keys"]), int(mix["write_keys"])
        self.w_share = float(mix["write_request_share"])
        self.own = int(self.rk * float(mix["read_written_share"]))
        self.pay_bits = int(run.config["payload_bits"])
        self.fresh, self.pool = run.client_fresh[i], run.read_pools[i]
        self.written = self.n_reads = self.shed = 0
        self.recs = []
        self.keep = Reservoir(max(1, CHECK_KEYS // (self.rk * len(
            run.read_pools))), gen.rng_for(run.seed, 200 + i))

    def request(self):
        if self.rng.random() < self.w_share:
            if self.written + self.wk > self.fresh.size:
                raise RuntimeError("the client's fresh keys ran out")
            k = self.fresh[self.written:self.written + self.wk]
            return "write", k, gen.draw_payloads(self.rng, self.wk,
                                                 self.pay_bits)
        q = self.pool[self.n_reads % len(self.pool)].copy()
        self.n_reads += 1
        if self.written and self.own:
            q[:self.own] = self.fresh[self.rng.integers(0, self.written,
                                                        self.own)]
        return "read", q, None


def window(run) -> None:
    """The clients' threads run until the window closes; a request in
    flight then finishes, and counts where it finished in the window."""
    idx, queue = getattr(run, "idx", None), run.queue
    q0 = dict(getattr(queue, "stats", {}))
    s0 = dict(idx.stats) if idx is not None else {}
    engine = idx._engine if idx is not None else None
    e0 = dict(engine.stats) if engine is not None else {}
    clients = [_Client(run, i) for i in range(int(run.mix["clients"]))]
    shared = types.SimpleNamespace(
        lock=threading.Lock(), errors=[],
        acked=max([w[2] for w in run.writes], default=0))
    wait = float(queue.max_wait_ms or 0) / 1e3
    wal = getattr(run, "wal_path", None)

    def loop(c):
        try:
            while time.perf_counter() < deadline:
                kind, keys, pays = c.request()
                with shared.lock:
                    floor = shared.acked
                t0 = time.perf_counter()
                with run.span("pb.submit"):
                    t = (queue.submit_ingest(keys, pays) if kind == "write"
                         else queue.submit_lookup(keys))
                time.sleep(wait)
                with run.span("pb.result"):
                    res = queue.result(t)
                t1 = time.perf_counter()
                if type(res).__name__ == "Overloaded":
                    c.shed += 1
                elif kind == "write":
                    # the log's end as the acknowledgement found it
                    at = os.path.getsize(wal) if wal is not None else None
                    c.written += c.wk
                    c.recs.append(("write", t0, t1, c.wk))
                    with shared.lock:
                        shared.acked = max(shared.acked, int(res.epoch))
                        run.writes.append((keys, pays, int(res.epoch),
                                           t0, t1, at))
                else:
                    c.recs.append(("read", t0, t1, c.rk, floor,
                                   int(res.epoch)))
                    c.keep.offer((keys, res.payloads, res.found,
                                  int(res.epoch)))
        except BaseException as e:   # re-raised by the window's thread
            with shared.lock:
                shared.errors.append(e)

    threads = [threading.Thread(target=loop, args=(c,), daemon=True)
               for c in clients]
    run.t_open = time.perf_counter()
    deadline = run.t_open + run.seconds
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=run.seconds + 120)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a serving client did not finish")
    if shared.errors:
        raise shared.errors[0]
    recs = [r for c in clients for r in c.recs]
    shed = sum(c.shed for c in clients)
    run.kept = [k for c in clients for k in c.keep.items]
    run.attempted = len(recs) + shed
    run.failed = shed
    done = [r for r in recs if r[2] <= deadline]
    run.e2e["serve_keys_per_s"] = sum(r[3] for r in done) / run.seconds
    run.reads = [r for r in recs if r[0] == "read"]
    lay = run.layer
    lay["read_ms"] = [(r[2] - r[1]) * 1e3 for r in done if r[0] == "read"]
    lay["write_ms"] = [(r[2] - r[1]) * 1e3 for r in done if r[0] == "write"]
    done.sort(key=lambda r: r[2])
    info = {"reads": len(run.reads), "writes": len(recs) - len(run.reads),
            "shed": shed,
            "keys_per_second": per_second(
                [r[2] for r in done], run.t_open, run.seconds,
                [r[3] for r in done])}
    for name in ("read_ms", "write_ms"):
        if len(lay[name]) >= 20:
            info[name.replace("_ms", "_p50_p95_ms")] = [
                statistics.median(lay[name]), p95(lay[name])]
    if idx is not None:
        q1, s1 = queue.stats, idx.stats
        lay["lookup_dispatches"] = (q1["lookup_dispatches"]
                                    - q0["lookup_dispatches"])
        lay["coalesced_lookups"] = (q1["coalesced_lookups"]
                                    - q0["coalesced_lookups"])
        lay["ingests"] = s1["ingests"] - s0["ingests"]
        lay["fused_ingests"] = (s1.get("fused_ingests", 0)
                                - s0.get("fused_ingests", 0))
        gaps = run.idx.gapped.gap_fraction
        # a refreeze replaces the engine, and its counts start anew
        same = idx._engine is engine
        info.update(queue={k: q1[k] - q0.get(k, 0) for k in q1},
                    engine={k: engine.stats[k] - e0[k] for k in
                            ("calls", "fallbacks", "oracle_escapes")}
                    if same else "replaced by a refreeze",
                    ingests=lay["ingests"], fused_ingests=lay["fused_ingests"],
                    refreezes=s1["refreezes"] - s0["refreezes"],
                    delta_updates=s1["delta_updates"] - s0["delta_updates"],
                    gap_fraction=[run.gaps_at_open, gaps],
                    gaps_filled_share=1.0 - gaps / run.gaps_at_open)
    lay["info"] = info


def release(run) -> None:
    """Reads the WAL as the window left it (before the close syncs it),
    stops the serving stack and removes the run's directory."""
    try:
        wal = getattr(run, "wal_path", None)
        if wal is not None and wal.exists():
            run.wal_log = walread.read_log(wal)
        for name in ("queue", "pipe"):
            obj = getattr(run, name, None)
            if obj is not None and hasattr(obj, "close"):
                obj.close()
    finally:
        if getattr(run, "tmp", None):
            shutil.rmtree(run.tmp, ignore_errors=True)
    for name in ("queue", "pipe", "idx"):
        if hasattr(run, name):
            delattr(run, name)
    gc.collect()
    if run.on_card:
        import torch
        torch.cuda.empty_cache()


def check(run) -> dict:
    ref = KVReference(run.keys, run.payloads)
    if run.writes:
        ref.set_writes(
            np.concatenate([w[0] for w in run.writes]),
            np.concatenate([w[1] for w in run.writes]),
            np.concatenate([np.full(w[0].size, w[2])
                            for w in run.writes]))
    wrong = sum(count_wrong(ref, q, pay, found, epoch)
                for q, pay, found, epoch in run.kept)
    stale = sum(r[5] < r[4] for r in run.reads)
    checks = {"wrong_answers": (wrong, 0), "stale_reads": (stale, 0)}
    run.layer["info"]["checked_answers"] = sum(k[0].size
                                               for k in run.kept)
    if not run.control:
        acked = [w for w in run.writes if w[5] is not None]
        checks["lost_writes"] = (walread.lost_writes(
            [w[0] for w in acked], [w[1] for w in acked],
            [w[5] for w in acked], run.wal_log), 0)
    return checks
