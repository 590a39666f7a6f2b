"""Read-only lookups: one client sends batches of the mix's size back to
back through ``repro_torch.core.Index.lookup`` (the default
``QueryEngine``, ``fused_impl="kernel"``).

Set-up draws the keys, payloads and a pool of query batches from the
seed, builds and freezes the index, and calls every pool batch until it
meets no oracle escape (at most five calls), so that the window
compiles and grows nothing.  The window cycles through the pool.  The
check holds a sample of the window's calls, drawn from the seed, against
the plain reference, answer by answer.
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np

from portbench import gen
from portbench.harness import Reservoir, per_second
from portbench.reference import KVReference, count_wrong

CHECK_ANSWERS = 1 << 24     # answers held against the reference a run


class ControlIndex:
    """The reference at float32 in the program's place."""

    def __init__(self, keys, payloads):
        self.ref = KVReference(keys, payloads, np.float32)

    def lookup(self, queries):
        pay, found = self.ref.answer(queries)
        return types.SimpleNamespace(payloads=pay, found=found, epoch=0,
                                     backend="control", oracle_escapes=0)


def setup(run) -> None:
    cfg, mix = run.config, run.mix
    t0 = time.perf_counter()
    rng = gen.rng_for(cfg["data_seed"], 0)   # the deployment's data
    run.keys = gen.draw_keys(rng, int(cfg["n_keys"]), int(cfg["key_bits"]))
    run.payloads = gen.draw_payloads(rng, run.keys.size,
                                     int(cfg["payload_bits"]))
    qrng = gen.rng_for(run.seed, 1)
    run.pool = [gen.mixed_queries(qrng, run.keys, int(mix["batch"]),
                                  mix["present"], mix["absent"],
                                  mix["out_of_range"])
                for _ in range(int(mix["pool"]))]
    run.setup["inputs_s"] = time.perf_counter() - t0
    if run.control:
        run.system = ControlIndex(run.keys, run.payloads)
        return
    from repro_torch.core import Index
    ix = dict(cfg["index"])
    idx = Index.build(run.keys, method=ix.pop("method"),
                      sample_rate=ix.pop("sample_rate"),
                      gap_rho=ix.pop("gap_rho"), payloads=run.payloads,
                      rng=gen.rng_for(cfg["data_seed"], 2),
                      device=run.device, **ix)
    run.engine = idx.sync_device()
    run.setup.update(build_s=idx.build_seconds,
                     freeze_s=idx.stats["freeze_seconds"],
                     n_slots=int(idx.gapped.n_slots),
                     device_bytes=int(idx.device_bytes()))
    t0 = time.perf_counter()
    warm = 0
    for q in run.pool:
        for _ in range(5):
            warm += 1
            if idx.lookup(q).oracle_escapes == 0:
                break
    run.setup.update(warmup_calls=warm,
                     warmup_s=time.perf_counter() - t0)
    run.system = idx


def window(run) -> None:
    system, pool = run.system, run.pool
    batch = pool[0].size
    keep = Reservoir(max(1, CHECK_ANSWERS // batch),
                     gen.rng_for(run.seed, 3))
    engine = getattr(run, "engine", None)
    fb0 = engine.stats["fallbacks"] if engine is not None else 0
    esc0 = engine.stats["oracle_escapes"] if engine is not None else 0
    esc = 0
    calls, ms, ends, backends = 0, [], [], {}
    run.t_open = time.perf_counter()
    deadline = run.t_open + run.seconds
    in_window = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        i = calls % len(pool)
        with run.span("pb.lookup"):
            res = system.lookup(pool[i])
        t1 = time.perf_counter()
        calls += 1
        ends.append(t1)
        if t1 <= deadline:
            in_window += 1
            ms.append((t1 - t0) * 1e3)
        backends[res.backend] = backends.get(res.backend, 0) + 1
        keep.offer((i, res.payloads, res.found))
    run.attempted = calls
    run.layer["lookup_qps"] = in_window * batch / run.seconds
    run.kept = keep.items
    run.layer.update(call_ms=ms, calls=calls, batch=batch,
                     queries=calls * batch)
    if engine is not None:
        run.layer["fallbacks"] = engine.stats["fallbacks"] - fb0
        esc = engine.stats["oracle_escapes"] - esc0
    run.layer["info"] = {"calls": calls, "calls_in_window": in_window,
                         "calls_per_second": per_second(
                             ends, run.t_open, run.seconds),
                         "backends": backends, "oracle_escapes": esc,
                         "checked_calls": len(keep.items)}


def release(run) -> None:
    for name in ("system", "engine"):
        if hasattr(run, name):
            delattr(run, name)
    gc.collect()
    if run.on_card:
        import torch
        torch.cuda.empty_cache()


def check(run) -> dict:
    ref = KVReference(run.keys, run.payloads)
    wrong = sum(count_wrong(ref, run.pool[i], pay, found)
                for i, pay, found in run.kept)
    run.layer["info"]["checked_answers"] = sum(
        run.pool[i].size for i, _, _ in run.kept)
    return {"wrong_answers": (wrong, 0)}
