"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n-keys N] [--seed S]

Drives ``repro_torch``'s main path — build, freeze, batched lookups —
on the card, and holds the hand-written CUDA kernel against its plain
torch version.  Prints one JSON line per phase:

1. environment and kernel build (nvcc into build/repro_torch/);
2. ``fused_lookup`` against ``fused_lookup_plain`` on identical CUDA
   inputs, bit for bit in all seven outputs: narrow keys (< 2^24) in
   flat and whole-window mode, wide keys (< 2^40, the f32 hi/lo pair)
   with chains at max_chain in both modes, and int64 payloads;
3. the main path at real scale: ``Index.build(keys, method="pgm",
   eps=64, gap_rho=0.15, sample_rate=0.01)`` over 32M unique integer
   keys below 2^40, then lookups of 4,096 and 2^20 queries (about 70%
   present keys, chained keys included, 25% absent keys in range, 5%
   out of range), every answer held against the host oracle
   ``GappedArray.lookup_batch``; the kernel is timed at the main
   path's shapes beside its plain version, its bound and
   ``torch.searchsorted`` as a partial yardstick.

Scale: SOSD's key sets (Marcus et al., Benchmarking Learned Indexes,
VLDB 2020) hold 200M keys; the smoke cuts that to 32M so the host build
and the host oracle fit the run's time limit.  ``--n-keys`` changes it.

Then the kernels' JSON line, the card's name and power limit as
nvidia-smi gives them, and last ``{"ok": true, "device": ...}``.  Any
failure exits nonzero.  Needs CUDA and the repository's ``src/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores
TOL = "exact (bit for bit)"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int = 20, runs: int = 5, warm: int = 3) -> float:
    """ms per call of ``fn()``: CUDA events around ``launches``
    back-to-back calls, over the count; the median of ``runs`` such
    runs, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def mixed_queries(rng, keys, chain_keys, n, lo_bound):
    """~70% present (a tenth of them chained keys when there are any),
    25% absent in range, 5% out of range (half below, half above)."""
    n_present = int(0.70 * n)
    n_out = int(0.05 * n)
    n_absent = n - n_present - n_out
    n_chain = min(n_present // 10, chain_keys.size)
    present = np.concatenate([rng.choice(keys, n_present - n_chain),
                              rng.choice(chain_keys, n_chain)
                              if n_chain else np.zeros(0)])
    cand = np.floor(rng.uniform(keys[0], keys[-1], 2 * n_absent))
    absent = cand[~np.isin(cand, keys)][:n_absent]
    below = lo_bound - 1.0 - np.floor(rng.uniform(0, 2.0 ** 20, n_out // 2))
    above = keys[-1] + 1.0 + np.floor(
        rng.uniform(0, 2.0 ** 20, n_out - n_out // 2))
    q = np.concatenate([present, absent, below, above])
    if q.size < n:  # absent draws that hit a key were dropped
        q = np.concatenate([q, rng.choice(keys, n - q.size)])
    return rng.permutation(q)


def check_against_host(res, ga, q) -> None:
    """Payloads and found against ``lookup_batch(q, full=True)``; all
    three against the plain binary search ``lookup_batch(q,
    bounded=False, full=True)``, whose slot for a query below every key
    is -1 as on the device (the bounded search clamps it to 0)."""
    pay_b, _slot_b, found_b = ga.lookup_batch(q, full=True)
    pay, slot, found = ga.lookup_batch(q, bounded=False, full=True)
    bad = {
        "payloads": int(np.count_nonzero(res.payloads != pay_b)),
        "found": int(np.count_nonzero(res.found != found_b)),
        "payloads_plain": int(np.count_nonzero(res.payloads != pay)),
        "slots": int(np.count_nonzero(res.slots != slot)),
        "found_plain": int(np.count_nonzero(res.found != found)),
    }
    if any(bad.values()):
        raise AssertionError(f"device answers differ from the host "
                             f"oracle: {bad}")


def compare_outputs(name, got, want) -> int:
    """Raise unless all seven outputs are equal; returns the largest
    absolute difference seen (0 when they are)."""
    names = ("slot", "res", "out", "out_hi", "fb", "fb_loc", "fb_cnt")
    err = 0
    for n, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {n} differs in shape or type")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"in {n} ({int((g != w).sum())} elements)")
    return err


def kernel_case(name, idx, q, *, flat_w=None):
    """Kernel vs plain version on the engine's own inputs for ``q``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.lookup import fused_lookup, fused_lookup_plain
    eng = idx.sync_device()
    a = eng.arrays
    qh, ql = ops.split_queries(q, a.key_wide)
    b = eng.bucket(qh.shape[0])
    assert b == qh.shape[0], "case batches are whole buckets"
    q_tile = min(b, ops.auto_q_tile(b, a.n_slots, eng.w_tile))
    fw = eng._fused_width_for(b) if flat_w is None else flat_w
    qh_t = torch.from_numpy(qh).cuda()
    ql_t = torch.from_numpy(ql).cuda()
    if a.key_wide:
        o_lo = torch.sort(ql_t, stable=True).indices
        order = o_lo[torch.sort(qh_t[o_lo], stable=True).indices]
        ql_t = ql_t[order]
    else:
        order = torch.sort(qh_t, stable=True).indices
    qh_t = qh_t[order]
    args = ops.fused_args(qh_t, ql_t, a, eng._elo, eng._radix_table,
                          eng._radix_scale, q_tile=q_tile, w_tile=eng.w_tile)
    statics = ops.fused_statics(a, q_tile=q_tile, w_tile=eng.w_tile,
                                flat_w=fw)
    got = fused_lookup(*args, **statics)
    want = fused_lookup_plain(*args, **statics)
    torch.cuda.synchronize()
    err = compare_outputs(name, got, want)
    return args, statics, got, err


def build_case_index(rng, span, n, *, wide_payloads=False, n_mids=0):
    from repro_torch.core import Index
    keys = np.unique(rng.integers(0, span, int(n * 1.05)).astype(np.float64))
    keys = np.sort(rng.choice(keys, min(n, keys.size), replace=False))
    payloads = None
    if wide_payloads:
        payloads = (np.int64(3) << 40) + np.arange(keys.size, dtype=np.int64)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.01, rng=rng, payloads=payloads,
                      device="cuda")
    mids = np.zeros(0)
    if n_mids:
        # keys between neighbours land in chains (CSR links)
        mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5),
                            keys)[:n_mids]
        pay = (np.int64(5) << 40 if wide_payloads else 7_000_000) \
            + np.arange(mids.size, dtype=np.int64)
        idx.gapped.insert_batch(mids, pay)
    return idx, keys


def longest_chain_keys(ga):
    off, ck, _ = ga.links.csr()
    lens = np.diff(off)
    s = int(np.argmax(lens))
    return ck[off[s]:off[s + 1]]


def phase_cases(rng) -> list:
    from repro_torch.kernels.lookup import fused_lookup
    rows = []
    specs = [
        ("narrow_flat", 2 ** 24, False, None),
        ("narrow_whole_window", 2 ** 24, False, 0),
        ("wide_flat_max_chain", 2 ** 40, False, None),
        ("wide_whole_window", 2 ** 40, False, 0),
        ("wide_payload_i64", 2 ** 40, True, None),
    ]
    built = {}
    for name, span, wpay, fw in specs:
        key = (span, wpay)
        if key not in built:
            built[key] = build_case_index(rng, span, 400_000,
                                          wide_payloads=wpay, n_mids=40_000)
        idx, keys = built[key]
        ga = idx.gapped
        chain = longest_chain_keys(ga)
        q = mixed_queries(rng, keys, ga.links.chain_keys, 1 << 16, keys[0])
        q[:chain.size] = chain           # every key of the longest chain
        launches0 = fused_lookup.launches
        args, statics, _, _ = kernel_case(name, idx, q, flat_w=fw)
        a = idx._engine.arrays
        rows.append({"case": name, "n_keys": int(keys.size),
                     "key_wide": a.key_wide, "wide": a.wide,
                     "flat_w": statics["flat_w"],
                     "q_tile": statics["q_tile"],
                     "max_chain_frozen": a.max_chain,
                     "max_chain_live": int(ga.links.max_chain),
                     "longest_chain_queried": int(chain.size),
                     "launches": fused_lookup.launches - launches0,
                     "outputs_equal": 7, "tolerance": TOL})
        emit("kernel_vs_plain", **rows[-1])
    return rows


def fused_bytes(args, statics, got) -> int:
    """Least bytes one launch moves: each input element it needs read
    once, each output written once.  The slot-array elements counted are
    the distinct ones this batch's windows and answers touch; link-table
    probes are left out, so this stays a lower bound."""
    from repro_torch.kernels.lookup import window_base
    (q, ql, tile_block, radix_table, radix_scale, segk, segkl, slope, iclo,
     sk, skl, pay, payhi, off, lk, lkl, lp, lph) = args
    q_tile, w_tile, flat_w = (statics["q_tile"], statics["w_tile"],
                              statics["flat_w"])
    n_q = q.shape[0]
    base = (tile_block.long() * w_tile).repeat_interleave(q_tile)
    if flat_w:
        lo0 = window_base(q, ql, radix_table, radix_scale, segk, segkl,
                          slope, iclo, n_slots=statics["n_slots"],
                          key_wide=statics["key_wide"])
        win = (lo0 - base)[:, None] + torch.arange(flat_w + 1,
                                                   device=q.device)
        win = base[:, None] + win.clamp(0, 2 * w_tile - 1)
        small = sum(t.numel() * t.element_size()
                    for t in (radix_table, radix_scale, segk, segkl, slope,
                              iclo))
    else:
        win = (tile_block.long().unique()[:, None] * w_tile
               + torch.arange(2 * w_tile, device=q.device))
        small = 0
    n_win = int(torch.unique(win).numel())
    key_bytes = 8 if statics["key_wide"] else 4
    pay_bytes = 8 if statics["wide"] else 4
    slot = got[0].long()
    ok = slot >= 0
    n_ans = int(torch.unique(slot[ok]).numel())
    inputs = (n_q * key_bytes + tile_block.numel() * 4 + small
              + n_win * key_bytes + n_ans * (pay_bytes + 8))
    outputs = n_q * (4 * 4 + (4 if statics["wide"] else 0) + 1) \
        + tile_block.numel() * 4
    return inputs + outputs


def fused_ops(statics, n_q) -> int:
    """Compares (and adds) per launch: the rank window, the epilogue."""
    per_q = (statics["flat_w"] + 1 if statics["flat_w"]
             else 2 * statics["w_tile"])
    trips = int(statics["max_chain"]).bit_length()
    cmp = 3 if statics["key_wide"] else 1
    return n_q * (per_q * cmp + 10 + trips * cmp)


def profile_lookup(idx, q, smi, calls: int = 3) -> None:
    """Device time by op over ``calls`` lookups, beside the wall time:
    the device's busy share of the window and the ops that fill it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            idx.lookup(q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # the device-side events themselves (kernels, copies, memsets);
        # the host ops that launched them would count the time twice
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    host = sorted(((ev.self_cpu_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if "CUDA" not in str(getattr(ev, "device_type", ""))),
                  reverse=True)
    emit("main_profile", card=smi, batch=int(q.size), calls=calls,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1.0 - busy_ms / wall_ms) if wall_ms else None,
         top_device_ops=[{"op": k[:60], "count": c, "ms": u / 1e3}
                         for u, k, c in rows[:10]],
         top_host_ops=[{"op": k[:60], "count": c, "ms": u / 1e3}
                       for u, k, c in host[:10]])


def phase_main(rng, n_keys, seed, smi, profile=False) -> dict:
    from repro_torch.core import Index
    from repro_torch.kernels.lookup import fused_lookup, fused_lookup_plain
    t0 = time.perf_counter()
    # a Bernoulli draw of n_keys of the integers below 2^40, made O(n):
    # geometric gaps with mean 2^40 / (1.01 n) sum to about 0.99 * 2^40
    gaps = rng.geometric(min(1.0, 1.01 * n_keys / 2 ** 40), n_keys)
    keys = (np.cumsum(gaps) - 1).astype(np.float64)
    if keys[-1] >= 2 ** 40:
        raise AssertionError("key draw ran past 2^40")
    gen_s = time.perf_counter() - t0
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.01, rng=np.random.default_rng(seed),
                      device="cuda")
    ga = idx.gapped
    eng = idx.sync_device()
    a = eng.arrays
    emit("main_build", card=smi, n_keys=int(keys.size),
         n_slots=int(ga.n_slots), segments=int(ga.mech.plm.n_segments),
         chained_keys=int(ga.links.total),
         max_chain=int(ga.links.max_chain),
         device_bytes=int(idx.device_bytes()),
         key_wide=a.key_wide, wide=a.wide,
         keygen_seconds=gen_s, build_seconds=idx.build_seconds,
         learn_seconds=idx.learn_seconds,
         freeze_seconds=idx.stats["freeze_seconds"])
    timing = {}
    fused_lookup.launches = 0   # counts from the main path's run only
    esc0 = eng.stats["oracle_escapes"]
    fb0 = eng.stats["fallbacks"]
    batches = {}
    for n_b in (4096, 1 << 20):
        q = mixed_queries(rng, keys, ga.links.chain_keys, n_b, keys[0])
        # warm-up: until the bucket's escape buffer has grown past the
        # batch's escapes (the engine's sticky boost), at most 5 calls
        warm_escapes = 0
        for _ in range(5):
            r = idx.lookup(q)
            warm_escapes += r.oracle_escapes
            if r.oracle_escapes == 0:
                break
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reps, rep_escapes = 5, 0
        for _ in range(reps):
            res = idx.lookup(q)
            rep_escapes += res.oracle_escapes
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / reps
        if res.backend != "fused":
            raise AssertionError(f"lookup served by {res.backend!r}")
        check_against_host(res, ga, q)
        batches[n_b] = q
        emit("main_lookup", card=smi, batch=n_b, backend=res.backend,
             ms_per_batch=ms, ns_per_query=ms * 1e6 / n_b,
             fallbacks=res.fallbacks, oracle_escapes=rep_escapes,
             warmup_oracle_escapes=warm_escapes,
             found=int(res.found.sum()), answers_equal_host_oracle=True)
        timing[n_b] = ms
    launches = fused_lookup.launches
    if profile:
        for n_b, q in batches.items():
            profile_lookup(idx, q, smi)
    if launches == 0:
        raise AssertionError("the main path never launched fused_lookup")
    main_stats = {"launches": launches,
                  "fallbacks": eng.stats["fallbacks"] - fb0,
                  "oracle_escapes": eng.stats["oracle_escapes"] - esc0}

    # the kernel at the main path's shapes, held against its plain
    # version; these launches are after the count was read
    per_batch = {}
    for n_b, q in batches.items():
        args, statics, got, err = kernel_case(f"main_{n_b}", idx, q)
        k_ms = cuda_ms(lambda: fused_lookup(*args, **statics))
        p_ms = cuda_ms(lambda: fused_lookup_plain(*args, **statics),
                       launches=5)
        sk, qs = args[9], args[0]
        lib_ms = cuda_ms(lambda: torch.searchsorted(sk, qs, right=True))
        nbytes = fused_bytes(args, statics, got)
        nops = fused_ops(statics, qs.shape[0])
        bound_ms = max(nbytes / H100_BYTES_PER_S,
                       nops / H100_F32_OPS_PER_S) * 1e3
        per_batch[n_b] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=("bytes" if nbytes / H100_BYTES_PER_S
                      >= nops / H100_F32_OPS_PER_S else "operations"),
            max_abs_err=err, bytes=nbytes, ops=nops,
            flat_w=statics["flat_w"], q_tile=statics["q_tile"])
        emit("kernel_timing", card=smi, batch=n_b, **per_batch[n_b],
             library_call="torch.searchsorted(slot_key, q, right=True): "
                          "computes slot only, and only for narrow keys "
                          "(here it searches the hi half)",
             kernel_vs_plain=TOL)
    return {"launches": launches, "per_batch": per_batch,
            "main": main_stats, "lookup_ms": timing}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-keys", type=int, default=32_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace three lookups per batch size with "
                         "torch.profiler and print the device-time "
                         "breakdown")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing to run", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        raise AssertionError("the port loaded jax or the reference package")
    smi = smi_line()
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    emit("environment", card=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         kernel_build_seconds=build_s,
         libraries=[p.name for p in built.values()],
         ptxas=_build.ptxas_report("fused_lookup").strip().splitlines())

    rng = np.random.default_rng(args.seed)
    cases = phase_cases(rng)
    main_res = phase_main(rng, args.n_keys, args.seed, smi, args.profile)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported during the run")

    big = main_res["per_batch"][max(main_res["per_batch"])]
    kernels = [{
        "name": "fused_lookup",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_lookup.cu",
        "replaces": "src/repro/kernels/lookup.py:415",
        "launches": main_res["launches"],
        "max_abs_err": max(b["max_abs_err"]
                           for b in main_res["per_batch"].values()),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
    }]
    emit("summary", card=smi, cases=len(cases), **main_res["main"])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
