"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n-keys N] [--fused-keys N] [--fused-batches B]
                          [--place-keys N] [--place-batches B]
                          [--narrow-keys N] [--serve-keys N] [--seed S]
                          [--profile]

Drives ``repro_torch``'s main paths — build, freeze, batched lookups,
the §5.3 write path, device Eq. 3, the legacy lookup backends, the
range-sharded index, the serving stack, the index's consumers, LLM
decode serving over the learned-index block table (a transformer, a
Mamba-2 hybrid, an xLSTM), training over the learned-index data path
and training sharded over a ``torch.distributed`` mesh — on the card,
and holds each hand-written CUDA kernel against its plain torch
version.  Prints one JSON line per phase (they run in the
order 1-9, 11, 10, 18, 12, 13, 14, 15, 16, 17: phase 11 reuses the read
phase's keys and index; ``--only-u64`` runs phase 18 alone):

1. environment and kernel build (one nvcc per source, in parallel, into
   build/repro_torch/);
2. ``fused_lookup`` against ``fused_lookup_plain`` on identical CUDA
   inputs, bit for bit in all seven outputs: narrow keys (< 2^24) in
   flat and whole-window mode, wide keys (< 2^40, the f32 hi/lo pair)
   with chains at max_chain in both modes, and int64 payloads; then on
   each of those three indexes every flat width of ``SWEEP_FLAT_W``
   (0, 1, 31, 32, 33, 256) at q_tile 32, 256 and 512, with tiles at
   the first and the last block pair;
3. the read path at real scale: ``Index.build(keys, method="pgm",
   eps=64, gap_rho=0.15, sample_rate=0.01)`` over 32M unique integer
   keys below 2^40, then lookups of 4,096 and 2^20 queries (about 70%
   present keys, chained keys included, 25% absent keys in range, 5%
   out of range), every answer held against the host oracle
   ``GappedArray.lookup_batch``; the kernel is timed at the main
   path's shapes beside its plain version, its bound and
   ``torch.searchsorted`` as a partial yardstick, and its device time
   at flat widths 8, 32 and 256 on the same inputs.  The same batches
   then go through a ``QueryEngine(fused_impl="xla")`` over the same
   frozen arrays (the reference's own non-TPU path: the rank-router
   graph in torch ops, escapes patched on the host), every answer
   against the host oracle, timed beside the kernel engine;
4. ``ingest_place`` against ``ingest_place_plain`` on identical CUDA
   inputs, bit for bit in all four outputs (p, pv, ub, flags): narrow
   and wide keys, keys next to the longest chain, keys inside the
   rounding-escape band, keys below the first slot and above the last,
   +inf padding rows; the escape-patched primitives held against the
   host oracle ``GappedArray.placement_primitives``.  Then the cases of
   the searches from ``p``: on each index, per segment the key whose
   ``p`` lies farthest from its ``ub``, keys whose ``p`` clips to 0 and
   to ``n_slots - 1``, keys below the first slot and above the last,
   the longest chain and its neighbours, +inf padding; and a wide index
   with 10,000 neighbouring keys removed, queried at those keys, so
   that ``pv`` walks the whole gap run;
5. the fused write path at the largest size the fused gate admits
   (``n_slots < 2^22``: ``--fused-keys``, 3.6M keys by default): the
   read-heavy dynamic workload of the paper (w = 0.3,
   benchmarks/fig11_dynamic.py) — the keys held out of the build (30%
   of the drawn keys; the first 64 batches of them, ``--fused-batches``)
   inserted in random order in batches of 16,384 and 4,096, with a
   delete batch and
   a payload-update batch of 4,096 present keys every 16 insert
   batches; its fused commit rate is the phase's number.  Then a
   mechanism test: 8 batches of 4,096 built to pass the fused gate
   (absent keys one per four gap runs, predicted away from a rounding
   boundary), which must commit ``fused``.  A lookup of 2^16 mixed
   queries before the first write, after every 8th batch and at the
   end, held against the host oracle; the last one of each segment
   must be served by the kernel (not the oracle stage an overflowed
   batch goes to).  At the end the ``GappedArray`` state equals a
   host-only replay of every write on a copy taken before the first;
6. the two-dispatch write path at the largest size the placement gate
   admits (``n_slots < 2^24``: ``--place-keys``, 14.5M keys by
   default): ``--place-batches`` (16) insert batches of 16,384
   held-out keys, the same lookup checks and host-replay equality; the
   kernel timed at 16,384 keys beside its plain version, its byte
   bound and ``torch.searchsorted`` for ``ub`` alone;
7. ``gap_place`` against ``gap_place_plain`` and ``lookup_kernel``
   against ``lookup_kernel_plain`` on identical CUDA inputs, bit for bit
   (NaN equals NaN in the +inf padding rows): Eq. 3 over 400k keys
   below 2^24 and below 2^40 with (key_tile, seg_chunk) (256, 128) and
   (2048, 1024), keys below the first segment; the legacy kernel over a
   400k-key narrow index with chains at the reference's three tile
   shapes (q_tile, w_tile, win_chunk) = (128, 512, 128), (256, 2048,
   512), (512, 4096, 1024), queries below and above the keys, +inf
   padding, and windows at the first and the last block pair.  The
   plain legacy version counts literally where the kernel bisects.
   Then the cases of the two kernels' brackets (inputs built by
   tests/test_torch_kernel_gpu.py): Eq. 3 on shuffled keys over many
   and over few segments, a one-segment table, keys below the first
   segment, +inf padding from mid-chunk, ragged and unaligned key
   counts; the legacy kernel on tiles below and above their window,
   all-padding tiles, slices that are the whole window, runs of equal
   keys at both slice edges, unsorted tiles with a NaN, and q_tile 32,
   128, 256, 1024 by w_tile 512, 2048, 8192 over a real index;
8. device Eq. 3 at full size: ``gap_positions_device`` over the read
   phase's 32M keys with its index's model (rho = 0.15), held against
   the f64 oracle ``gap_positions_oracle`` at the reference's tolerance
   (rtol 2e-5, atol 0.5), monotone, within the budget ``rho * n + 1``;
   the kernel timed at that size beside its plain version, its byte
   bound and ``torch.searchsorted`` over the segment table, with the
   premise of its design counted on the host from the same inputs
   (chunks whose keys span more than one segment);
9. the legacy backends at full size: a narrow index of
   ``--narrow-keys`` (8M) unique integer keys below 2^24 (about 9.2M
   slots), ``Index.lookup(backend="pallas")`` at 2^20 mixed queries,
   which the kernel must serve (not the oracle stage), and at 4,096
   (the stage that served is recorded); ``backend="xla-windowed"`` at
   2^20 on this index and on the read phase's wide index; every answer
   held against the host oracle; the kernel timed at the 2^20 shapes,
   with the premise of its design counted on the host from the same
   inputs (the bytes the tiles' slices stage against whole windows,
   the slice widths, tiles in one segment);
10. the serving stack at the fused gate's size (``--serve-keys``, 3.6M
   keys below 2^40 by default, ``gap_rho=0.15, sample_rate=0.01``):
   two YCSB core workloads (Cooper et al., SoCC 2010) as
   benchmarks/serving_bench.py defines them, mix 1 YCSB-B (read
   fraction 0.95, Zipf 0.99) over a ``method="auto"`` build (the
   tuner's pick is printed), mix 2 YCSB-A (0.5, uniform) over ``pgm,
   eps=64``.  Each runs 32 rounds: lookup calls of 2,048 keys from 8
   caller threads (as many as the read fraction asks for: 38 and 2 a
   round) and one ingest of 4,096 fresh keys (gap midpoints), all
   through a ``MicroBatchQueue(max_wait_ms=2, max_depth=64)`` over an
   ``EpochPipeline`` with an ``IngestWAL(sync_every="adaptive")``, an
   ``InvariantAuditor`` every 8 ingests and the MDL-drift trigger
   (0.05, every 8 publishes); a ``publish`` every 2 rounds, so half
   the rounds serve from the pinned snapshot; a checkpoint every 8
   rounds into a temporary directory, each restored on the card and
   held bit for bit against the live state.  Every answer is held
   against a host-only replay of every write at the epoch it reports.
   Mix 1 then retrains while the published snapshot is pinned (which
   must serve bit-identically across it), ingests once more, tears the
   WAL inside that last record and recovers from the newest checkpoint
   on the card: the state must equal the host-only replay of the acked
   writes, and a 2^16 mixed lookup on it must be served by the kernel.
   Per mix: lookup-call p50 / p99 (host clock ending in
   ``torch.cuda.synchronize``), live and snapshot lookups, flush sizes,
   ingest labels and fused commits, WAL bytes and syncs, checkpoint
   and restore seconds and bytes, recovery seconds and records, retrain
   and MDL seconds; then both kernels at the path's shapes against
   their plain versions;
11. the range-sharded index (``Index.build(shards=8)``, the largest
   count of benchmarks/shard_bench.py's sweep) over the read phase's
   32M keys: per shard its keys, slots and which write gates it is
   under, the fan-out's devices, stacked bytes, build and stack
   seconds; the read phase's 4,096 and 2^20 queries through the fan-out
   (ms per batch, escapes, exchange overflows, router mispredicts),
   every payload and found equal to the single-device index and every
   slot to the shards' host oracles plus their slot bases; 2^16 queries
   through the grouped ``backend="fused"`` path (one ``fused_lookup``
   launch per touched shard), a 256-query batch on the host path, the
   shard boundaries and their neighbours; 8 insert batches of 16,384
   absent keys (each shard's placement and device labels), the fan-out
   held against the union of keys and inserts every 4 batches, every
   shard's state against a host-only replay of its writes, a forced
   split of the largest shard and a retrain of shard 0, each followed
   by a fan-out check on the rebuilt epoch tag.  Then 3.6M keys in 4
   shards through ``EpochPipeline`` with an ``IngestWAL``: a checkpoint
   mid-run, a torn WAL tail and ``recover_index(device="cuda")``, every
   recovered shard equal to the pre-crash shard;
12. the index's consumers: ``PagedKVCache`` at vLLM's defaults (65,536
   pages of 16, 256 requests) allocating 128 pages a request, 2^16
   (request, page) lookups on the device path (half of them mapped)
   against the allocation record after each group and after frees;
   ``IndexedTokenDataset`` over a synthetic store of 1M documents
   (mean length 64, vocabulary 32,000; examples/streaming_ingest.py's
   widths), ``ShardedLoader`` batches of 1,024 held against the store,
   and a streamed shipment of 4,096 new documents;
13. LLM decode serving: ``ServingEngine`` over internlm2-1.8b
   (configs/internlm2_1_8b.py: 24 layers, d_model 2048, 16 heads, 8 KV
   heads, d_ff 8192, vocabulary 92,544) at full width and depth, bf16
   params from ``--seed``, ``max_batch=32, max_len=512, page_size=16``,
   temperature 0; 64 requests of ``launch/serve.py``'s traffic (prompts
   of 4-23 tokens uniform below the vocabulary), 64 new tokens each.
   Every round's page lookup (one ``MicroBatchQueue`` flush, padded to
   its 512-query bucket: one ``fused_lookup`` launch) is held against
   the block table's host map, and the block table and its index at the
   end against a host-only replay of the same allocs and frees.  Round
   ms p50 / p99 split into the model step (CUDA events around
   ``decode_fn``), the page lookup, alloc and sampling (host clock);
   tokens/s; the step's byte bound (weights and the whole ``max_len``
   KV cache read once).  Then the model's numerics at full size in f32
   (TF32 off, batch 2 x 64 tokens): prefill's last logits against
   ``forward``'s, a ``decode_step`` after it against ``forward`` over
   the 65 tokens (atol 1e-3, equal argmax), the bf16 differences
   printed; the first two layers on the card against the CPU in f32;
   and ``fused_lookup`` against its plain version at the last round's
   bucket;
14. recurrent decode serving: the same run (``serve_decode``: 64
   requests x 64 new tokens, 32 slots, ``max_len`` 512, bf16 params
   from ``--seed``, every round's page lookup against the host map, the
   block table against a host-only replay, ``decode`` lines) over
   zamba2-1.2b (configs/zamba2_1_2b.py: 38 Mamba-2 layers, d_model
   2048, 32 SSM heads of 128, state 64, one shared attention block of
   width 4096 after every 6th layer, d_ff 8192, vocabulary 32,000;
   1.19B params, 1.47 GB of decode state) and xlstm-125m
   (configs/xlstm_125m.py: 12 blocks, the 8th an sLSTM, d_model 768,
   4 heads, vocabulary 50,304; 0.20B params, 0.83 GB of f32 matrix
   memories), each at full width and depth; the step's byte bound
   counts the weights and the whole decode state read once and the
   state a step rewrites.  Then each model's numerics in f32 (TF32
   off, batch 2 x 64 tokens, ``conditioned`` params): the chunked
   ``forward`` against 64 ``decode_step``s from zero caches at every
   position (atol 1e-3, equal argmax), the bf16 and as-drawn
   differences printed, and the first layers that run every block kind
   (zamba's first 6, one shared block; xLSTM's first 8, its sLSTM) on
   the card against the CPU; ``fused_lookup`` against its plain version
   at each run's bucket;
15. training (``phase_train``): ``Trainer`` over internlm2-1.8b at full
   width and depth (bf16 params, AdamW, ``remat="full"``) on
   ``launch/train.py``'s data path (``PackedTokenStore.synthetic(2048,
   mean_len=513)``, ``IndexedTokenDataset.build(method="pgm",
   sample_rate=0.1, gap_rho=0.15)``, ``ShardedLoader(global_batch=8,
   seq_len=512)``; its 8-key lookups stay under ``min_device_batch`` and
   take the host path, as in the reference, so no kernel runs), 12
   cosine steps with a checkpoint every 6 and a crash injected at 9; a
   fresh trainer and loader resume at 6 and end at 12.  Every loss
   finite, the replayed steps 7-9 within 1e-3 of run 1's, the final
   checkpoint restored bit for bit, the held-out loss before and after
   printed; step ms p50 / p99 (CUDA events around the forward, the
   backward and the optimizer), tokens/s, ``mfu`` (6·N·T +
   12·L·d_attn·S·T over 989 TFLOP/s), peak memory, checkpoint seconds
   and bytes (``train``; ``train_profile`` with ``--profile``).  Then
   loss and every grad on the card against the CPU in f32 (TF32 off,
   ``conditioned`` params, 2 x 64 tokens) within 1e-3 for 2-layer cuts
   of internlm2-1.8b and granite-moe-1b-a400m at full width,
   zamba2-1.2b's first group and xlstm-125m's first 8 blocks, and
   ``remat="full"`` / ``"dots"`` against ``"none"`` on the card
   (``train_numerics``);
16. partitioning (``phase_partition``): one process in an ``nccl``
   group of one (a file store under the phase's temporary directory,
   destroyed at its end) and the mesh of ``make_mesh_for(1, 1)``.  Two
   ``Trainer`` steps of internlm2-1.8b at full width and 2 layers on
   ``launch/train.py``'s data path, once plain and once with the mesh's
   ``activation_constrainer`` (the state sharded over the mesh, the step
   the tensor-parallel design on the rank's shards, every collective a
   copy over a group of one): losses, gnorms and every state leaf bit
   for bit; the sharded state's
   checkpoint restored through ``elastic_restore`` onto (1, 1) bit for
   bit; granite-moe-1b-a400m at full width and 2 layers in f32 with
   ``moe_impl="ep"`` over the mesh against ``moe_gspmd``, the hidden
   states within the reference's 2e-4 and loss and grads within 1e-3;
   then the four other families at full width, each block kind once
   (internvl2-2b at 2 layers, whisper-base at 2 + 2, zamba2-1.2b at 6:
   one shared block, xlstm-125m at 8: one sLSTM), two ``Trainer`` steps
   on drawn batches plain and on the mesh, the tensor-parallel design,
   bit for bit (``partition``, with the phase's seconds);
17. the dry run against the card (``phase_dryrun``, after phase 16's
   group is gone): three cells of ``launch/dryrun.py``, each one rank's
   share on pod16x16 at full width, run at 2 and 4 layers through the
   plain step a rank runs (``dryrun.build_step`` without a mesh:
   ``Trainer.train_step``, or ``decode_fn`` over ``init_caches``):
   internlm2-1.8b x train_4k (4 x 4,096 tokens), granite-moe-1b-a400m
   x train_4k (8 x 4,096) and internlm2-1.8b x decode_32k (8 rows over
   a 32,768-token cache).  Each run's ``FlopCounterMode`` total on the
   card equals ``dryrun.count_step`` on the same step over ``meta``
   tensors, exactly; ``torch.cuda.max_memory_allocated`` over the timed
   steps is within 25% of the count's ``peak_bytes``; the step's ms
   (CUDA events, p50 of 3 after 1 warm) at both depths, extrapolated to
   full depth by ``extrapolate.at_depth`` with the peak, beside the
   full-depth count's roofline terms (a measured roofline fraction);
   then the tensor-parallel rank share of internlm2-1.8b x train_4k
   (``dry_tp_cell``: rank 255 of a ``fake`` group of 256 over the
   pod16x16 mesh on the card, its own 16 rows of 4,096 tokens at its
   shard shapes, 2 and 4 layers, the collectives moving nothing as in
   the count) and of zamba2-1.2b x train_4k (16 rows, 6 and 12 layers)
   held the same way: FLOPs exactly, the peak within 25%; then
   ``dryrun.run_cell`` of whisper-base x decode_32k on pod16x16 in a
   ``fake`` group of 256 (the tensor-parallel design) and
   ``roofline.HBM_BYTES`` against the card's ``total_memory``
   (``dryrun``, with the phase's seconds and the kernels' launch
   counts, all 0);
18. the exact 64-bit image behind the serving queue (``phase_u64``,
   after phase 10): YCSB's record keys under ``insertorder=hashed``
   (``fnvhash64`` of keynums 0 .. ``--u64-keys`` - 1, 20M by default,
   below 2^63) built as the YCSB cell builds them (``pgm, eps=64,
   gap_rho=0.15, sample_rate=0.01``), served by ``MicroBatchQueue``
   over an ``EpochPipeline`` to 8 caller threads of 48 requests of
   2,048 keys (records, and 256 neighbours ``k - 1`` / ``k + 1`` of
   records), every answer held against ``repro_torch.plain_kv``; every
   dispatch must take ``fused_lookup_u64``, one launch each, and none
   ``fused_lookup``; then the kernel at each dispatch buffer the run
   gave it against ``fused_lookup_u64_plain``, bit for bit, and timed
   at the largest beside its plain version, its byte bound and
   ``torch.searchsorted`` over the slot keys.

Scale: SOSD's key sets (Marcus et al., Benchmarking Learned Indexes,
VLDB 2020) hold 200M keys; the read phase cuts that to 32M so the host
build and the host oracle fit the run's time limit (``--n-keys``).
The write phases are sized by the device gates.  Phase 5's traffic is
cut by the time limit to its first 64 batches (0.66M of its 1.54M
held-out keys; all 151 until phase 15 came: a batch and its host
replay cost about 1 s); phase 6's traffic is cut by the time limit
to 16 batches (0.26M of 6.2M held-out keys; 32 until phases 11-12
came): at 16.65M slots a batch costs about 2 s of host partition and
delta diff, and its host replay about 1.3 s more, so all 381 batches
would take some 20 minutes.  The
legacy kernel is narrow-only (keys below 2^24, as in the reference),
so phase 9 builds its own index; 8M of the 16.8M integers below 2^24
is about half the key space.  Phase 10 holds its index at phase 5's
size, where the fused ingest is admitted, and so does phase 11's
durability run.  Phase 11 cuts the read index into 8 shards of about
4.6M slots, each under the placement gate; its writes are cut to 8
batches by the time limit (each costs a host partition and a delta
diff per touched shard, and the host replay as much again).  Phases 13
and 14 serve their configs at full width and depth; their traffic (64 x
64 tokens through 32 slots, 128 rounds) is sized to keep each near a
minute or two.  Nothing was cut for phase 14.  Phase 15 trains at
full width and depth on launch/train.py's batch; only the step count
(12) is cut, by the time limit.  Phase 17 runs its cells at 2 and 4
layers (the time limit; the depth law carries them to full depth) and
cuts the train_4k rows of a rank's 16: internlm2-1.8b to 4 (counted
peaks at 4 layers: 131 GB at 16 rows, 69 at 8, 38 at 4; at 8 rows its
2-layer step ran out of memory on the card, 11.7 GiB reserved but
unallocated), granite-moe-1b-a400m to 8 (70 GB at 16 rows, 37 at 8).

Every kernel timing reports ``ms`` (CUDA events around 20 back-to-back
wrapper calls, over the count: host and device together),
``device_ms`` (the kernel alone, by torch.profiler), ``graph_ms`` (the
20 calls replayed from a CUDA graph) and ``host_us`` (the wrapper's
enqueue time); a one-element torch op is timed the same way as the
launch floor.

Each path runs with the kernels' launch counts set to 0 just before it
and read just after.  After each phase that builds or writes an index,
a ``device_freezes`` line counts the freezes it ran on the card
(``kernels.delta.device_freezes``: the build's freeze and every
refreeze of a CUDA index under ``pgm`` / ``fiting``).  Then the
kernels' JSON line, the card's name and power limit as nvidia-smi
gives them, and last ``{"ok": true,
"device": ...}``.  Any failure exits nonzero.  Needs CUDA and the
repository's ``src/``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


def profiled_device_ms(fn, op: str, calls: int = 20) -> tuple:
    """Device time per launch of the kernels whose name holds ``op``
    over ``calls`` calls of ``fn()``, by torch.profiler: their summed
    device time over the number of them it recorded (it may drop some
    events of a session, so the count is its own, not ``calls``); with
    the names and counts of everything the calls ran on the device.
    ``(None, seen)`` when no such kernel was recorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    mine_us, mine_n, seen = 0.0, 0, []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            seen.append({"op": ev.key[:60], "count": ev.count,
                         "ms": us / 1e3})
            if op in ev.key:
                mine_us += us
                mine_n += ev.count
    return (mine_us / 1e3 / mine_n if mine_n else None), seen


def graph_ms(fn, calls: int = 20, runs: int = 5) -> float:
    """ms per call of ``fn()`` replayed from a CUDA graph of ``calls``
    back-to-back calls (no host work between launches): CUDA events
    around each replay, the median of ``runs``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del g
    return statistics.median(times)


def host_us(fn, calls: int = 20, runs: int = 5) -> float:
    """Host time to enqueue one call of ``fn()`` (µs): the host clock
    around ``calls`` calls that end before the device does, the median
    of ``runs``."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def kernel_times(fn, kernel: str) -> dict:
    """A wrapper's times at one shape: ``ms`` (CUDA events around 20
    back-to-back calls, host and device together), ``device_ms`` (the
    kernel alone: the profiler's time of the kernel named ``kernel``,
    or CUDA-graph replay where the profiler records none), ``graph_ms``
    (CUDA-graph replay of 20 calls: device time plus the gaps between
    graph nodes) and ``host_us`` (the wrapper's enqueue time)."""
    ms = cuda_ms(fn)
    dev_ms, seen = profiled_device_ms(fn, kernel)
    g_ms = graph_ms(fn)
    return {"ms": ms, "device_ms": dev_ms if dev_ms is not None else g_ms,
            "device_ms_by": ("profiler" if dev_ms is not None
                             else "cuda graph"),
            "graph_ms": g_ms, "host_us": host_us(fn), "device_ops": seen}


def launch_floor(smi) -> dict:
    """The cost of any launch: a one-element torch op (``add_`` on a
    1-element CUDA tensor), timed as the kernels are."""
    one = torch.zeros(1, device="cuda")
    row = {"op": "one-element add_",
           **kernel_times(lambda: one.add_(1.0), "")}
    emit("launch_floor", card=smi, **row)
    return row


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
    at = np.minimum(np.searchsorted(keys, cand), keys.size - 1)
    absent = cand[keys[at] != cand][:n_absent]  # keys are sorted
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
    for (span, wpay), (idx, keys) in built.items():
        label = ("narrow" if span <= 2 ** 24 else "wide") + (
            "_payload_i64" if wpay else "")
        ga = idx.gapped
        chain = longest_chain_keys(ga)
        q = mixed_queries(rng, keys, ga.links.chain_keys, 1 << 16, keys[0])
        q[:chain.size] = chain
        rows.append(sweep_cases(f"sweep_{label}", idx, q))
        emit("kernel_vs_plain_sweep", **rows[-1])
    return rows


SWEEP_FLAT_W = (0, 1, 31, 32, 33, 256)   # 0: whole window; 256: the cap
SWEEP_Q_TILES = (32, 256, 512)   # 512: the kernel's second launch bound


def sweep_cases(name, idx, q) -> dict:
    """The fused kernel against its plain version at every flat width of
    ``SWEEP_FLAT_W`` and q_tile of ``SWEEP_Q_TILES`` (the engine's tile
    schedule, with the first tile's window moved to the last block pair
    and the last tile's to the first), bit for bit in all seven
    outputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.lookup import (fused_launch_shape, fused_lookup,
                                            fused_lookup_plain)
    eng = idx.sync_device()
    a = eng.arrays
    qh, ql = ops.split_queries(np.sort(q), a.key_wide)
    qh_t = torch.from_numpy(qh).cuda()
    ql_t = torch.from_numpy(ql).cuda()
    last_pair = a.slot_key.shape[0] // eng.w_tile - 2
    shapes, escapes, found = [], 0, 0
    for q_tile in SWEEP_Q_TILES:
        args = ops.fused_args(qh_t, ql_t, a, eng._elo, eng._radix_table,
                              eng._radix_scale, q_tile=q_tile,
                              w_tile=eng.w_tile)
        tb = args[2].clone()
        tb[0], tb[-1] = last_pair, 0
        args = args[:2] + (tb,) + args[3:]
        for fw in SWEEP_FLAT_W:
            statics = ops.fused_statics(a, q_tile=q_tile, w_tile=eng.w_tile,
                                        flat_w=fw)
            got = fused_lookup(*args, **statics)
            want = fused_lookup_plain(*args, **statics)
            torch.cuda.synchronize()
            compare_outputs(f"{name}_fw{fw}_qt{q_tile}", got, want)
            escapes += int(got[4].sum())
            found += int(got[1].sum())
            tiles, smem = fused_launch_shape(
                tb.shape[0], q_tile, eng.w_tile, fw, a.key_wide,
                torch.cuda.get_device_properties(0).multi_processor_count)
            shapes.append({"flat_w": fw, "q_tile": q_tile,
                           "tiles_per_cta": tiles, "smem": smem})
    return {"case": name, "queries": int(q.size), "key_wide": a.key_wide,
            "wide": a.wide, "max_chain_frozen": a.max_chain,
            "flat_w": list(SWEEP_FLAT_W), "q_tile": list(SWEEP_Q_TILES),
            "edge_windows": "first tile at the last block pair, last tile "
                            "at the first",
            "launch_shapes": shapes, "escapes": escapes,
            "resolved": found, "outputs_equal": 7, "tolerance": TOL}


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


def traced(fn, smi, phase, **fields) -> dict:
    """Run ``fn()`` under torch.profiler: the device's busy share of the
    wall time and the device and host ops that fill it (emitted; the
    wall and busy ms, the idle share and the count of device ops
    returned)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    summary = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "device_idle_share": ((1.0 - busy_ms / wall_ms) if wall_ms
                                     else None),
               "device_ops": sum(r[2] for r in rows)}
    emit(phase, card=smi, **fields, wall_ms=wall_ms,
         device_busy_ms=busy_ms,
         device_idle_share=summary["device_idle_share"],
         device_ops=summary["device_ops"],
         top_device_ops=[{"op": k[:60], "count": c, "ms": u / 1e3}
                         for u, k, c in rows[:10]],
         top_host_ops=[{"op": k[:60], "count": c, "ms": u / 1e3}
                       for u, k, c in host[:10]])
    return summary


def profile_lookup(idx, q, smi, calls: int = 3) -> None:
    """Device time by op over ``calls`` lookups, beside the wall time."""
    def run():
        for _ in range(calls):
            idx.lookup(q)
    traced(run, smi, "main_profile", batch=int(q.size), calls=calls)


def draw_keys(rng, n: int) -> np.ndarray:
    """A Bernoulli draw of n of the integers below 2^40, sorted, made
    O(n): geometric gaps with mean 2^40 / (1.01 n) sum to about
    0.99 * 2^40."""
    gaps = rng.geometric(min(1.0, 1.01 * n / 2 ** 40), n)
    keys = (np.cumsum(gaps) - 1).astype(np.float64)
    if keys[-1] >= 2 ** 40:
        raise AssertionError("key draw ran past 2^40")
    return keys


def phase_main(rng, n_keys, seed, smi, profile=False) -> dict:
    from repro_torch.core import Index
    from repro_torch.kernels.lookup import fused_lookup, fused_lookup_plain
    t0 = time.perf_counter()
    keys = draw_keys(rng, n_keys)
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
    xla_ms = xla_engine_lookups(idx, batches, timing, smi)

    # the kernel at the main path's shapes, held against its plain
    # version; these launches are after the count was read
    per_batch = {}
    for n_b, q in batches.items():
        args, statics, got, err = kernel_case(f"main_{n_b}", idx, q)
        k_t = kernel_times(lambda: fused_lookup(*args, **statics),
                           "fused_lookup_kernel")
        p_ms = cuda_ms(lambda: fused_lookup_plain(*args, **statics),
                       launches=5)
        sk, qs = args[9], args[0]
        lib_ms = cuda_ms(lambda: torch.searchsorted(sk, qs, right=True))
        # the kernel's device time against its flat width, same inputs
        # (other widths give other answers; this times the rank loop)
        by_fw = {fw: profiled_device_ms(
            lambda: fused_lookup(*args, **dict(statics, flat_w=fw)),
            "fused_lookup_kernel")[0] for fw in (8, 32, 256)}
        nbytes = fused_bytes(args, statics, got)
        nops = fused_ops(statics, qs.shape[0])
        bound_ms = max(nbytes / H100_BYTES_PER_S,
                       nops / H100_F32_OPS_PER_S) * 1e3
        per_batch[n_b] = dict(
            **k_t, plain_ms=p_ms, library_ms=lib_ms,
            device_ms_by_flat_w=by_fw,
            bound_ms=bound_ms,
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
            "main": main_stats, "lookup_ms": timing, "xla_ms": xla_ms,
            "index": idx, "keys": keys, "queries": batches}


def xla_engine_lookups(idx, batches, kernel_ms, smi) -> dict:
    """The read phase's batches through a ``QueryEngine(fused_impl=
    "xla")`` over the same frozen arrays: the reference's own non-TPU
    path (the rank-router graph in torch ops, its escapes patched on the
    host), every answer held against the host oracle, timed beside the
    kernel engine's ``Index.lookup`` (host clock, median of 5 warm
    calls; it launches no kernel of the port)."""
    from types import SimpleNamespace

    from repro_torch.kernels.lookup import fused_lookup
    from repro_torch.kernels.ops import QueryEngine
    eng = idx.sync_device()
    t0 = time.perf_counter()
    xeng = QueryEngine(eng.arrays, eng.err_lo, eng.err_hi,
                       fused_impl="xla", w_tile=eng.w_tile)
    setup_s = time.perf_counter() - t0
    launches0 = fused_lookup.launches
    out = {}
    for n_b, q in batches.items():
        for _ in range(2):
            xeng.lookup(q)
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            pay, slot, found, n_fb = xeng.lookup(q)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        check_against_host(SimpleNamespace(payloads=pay, slots=slot,
                                           found=found), idx.gapped, q)
        if xeng.last_stage != "fused":
            raise AssertionError(f"xla engine served by {xeng.last_stage}")
        out[n_b] = statistics.median(times)
        emit("main_lookup_xla", card=smi, batch=n_b, fused_impl="xla",
             stage=xeng.last_stage, ms_per_batch=out[n_b],
             kernel_engine_ms_per_batch=kernel_ms[n_b],
             escapes_patched_on_host=int(n_fb), setup_seconds=setup_s,
             answers_equal_host_oracle=True)
    if fused_lookup.launches != launches0:
        raise AssertionError("the xla engine launched the lookup kernel")
    del xeng
    return out


# ---------------------------------------------------------------------------
# the write path: the ingest-place kernel, fused and two-dispatch ingest
# ---------------------------------------------------------------------------

PLACE_NAMES = ("p", "pv", "ub", "flags")
FUSED_GATE = 1 << 22   # Index._fused_eligible: n_slots < 2^22
PLACE_GATE = 1 << 24   # Index._device_placements: n_slots < 2^24
# insert batch sizes: 16,384 is insert_batch's largest chunk
# (GappedArray.batch_chunk), beyond which the device placements are not
# used; 4,096 is its smallest
FUSED_SIZES = (16_384, 4_096)
PLACE_SIZES = (16_384,)


def place_args(a, keys, n_pad: int = 0):
    """``ingest_place``'s 13 tensor arguments for f64 ``keys`` against
    the frozen arrays ``a`` (+inf padding rows up to ``n_pad``)."""
    from repro_torch.kernels.freeze import split_key_pair
    x_hi, x_lo = split_key_pair(keys)
    pad = max(0, n_pad - x_hi.size)
    x_hi = np.concatenate([x_hi, np.full(pad, np.inf, np.float32)])
    x_lo = np.concatenate([x_lo, np.zeros(pad, np.float32)])
    link_hi, link_lo = a.link_keys, a.link_keys_lo
    if int(link_hi.shape[0]) == 0:  # as ops_gap.ingest_place passes it
        link_hi = torch.full((1,), float("inf"), device=a.device)
        link_lo = torch.zeros(1 if a.key_wide else 0, device=a.device)
    return (torch.from_numpy(x_hi).cuda(), torch.from_numpy(x_lo).cuda(),
            a.seg_first_key, a.seg_first_key_lo, a.seg_slope,
            a.seg_slope_lo, a.seg_icept, a.seg_icept_lo, a.slot_key,
            a.slot_key_lo, a.link_offsets, link_hi, link_lo)


def place_vs_plain(name, args, n_slots) -> tuple:
    """Kernel vs plain version on identical CUDA inputs; raises unless
    all four outputs are equal.  Returns the kernel's outputs and the
    largest absolute difference seen (0 when they are equal)."""
    from repro_torch.kernels.gap_place import (ingest_place,
                                               ingest_place_plain)
    got = ingest_place(*args, n_slots=n_slots)
    want = ingest_place_plain(*args, n_slots=n_slots)
    torch.cuda.synchronize()
    err = 0
    for n, g, w in zip(PLACE_NAMES, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {n} differs in shape or type")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"in {n} ({int((g != w).sum())} rows)")
    return got, err


def escape_band_keys(rng, idx, lo, hi, n):
    """Absent keys whose f64 prediction lies closest to a .5 rounding
    boundary (the double-f32 escape band), from 2^20 candidates."""
    ga = idx.gapped
    cand = np.unique(np.floor(rng.uniform(lo, hi, 1 << 20)))
    cand = cand[~np.isin(cand, ga.slot_key)]
    y = idx.mech.predict(cand)
    near = np.argsort(np.abs(y - np.floor(y) - 0.5))[:n]
    return cand[near]


def phase_place_cases(rng) -> list:
    """Phase 4: the ingest-place kernel against its plain version."""
    rows = []
    for name, span in (("narrow", 2 ** 24), ("wide", 2 ** 40)):
        idx, keys = build_case_index(rng, span, 400_000, n_mids=40_000)
        ga = idx.gapped
        a = idx.sync_device().arrays
        chain = longest_chain_keys(ga)
        live = np.concatenate([ga.slot_key, ga.links.chain_keys])
        near_chain = np.setdiff1d(np.concatenate([chain - 1.0, chain + 1.0]),
                                  live)
        band = escape_band_keys(rng, idx, keys[0], keys[-1], 2048)
        absent = np.floor(rng.uniform(keys[0], keys[-1], 14_000))
        edges = np.concatenate([keys[0] - 1.0 - np.arange(64.0),
                                keys[-1] + 1.0 + np.arange(64.0)])
        batch = np.concatenate([near_chain, band, absent, edges])
        n_pad = 1 << int(batch.size - 1).bit_length()
        got, _err = place_vs_plain(f"place_{name}",
                                   place_args(a, batch, n_pad), a.n_slots)
        flags = got[3][:batch.size].cpu().numpy()
        esc = (flags & 4) != 0
        # the escape-patched primitives equal the host oracle
        prims, esc2 = idx._engine.ingest_place(batch)
        if not np.array_equal(esc, esc2):
            raise AssertionError(f"place_{name}: wrapper escapes differ")
        host = ga.placement_primitives(batch)
        for f, v in prims.items():
            v[esc] = host[f][esc]
            if not np.array_equal(v, host[f]):
                raise AssertionError(f"place_{name}: patched {f} differs "
                                     "from the host oracle")
        ub = got[2][:batch.size].cpu().numpy()
        rows.append({"case": f"place_{name}", "n_keys": int(keys.size),
                     "batch": int(batch.size), "padded": n_pad,
                     "key_wide": a.key_wide,
                     "max_chain_live": int(ga.links.max_chain),
                     "longest_chain": int(chain.size),
                     "near_chain_keys": int(near_chain.size),
                     "escape_band_keys": int(band.size),
                     "escapes": int(esc.sum()),
                     "escapes_in_band_keys": int(esc[near_chain.size:
                                                     near_chain.size
                                                     + band.size].sum()),
                     "free": int((flags & 1).sum()),
                     "bracket": int(((flags & 2) != 0).sum()),
                     "below_first": int((ub == -1).sum()),
                     "outputs_equal": 4, "tolerance": TOL,
                     "patched_equal_host_oracle": True})
        emit("place_vs_plain", **rows[-1])
        if not rows[-1]["escapes_in_band_keys"]:
            raise AssertionError(f"place_{name}: no key in the escape band")
        rows.append(place_search_case(rng, f"search_{name}", idx, keys))
        emit("place_vs_plain", **rows[-1])
    idx, keys = build_case_index(rng, 2 ** 40, 200_000, n_mids=20_000)
    run = keys[50_000:60_000]             # 10,000 neighbours: one gap run
    idx.remove(run)
    rows.append(place_search_case(rng, "search_long_gap_run", idx, keys,
                                  inside=run))
    emit("place_vs_plain", **rows[-1])
    if rows[-1]["max_p_minus_pv"] < 8_000:
        raise AssertionError("search_long_gap_run: no key walked the run")
    return rows


def far_keys(rng, a, lo, hi, n_cand=1 << 18):
    """Per segment, the absent key (of ``n_cand`` drawn) whose predicted
    slot lies farthest from its ``ub``: the search from ``p`` walks the
    segment's full error distance."""
    from repro_torch.kernels.gap_place import ingest_place_plain
    cand = np.unique(np.floor(rng.uniform(lo, hi, n_cand)))
    args = place_args(a, cand)
    p, _pv, ub, _f = ingest_place_plain(*args, n_slots=a.n_slots)
    dist = (p.long() - ub.long()).abs().cpu().numpy()
    seg = np.searchsorted(a.seg_first_key.cpu().numpy(),
                          cand.astype(np.float32), side="right")
    order = np.lexsort((-dist, seg))
    first = order[np.r_[True, seg[order][1:] != seg[order][:-1]]]
    return cand[first], int(dist.max())


def place_search_case(rng, name, idx, keys, inside=None) -> dict:
    """The new searches of ``ingest_place`` against the plain version's
    whole-array bisects: keys at each segment's full error distance
    from ``ub``, keys whose ``p`` clips to 0 and to ``n_slots - 1``,
    keys below the first slot and above the last, keys next to the
    longest chain, ``inside`` (keys of a deleted range: ``pv`` walks
    its gap run) and +inf padding rows; all four outputs bit for
    bit."""
    ga = idx.gapped
    a = idx.sync_device().arrays
    far, far_dist = far_keys(rng, a, keys[0], keys[-1])
    chain = longest_chain_keys(ga)
    near_chain = np.concatenate([chain - 1.0, chain + 1.0, chain])
    steps = 2.0 ** np.arange(0, 40, 3)
    edges = np.concatenate([keys[0] - steps, keys[-1] + steps,
                            [keys[0], keys[-1]]])
    inside = np.zeros(0) if inside is None else inside
    batch = np.concatenate([far, near_chain, edges, inside,
                            np.floor(rng.uniform(keys[0], keys[-1], 4096))])
    n_pad = 1 << int(batch.size + 64 - 1).bit_length()
    got, _err = place_vs_plain(name, place_args(a, batch, n_pad), a.n_slots)
    p, pv, ub = (t.long().cpu().numpy() for t in got[:3])
    m_pad = int(a.slot_key.shape[0])
    row = {"case": name, "n_slots": int(a.n_slots), "m_pad": m_pad,
           "key_wide": a.key_wide, "batch": int(batch.size),
           "padded": n_pad, "far_keys": int(far.size),
           "max_p_minus_ub": int(np.abs(p - ub)[:batch.size].max()),
           "max_p_minus_ub_drawn": far_dist,
           "max_p_minus_pv": int((p - pv)[:batch.size].max()),
           "p_at_0": int((p == 0).sum()),
           "p_at_last_slot": int((p == a.n_slots - 1).sum()),
           "ub_below_first": int((ub == -1).sum()),
           "ub_at_last": int((ub == m_pad - 1).sum()),
           "pv_none": int((pv == -1).sum()),
           "near_chain_keys": int(near_chain.size),
           "deleted_range_keys": int(inside.size),
           "outputs_equal": 4, "tolerance": TOL}
    for k in ("p_at_0", "p_at_last_slot", "ub_below_first", "ub_at_last"):
        if not row[k]:
            raise AssertionError(f"{name}: no row with {k}")
    return row


def place_bytes(args, got) -> int:
    """Least bytes one launch moves: the keys in and the four outputs
    out, plus each distinct table entry the kernel reads for these keys,
    once: the segment and slot keys its three bisects visit (replayed
    through ``gap_place._bisect_pair``'s visit hook, from the kernel's
    own ``p``), the slope and intercept pairs of each routed segment,
    the slot keys at ``p``, ``p + 1`` and ``pv``, the CSR offsets at
    ``pv`` and ``pv + 1`` and the chain tail's link key."""
    from repro_torch.kernels import gap_place as gp
    (x_hi, x_lo, segk, segkl, slope, slopel, icept, iceptl, sk, skl, off,
     lk, lkl) = args
    p, pv = got[0].long(), got[1].long()
    touched = {"seg": [], "slot": [], "off": [], "link": []}

    def visit(table):
        return touched[table].append

    segl, sl = gp._lo(segkl, segk), gp._lo(skl, sk)
    seg = gp._bisect_pair(segk, segl, x_hi, x_lo, gp._trips(segk.shape[0]),
                          False, visit("seg")).clamp(0, segk.shape[0] - 1)
    slot_trips = gp._trips(sk.shape[0])
    gp._bisect_pair(sk, sl, x_hi, x_lo, slot_trips, False, visit("slot"))
    gp._bisect_pair(sk, sl, sk[p], sl[p], slot_trips, True, visit("slot"))
    pvs = pv.clamp(min=0)
    r = p + 1
    touched["seg"].append(seg)
    touched["slot"] += [p, r[r < sk.shape[0]], pvs]
    touched["off"] += [pvs, pvs + 1]
    if lk.shape[0]:
        e0 = off[pvs + 1].long()
        touched["link"].append((e0 - 1).clamp(0, lk.shape[0] - 1))
    per_entry = {"seg": 8 if segkl.shape[0] else 4,
                 "slot": 8 if skl.shape[0] else 4, "off": 4,
                 "link": 8 if lkl.shape[0] else 4}
    n = x_hi.numel()
    total = n * 8 + n * 4 * 4          # key pairs in; p, pv, ub, flags out
    total += int(torch.unique(seg).numel()) * 16   # slope, icept pairs
    for table, idx in touched.items():
        if idx:
            total += (int(torch.unique(torch.cat(idx)).numel())
                      * per_entry[table])
    return total


def place_ops(args) -> int:
    """f32 operations per launch: the double-f32 prediction (~45) and
    three pair compares per bisect trip."""
    from repro_torch.kernels.gap_place import _trips
    n = args[0].numel()
    trips = _trips(args[2].shape[0]) + 2 * _trips(args[8].shape[0])
    return n * (45 + 3 * trips)


def time_place(idx, keys, smi, label) -> dict:
    """Kernel, plain version, ``torch.searchsorted`` (``ub`` alone) and
    the byte bound at one batch of ``keys``."""
    from repro_torch.kernels.gap_place import (ingest_place,
                                               ingest_place_plain)
    a = idx.sync_device().arrays
    args = place_args(a, keys)
    n_slots = a.n_slots
    got, err = place_vs_plain(f"timing_{label}", args, n_slots)
    k_t = kernel_times(lambda: ingest_place(*args, n_slots=n_slots),
                       "ingest_place_kernel")
    p_ms = cuda_ms(lambda: ingest_place_plain(*args, n_slots=n_slots),
                   launches=5)
    sk, xh = args[8], args[0]
    lib_ms = cuda_ms(lambda: torch.searchsorted(sk, xh, right=True))
    nbytes = place_bytes(args, got)
    nops = place_ops(args)
    t_b, t_o = nbytes / H100_BYTES_PER_S, nops / H100_F32_OPS_PER_S
    row = dict(**k_t, plain_ms=p_ms, library_ms=lib_ms,
               bound_ms=max(t_b, t_o) * 1e3,
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, ops=nops, batch=int(keys.size),
               n_slots=int(n_slots), key_wide=a.key_wide, max_abs_err=err)
    emit("place_timing", card=smi, index=label, **row,
         library_call="torch.searchsorted(slot_key, x_hi, right=True): "
                      "ub only, and on the hi half only",
         kernel_vs_plain=TOL)
    return row


def gated_build(rng, seed, counts, gate, label):
    """Build over the first key count of ``counts`` whose slot count is
    under ``gate``; returns ``(index, init keys, held keys)`` with 30%
    of the drawn keys held out (the w = 0.3 dynamic workload)."""
    from repro_torch.core import Index
    for n_init in counts:
        allk = draw_keys(rng, int(round(n_init / 0.7)))
        perm = rng.permutation(allk.size)
        init = np.sort(allk[perm[:n_init]])
        idx = Index.build(init, method="pgm", eps=64, gap_rho=0.15,
                          sample_rate=0.01, rng=np.random.default_rng(seed),
                          device="cuda")
        emit("write_build", path=label, n_keys=int(n_init),
             n_slots=int(idx.gapped.n_slots), gate=gate,
             under_gate=idx.gapped.n_slots < gate,
             build_seconds=idx.build_seconds)
        if idx.gapped.n_slots < gate:
            return idx, init, allk[perm[n_init:]]
    raise AssertionError(f"{label}: no key count fits n_slots < {gate}")


def lookup_check(rng, idx, smi, label, step) -> dict:
    """2^16 mixed queries on the card, held against the host oracle.
    The engine serves a batch whose kernel escapes overflow its escape
    buffer (``fb_cap``) on the device oracle stage and boosts that
    bucket's buffer for the next call; the check records which stage
    served, the kernel's escapes and the buffer they met."""
    from repro_torch.kernels.bounds import auto_q_tile
    ga = idx.gapped
    slot_keys = ga.slot_key[ga.occupied]          # sorted
    q = mixed_queries(rng, slot_keys, ga.links.chain_keys, 1 << 16,
                      slot_keys[0])
    eng = idx.sync_device()
    b = eng.bucket(q.size)
    q_tile = min(b, auto_q_tile(b, eng.arrays.n_slots, eng.w_tile))
    fb_cap = int(min(b, eng._cap_boost.get(b, 1)
                     * max(q_tile, int(np.ceil(eng.fb_frac * b)))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = idx.lookup(q)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if res.backend not in ("fused", "device-oracle"):
        raise AssertionError(f"{label}: lookup served by {res.backend!r}")
    check_against_host(res, ga, q)
    return {"step": step, "ms": ms, "served_by": res.backend,
            "kernel_escapes": eng.last_escapes, "fb_cap": fb_cap,
            "q_tile": q_tile, "fallbacks": res.fallbacks,
            "oracle_escapes": res.oracle_escapes}


def host_replay(ga, ops) -> None:
    """The same writes on ``ga``, a copy of the GappedArray taken before
    any write: host placements and host partition only."""
    for kind, keys, pays in ops:
        if kind == "ingest":
            ga.insert_batch(keys, pays)
        elif kind == "remove":
            ga.delete_batch(keys)
        else:
            ga.update_batch(keys, pays)


def assert_same_state(g1, g2, label) -> None:
    same = (np.array_equal(g1.slot_key, g2.slot_key)
            and np.array_equal(g1.occupied, g2.occupied)
            and np.array_equal(g1.payload, g2.payload)
            and g1.n_keys == g2.n_keys
            and all(np.array_equal(a, b) for a, b in
                    zip(g1.export_csr_links(), g2.export_csr_links())))
    if not same:
        raise AssertionError(f"{label}: state differs from the host replay")


def held_batches(held, sizes, limit):
    """The held-out keys in order, in at most ``limit`` batches cycling
    through ``sizes`` (the last one takes what is left)."""
    pos, b = 0, 0
    while pos < held.size and b < limit:
        n = min(sizes[b % len(sizes)], held.size - pos)
        yield held[pos:pos + n]
        pos += n
        b += 1


def admissible_batches(rng, idx, n_batches, n):
    """Batches the fused gate can commit at any index size: absent keys
    between consecutive occupied slots, at most one per 4 runs (no two
    rows share a gap run, so no collision group, D1 or D4 demotion), and
    predicted at least 0.05 from a rounding boundary in f64 (outside the
    escape band, |band| <= ~0.01 below 2^22 slots).  Built from the
    state at the time of each batch."""
    for _ in range(n_batches):
        ga = idx.gapped
        occ = np.flatnonzero(ga.occupied)
        left = occ[1:-2:4]
        lo, hi = ga.slot_key[left], ga.slot_key[left + 1]
        mid = np.floor(lo + (hi - lo) * rng.uniform(0.2, 0.8, lo.size))
        y = idx.mech.predict(mid)
        frac = y - np.floor(y)
        ok = (mid > lo) & (mid < hi) & (np.abs(frac - 0.5) > 0.05)
        ok &= (y > 1.0) & (y < ga.n_slots - 2.0)
        cand = np.setdiff1d(mid[ok], ga.links.chain_keys)
        if cand.size < n:
            raise AssertionError("too few fused-admissible keys")
        yield rng.permutation(rng.choice(cand, n, replace=False))


class Counter:
    """Payload numbering shared by the segments of one phase."""

    def __init__(self, start):
        self.next = start

    def take(self, n):
        out = self.next + np.arange(n, dtype=np.int64)
        self.next += n
        return out


class HostTimes:
    """Inclusive host seconds per write-path stage, by wrapping the
    stage functions for the duration of a ``with`` block."""

    def __init__(self):
        from repro_torch.core import gaps, handle
        from repro_torch.kernels import delta, ops
        self.targets = [
            (gaps.GappedArray, "insert_batch"),
            (gaps.GappedArray, "placement_primitives"),
            (ops.QueryEngine, "fused_ingest"),
            (ops.QueryEngine, "ingest_place"),
            (delta, "delta_update"),
            (delta, "snapshot_sources"),
            (handle.Index, "refreeze"),
            (handle.Index, "_refresh_window_bounds"),
            (handle.Index, "_key_caps_after_batch"),
        ]
        self.seconds = {}
        self.saved = []

    def __enter__(self):
        for owner, name in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn, name))
        return self

    def _wrap(self, fn, name):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t0)
        return timed

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False


def run_writes(rng, idx, smi, label, batches, pays, ops, *,
               churn_every=0, check_every=8, profile=False) -> dict:
    """Drive the write path over ``batches`` (an iterable of key
    arrays): ``Index.ingest`` each, with a delete and a payload-update
    batch of 4,096 present keys every ``churn_every`` insert batches and
    a lookup check every ``check_every``.  Appends every write to
    ``ops`` for the host replay; returns the segment's counts."""
    reports, checks = [], []
    ms_by = {}
    n_churn = 0
    secs = {"ingest": 0.0, "churn": 0.0, "lookup_checks": 0.0}
    idx.sync_device()
    torch.cuda.synchronize()
    stages = HostTimes()
    t_run = time.perf_counter()
    with stages:
        t0 = time.perf_counter()
        checks.append(lookup_check(rng, idx, smi, label, 0))
        secs["lookup_checks"] += time.perf_counter() - t0
        for b, keys in enumerate(batches):
            n = int(keys.size)
            pay = pays.take(n)
            t0 = time.perf_counter()
            if profile and b in (8, 9):  # a 16,384 and a 4,096 batch
                box = []
                traced(lambda: box.append(idx.ingest(keys, pay)), smi,
                       "write_profile", path=label, batch=n)
                rep, ms = box[0], None
            else:
                rep = idx.ingest(keys, pay)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            secs["ingest"] += time.perf_counter() - t0
            ops.append(("ingest", keys, pay))
            reports.append(rep)
            if ms is not None:
                ms_by.setdefault(rep.device, []).append(ms)
            if churn_every and (b + 1) % churn_every == 0:
                t0 = time.perf_counter()
                ga = idx.gapped
                dk = rng.choice(ga.slot_key[ga.occupied], 4096,
                                replace=False)
                idx.remove(dk)
                ops.append(("remove", dk, None))
                uk = rng.choice(ga.slot_key[ga.occupied], 4096,
                                replace=False)
                up = pays.take(4096)
                idx.update_batch(uk, up)
                ops.append(("update", uk, up))
                n_churn += 1
                secs["churn"] += time.perf_counter() - t0
            if (b + 1) % check_every == 0:
                t0 = time.perf_counter()
                checks.append(lookup_check(rng, idx, smi, label, b + 1))
                secs["lookup_checks"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        checks.append(lookup_check(rng, idx, smi, label, len(reports)))
        secs["lookup_checks"] += time.perf_counter() - t0
    if checks[-1]["served_by"] != "fused":
        raise AssertionError(f"{label}: the last lookup check was served "
                             f"by {checks[-1]['served_by']!r}, not the "
                             "kernel")
    devices, placements = {}, {}
    for r in reports:
        devices[r.device] = devices.get(r.device, 0) + 1
        placements[r.placement] = placements.get(r.placement, 0) + 1
    aborts = {}
    for r in reports:
        for name in r.abort_reasons:
            aborts[name] = aborts.get(name, 0) + 1
    out = {
        "insert_batches": len(reports),
        "inserted": int(sum(r.n for r in reports)),
        "delete_batches": n_churn, "update_batches": n_churn,
        "device": devices, "placement": placements,
        "batches_with_abort_reason": aborts,
        "slot": int(sum(r.slot for r in reports)),
        "chain": int(sum(r.chain for r in reports)),
        "contested": int(sum(r.contested for r in reports)),
        "ms_per_batch": {k: {"batches": len(v),
                             "median": statistics.median(v),
                             "mean": statistics.fmean(v),
                             "max": max(v)} for k, v in ms_by.items()},
        "lookup_checks": len(checks),
        "lookup_checks_served_by_oracle": sum(
            c["served_by"] != "fused" for c in checks),
        "lookup_ms_median": statistics.median(c["ms"] for c in checks),
        "lookup_fallbacks": sum(c["fallbacks"] for c in checks),
        "lookup_oracle_escapes": sum(c["oracle_escapes"] for c in checks),
        "lookup_check_steps": [
            {k: c[k] for k in ("step", "served_by", "kernel_escapes",
                               "fb_cap", "q_tile")} for c in checks],
        "loop_seconds": secs,
        "host_stage_seconds": stages.seconds,
        "run_seconds": time.perf_counter() - t_run,
        "answers_equal_host_oracle": True}
    emit("write_path", card=smi, path=label,
         n_slots=int(idx.gapped.n_slots), **out)
    return out


def write_phase(rng, seed, smi, label, counts, gate, segments) -> dict:
    """Build under ``gate``, reset the launch counts, run the segments
    (``(name, batches_fn, kwargs)``; ``batches_fn(idx, held)`` gives the
    batches), read the counts, and hold the final state against a
    host-only replay of every write from a copy taken before the
    first."""
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    idx, _init, held = gated_build(rng, seed, counts, gate, label)
    host_ga = copy.deepcopy(idx.gapped)
    ops = []
    pays = Counter(1 << 30)
    ingest_place.launches = 0
    fused_lookup.launches = 0
    segs = {}
    for name, batches_fn, kw in segments:
        segs[name] = run_writes(rng, idx, smi, f"{label}/{name}",
                                batches_fn(idx, held), pays, ops, **kw)
    launches = {"ingest_place": ingest_place.launches,
                "fused_lookup": fused_lookup.launches}
    t0 = time.perf_counter()
    host_replay(host_ga, ops)
    assert_same_state(idx.gapped, host_ga, label)
    res = {"launches": launches, "segments": segs,
           "n_slots": int(idx.gapped.n_slots), "n_keys": int(idx.keys.size),
           "writes": len(ops), "refreezes": idx.stats["refreezes"],
           "delta_updates": idx.stats["delta_updates"],
           "fused_ingests": idx.stats.get("fused_ingests", 0),
           "fused_abort_total": idx.stats.get("fused_abort_total", 0),
           "split_commits": idx.stats.get("split_commits", 0),
           "ingest_place_escapes": idx.stats.get("ingest_place_escapes", 0),
           "host_replay_seconds": time.perf_counter() - t0,
           "state_equals_host_replay": True}
    emit("write_phase", card=smi, path=label,
         **{k: v for k, v in res.items() if k != "segments"})
    res["index"] = idx
    res["held_left"] = held[sum(s["inserted"] for n, s in segs.items()
                                if n == "w0.3"):]
    return res


def phase_fused(rng, seed, smi, n_init, n_batches, profile=False) -> dict:
    """Phase 5: the fused write path under the 2^22 gate — the
    w = 0.3 traffic (its fused commit rate is the phase's number), then
    the mechanism test: batches built to pass the gate, which must
    commit ``fused``."""
    counts = [n_init] if n_init else [3_600_000, 3_500_000, 3_400_000]
    res = write_phase(rng, seed, smi, "fused", counts, FUSED_GATE, [
        ("w0.3",
         lambda idx, held: held_batches(held, FUSED_SIZES, n_batches),
         dict(churn_every=16, profile=profile)),
        ("mechanism",
         lambda idx, held: admissible_batches(rng, idx, 8, 4096), {}),
    ])
    w03 = res["segments"]["w0.3"]
    committed = sum(w03["device"].get(k, 0) for k in ("fused", "fused+delta"))
    res["w03_fused_commit_rate"] = committed / w03["insert_batches"]
    emit("fused_commit_rate", card=smi, traffic="w0.3",
         fused_commits=committed, insert_batches=w03["insert_batches"],
         rate=res["w03_fused_commit_rate"],
         mechanism_test_fused=res["segments"]["mechanism"]["device"].get(
             "fused", 0))
    if not res["segments"]["mechanism"]["device"].get("fused"):
        raise AssertionError("fused: no batch of the mechanism test "
                             "committed on the fused path")
    if not res["launches"]["ingest_place"]:
        raise AssertionError("fused: the path never launched ingest_place")
    return res


def phase_two_dispatch(rng, seed, smi, n_init, n_batches,
                       profile=False) -> dict:
    """Phase 6: device placements + delta sync under the 2^24 gate."""
    counts = [n_init] if n_init else [14_500_000, 14_000_000]

    def batches(idx, held):
        if idx.gapped.n_slots < FUSED_GATE:
            raise AssertionError("two_dispatch: the index fits the fused "
                                 "gate")
        return held_batches(held, PLACE_SIZES, n_batches)

    res = write_phase(rng, seed, smi, "two_dispatch", counts, PLACE_GATE, [
        ("w0.3", batches, dict(profile=profile))])
    seg = res["segments"]["w0.3"]
    if not seg["device"].get("delta"):
        raise AssertionError("two_dispatch: no delta sync")
    if not res["launches"]["ingest_place"]:
        raise AssertionError("two_dispatch: the path never launched "
                             "ingest_place")
    return res


# ---------------------------------------------------------------------------
# device Eq. 3 and the legacy lookup backends: the gap-place and
# legacy-lookup kernels
# ---------------------------------------------------------------------------

LEGACY_TILES = ((128, 512, 128), (256, 2048, 512), (512, 4096, 1024))
LEGACY_BATCHES = (1 << 20, 4096)   # a throughput and a serving batch


def same_bits(name, got, want, names) -> float:
    """Raise unless every output is equal (NaN equals NaN in a float
    output); returns the largest absolute difference seen (0 when they
    are equal)."""
    err = 0.0
    for n, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {n} differs in shape or type")
        if g.is_floating_point():
            nan = g.isnan() & w.isnan()
            eq = (g == w) | nan
            if g.numel():
                d = (g.double() - w.double()).abs()
                err = max(err, float(torch.where(nan, 0.0, d).max()))
        else:
            eq = g == w
            if g.numel():
                err = max(err, float((g.long() - w.long()).abs().max()))
        if not bool(eq.all()):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"in {n} ({int((~eq).sum())} elements)")
    return err


def eq3_args(x, plm, rho, key_tile, seg_chunk, lead=()):
    """``gap_place``'s tensor arguments on the card for keys ``x``
    (sorted f64; ``lead`` keys put in front, e.g. below the first
    segment), padded with +inf to a multiple of ``key_tile``."""
    from repro_torch.kernels.freeze import _pad_pow
    from repro_torch.kernels.ops_gap import prepare_gap_tables
    tables = prepare_gap_tables(x, np.arange(x.size, dtype=np.float64),
                                plm, rho, seg_chunk)
    xs = np.concatenate([np.asarray(lead, np.float64), x])
    xp = _pad_pow(xs.astype(np.float32), key_tile, np.float32(np.inf))
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (xp, *tables)], xs.size


def eq3_vs_plain(name, args, n_real, key_tile, seg_chunk) -> float:
    from repro_torch.kernels.gap_place import gap_place, gap_place_plain
    tiling = dict(key_tile=key_tile, seg_chunk=seg_chunk)
    got = gap_place(*args, **tiling)
    want = gap_place_plain(*args, **tiling)
    torch.cuda.synchronize()
    err = same_bits(name, (got,), (want,), ("positions",))
    if not (bool(got[n_real:].isnan().all())
            and bool(got[:n_real].isfinite().all())):
        raise AssertionError(f"{name}: padding rows not NaN or real rows "
                             "not finite")
    return err


def legacy_args(a, q_sorted, err_lo, *, q_tile, w_tile, edge_tiles=False):
    """``lookup_kernel``'s tensor arguments for sorted f64 queries
    against the frozen arrays ``a``: +inf padding to whole tiles (plus
    one more tile with ``edge_tiles``), the pallas stage's own tile
    schedule, and with ``edge_tiles`` the first tile's window moved to
    the last block pair and the second-to-last tile's to the first."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import predict_ref
    n = q_sorted.size
    pad = (-n) % q_tile + (q_tile if edge_tiles else 0)
    qp = np.concatenate([q_sorted, np.full(pad, np.inf)])
    qs = torch.from_numpy(qp.astype(np.float32)).cuda()
    elo = ops._pad_bounds(err_lo, a.seg_first_key.shape[0], "cuda")
    y_hat, seg = predict_ref(qs, a.seg_first_key, a.seg_slope, a.seg_icept)
    lo = ops._clip(y_hat + elo[seg] - 1.0, ops._slot_clip_hi(a.n_slots))
    tb = ops.tile_blocks(lo, a, q_tile=q_tile, w_tile=w_tile)
    if edge_tiles:
        tb[0] = a.slot_key.shape[0] // w_tile - 2
        tb[-2] = 0
    return (qs, tb, a.seg_first_key, a.seg_slope, a.seg_icept, a.slot_key)


def legacy_vs_plain(name, args, tiling) -> tuple:
    from repro_torch.kernels.lookup import lookup_kernel, lookup_kernel_plain
    got = lookup_kernel(*args, **tiling)
    want = lookup_kernel_plain(*args, **tiling)
    torch.cuda.synchronize()
    return got, same_bits(name, got, want, ("slot", "found", "fb", "pred"))


def phase_legacy_cases(rng) -> list:
    """Phase 7: the gap-place and legacy-lookup kernels against their
    plain versions on identical CUDA inputs, bit for bit."""
    from repro_torch.kernels.freeze import from_learned_index
    rows = []
    for span in (2 ** 24, 2 ** 40):
        idx, keys = build_case_index(rng, span, 400_000)
        plm = idx.mech.plm
        lead = [keys[0] - 2.0 ** 20, keys[0] - 1.0]   # below segment 0
        for key_tile, seg_chunk in ((256, 128), (2048, 1024)):
            name = f"eq3_{'narrow' if span <= 2 ** 24 else 'wide'}_" \
                   f"{key_tile}_{seg_chunk}"
            args, n_real = eq3_args(keys, plm, 0.15, key_tile, seg_chunk,
                                    lead)
            err = eq3_vs_plain(name, args, n_real, key_tile, seg_chunk)
            rows.append({"case": name, "kernel": "gap_place",
                         "n_keys": int(keys.size), "padded":
                         int(args[0].numel()), "k_pad":
                         int(args[1].numel()), "below_first_segment":
                         len(lead), "max_abs_err": err, "tolerance":
                         TOL + " (NaN equals NaN)"})
            emit("legacy_kernel_vs_plain", **rows[-1])
    idx, keys = build_case_index(rng, 2 ** 24, 400_000, n_mids=40_000)
    plm = idx.mech.plm
    below = keys[0] - 1.0 - np.arange(64.0)
    above = keys[-1] + 1.0 + np.arange(64.0)
    q = np.sort(np.concatenate([
        mixed_queries(rng, keys, idx.gapped.links.chain_keys, 30_000,
                      keys[0]), below, above]))
    for q_tile, w_tile, win_chunk in LEGACY_TILES:
        a = from_learned_index(idx, "cuda", w_tile=w_tile)
        args = legacy_args(a, q, plm.err_lo, q_tile=q_tile, w_tile=w_tile,
                           edge_tiles=True)
        tiling = dict(q_tile=q_tile, w_tile=w_tile, win_chunk=win_chunk)
        name = f"legacy_{q_tile}_{w_tile}_{win_chunk}"
        got, err = legacy_vs_plain(name, args, tiling)
        found, fb = got[1][:q.size], got[2][:q.size]
        rows.append({"case": name, "kernel": "lookup_kernel",
                     "n_keys": int(keys.size), "queries": int(q.size),
                     "padded": int(args[0].numel()),
                     "below_keys": int(below.size),
                     "above_keys": int(above.size),
                     "found": int(found.sum()), "escapes": int(fb.sum()),
                     "edge_windows": "first tile at the last block pair, "
                                     "second-to-last at the first",
                     "max_abs_err": err, "outputs_equal": 4,
                     "tolerance": TOL + " (NaN equals NaN)"})
        emit("legacy_kernel_vs_plain", **rows[-1])
        if not rows[-1]["escapes"] or not rows[-1]["found"]:
            raise AssertionError(f"{name}: no escape or no hit exercised")
    return rows


def phase_bracket_cases() -> list:
    """Phase 7, continued: the cases the two kernels' bracket designs
    introduce, on the inputs tests/test_torch_kernel_gpu.py builds,
    each held against the plain version bit for bit, with each case's
    premise counts."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_kernel_gpu as kc
    rows = []
    for case in kc.GAP_CASES:
        args, n_real = kc.gap_case_args(case)
        name = f"eq3_{case}"
        err = eq3_vs_plain(name, args, n_real, 1024, 512)
        rows.append({"case": name, "kernel": "gap_place",
                     "n_keys": n_real, "padded": int(args[0].numel()),
                     "k_pad": int(args[1].numel()),
                     "premise": eq3_premise(args), "max_abs_err": err,
                     "tolerance": TOL + " (NaN equals NaN)"})
        emit("legacy_kernel_vs_plain", **rows[-1])
    shapes = ([(c, 128, 2048) for c in kc.LEGACY_CASES]
              + [("tiling", qt, wt) for qt, wt in kc.LEGACY_TILINGS])
    for case, q_tile, w_tile in shapes:
        args = (kc.legacy_case_args(case) if case != "tiling"
                else kc.legacy_tiling_args(q_tile, w_tile))
        tiling = dict(q_tile=q_tile, w_tile=w_tile)
        name = f"legacy_{case}_{q_tile}_{w_tile}"
        got, err = legacy_vs_plain(name, args, tiling)
        rows.append({"case": name, "kernel": "lookup_kernel",
                     "queries": int(args[0].numel()),
                     "premise": legacy_premise(args, q_tile, w_tile),
                     "found": int(got[1].sum()),
                     "escapes": int(got[2].sum()), "max_abs_err": err,
                     "outputs_equal": 4,
                     "tolerance": TOL + " (NaN equals NaN)"})
        emit("legacy_kernel_vs_plain", **rows[-1])
    return rows


def eq3_premise(args) -> dict:
    """The Eq. 3 kernel's premise on these inputs, counted on the host:
    chunks of ``GAP_CHUNK`` keys whose least and greatest key fall in
    different segments (those bisect inside their bracket), and chunks
    whose bracket has more table rows than are staged."""
    from repro_torch.kernels.gap_place import (GAP_CHUNK, GAP_ROW_CAP,
                                               gap_place_brackets)
    segk = args[1].cpu()
    lo, hi = gap_place_brackets(args[0].cpu(), segk)
    k_pad = segk.numel()
    rows = hi.clamp(max=k_pad - 1) - (lo - 1).clamp(min=0) + 1
    spanning = int((lo != hi).sum())
    return {"chunk_keys": GAP_CHUNK, "chunks": lo.numel(),
            "chunks_spanning_segments": spanning,
            "share_spanning": spanning / lo.numel(),
            "chunks_over_row_cap": int((rows > GAP_ROW_CAP).sum()),
            "row_cap": GAP_ROW_CAP}


def legacy_premise(args, q_tile, w_tile) -> dict:
    """The legacy kernel's premise on these inputs, counted on the host:
    the bytes the tiles staged as whole windows (the earlier design) and
    as the slices this one stages (``lookup_kernel_brackets``, not
    counting the rounding to 16-byte bounds), the slice widths, tiles
    whose slice does not fit the buffer, and tiles in one segment."""
    from repro_torch.kernels.lookup import (LEGACY_SLICE_CAP,
                                            lookup_kernel_brackets)
    start, _, r_hi, s_lo, s_hi = lookup_kernel_brackets(
        *(args[i].cpu() for i in (0, 1, 2, 5)), q_tile=q_tile,
        w_tile=w_tile)
    width = (r_hi - start).clamp(min=0)
    fits = width <= LEGACY_SLICE_CAP
    return {"tiles": width.numel(),
            "window_bytes_whole": width.numel() * 2 * w_tile * 4,
            "slice_bytes_staged": int(width[fits].sum()) * 4,
            "slice_width_median": float(width.double().median()),
            "slice_width_max": int(width.max()),
            "slice_cap": LEGACY_SLICE_CAP,
            "tiles_wider_than_buffer": int((~fits).sum()),
            "tiles_in_one_segment": int((s_lo == s_hi).sum())}


def eq3_bytes(args) -> int:
    """Each key read once (4 bytes), each position written once, and
    the four tables read once."""
    n = args[0].numel()
    return n * 8 + sum(t.numel() * 4 for t in args[1:])


def phase_eq3(main_res, smi) -> dict:
    """Phase 8: device Eq. 3 (``gap_positions_device``) over the read
    phase's keys with its index's model, held against the f64 oracle at
    the reference's tolerance; the kernel timed at that size."""
    from repro_torch.kernels.gap_place import gap_place, gap_place_plain
    from repro_torch.kernels.ops_gap import (gap_positions_device,
                                             gap_positions_oracle)
    idx, keys, rho = main_res["index"], main_res["keys"], 0.15
    plm = idx.mech.plm
    gap_place.launches = 0        # counts from the main path's run only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = gap_positions_device(keys, plm, rho)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    launches = gap_place.launches
    if launches == 0:
        raise AssertionError("gap_positions_device never launched "
                             "gap_place")
    t0 = time.perf_counter()
    ora = gap_positions_oracle(keys, plm, rho)
    ora_s = time.perf_counter() - t0
    n = keys.size
    tol = 0.5 + 2e-5 * np.abs(ora)
    bad = int(np.count_nonzero(~(np.abs(dev - ora) <= tol)))
    monotone = bool(np.all(np.diff(dev) >= 0))
    budget = float(dev[-1] - (n - 1))
    if bad or not monotone or budget > rho * n + 1.0:
        raise AssertionError(f"eq3: {bad} positions past rtol 2e-5 / atol "
                             f"0.5, monotone {monotone}, budget {budget}")
    args, _ = eq3_args(keys, plm, rho, 1024, 512)
    err = eq3_vs_plain("eq3_main", args, n, 1024, 512)
    k_t = kernel_times(lambda: gap_place(*args), "gap_place_kernel")
    p_ms = cuda_ms(lambda: gap_place_plain(*args), launches=5)
    segk, xp = args[1], args[0]
    lib_ms = cuda_ms(lambda: torch.searchsorted(segk, xp, right=True))
    nbytes = eq3_bytes(args)
    nops = n * (int(segk.numel()).bit_length() + 3)
    t_b, t_o = nbytes / H100_BYTES_PER_S, nops / H100_F32_OPS_PER_S
    row = dict(**k_t, plain_ms=p_ms, library_ms=lib_ms,
               bound_ms=max(t_b, t_o) * 1e3,
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, ops=nops, max_abs_err=err, launches=launches)
    emit("eq3", card=smi, n_keys=int(n), segments=int(plm.n_segments),
         k_pad=int(segk.numel()), rho=rho,
         device_seconds=dev_s, oracle_seconds=ora_s,
         max_abs_diff_vs_oracle=float(np.max(np.abs(dev - ora))),
         max_rel_diff_vs_oracle=float(np.max(np.abs(dev - ora)
                                             / np.maximum(ora, 1.0))),
         positions_past_tolerance=bad, tolerance="rtol 2e-5, atol 0.5",
         monotone=monotone, gaps_inserted=budget,
         budget=rho * n + 1.0, **row, premise=eq3_premise(args),
         library_call="torch.searchsorted(seg_first_key, keys, right=True):"
                      " the segment routing only",
         kernel_vs_plain=TOL + " (NaN equals NaN)")
    return row


def timed_lookups(idx, q, backend, warm=5, reps=5):
    """Warm up (until the bucket's escape buffer holds the batch's
    escapes, at most ``warm`` calls), then ms per batch over ``reps``
    calls; returns ``(last result, ms, warm-up oracle escapes, timed
    oracle escapes)``."""
    warm_esc = 0
    for _ in range(warm):
        r = idx.lookup(q, backend=backend)
        warm_esc += r.oracle_escapes
        if r.oracle_escapes == 0:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    esc = 0
    for _ in range(reps):
        res = idx.lookup(q, backend=backend)
        esc += res.oracle_escapes
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3 / reps, warm_esc, esc


def legacy_bytes(args, w_tile) -> int:
    """Each query read once (4 bytes), slot, found, fb and pred written
    once (10 bytes), the tile schedule, the segment tables, and the slot
    keys of each distinct window block the tiles read (4 bytes each)."""
    qs, tb, segk = args[0], args[1], args[2]
    blocks = torch.unique(torch.cat([tb, tb + 1]))
    return (qs.numel() * 14 + tb.numel() * 4 + 3 * segk.numel() * 4
            + int(blocks.numel()) * w_tile * 4)


def phase_legacy(rng, seed, smi, n_keys, main_res) -> dict:
    """Phase 9: the legacy backends at full size.  ``pallas`` over a
    narrow index (keys below 2^24) at 2^20 and 4,096 mixed queries,
    ``xla-windowed`` at 2^20 on it and on the read phase's wide index,
    every answer held against the host oracle; the legacy kernel timed
    at the 2^20 shapes."""
    from repro_torch.core import Index
    from repro_torch.kernels.bounds import auto_q_tile
    from repro_torch.kernels.lookup import lookup_kernel, lookup_kernel_plain
    t0 = time.perf_counter()
    keys = np.sort(rng.choice(1 << 24, n_keys, replace=False)
                   ).astype(np.float64)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.01, rng=np.random.default_rng(seed),
                      device="cuda")
    ga = idx.gapped
    eng = idx.sync_device()
    a = eng.arrays
    if a.key_wide:
        raise AssertionError("legacy: the narrow index froze wide keys")
    emit("legacy_build", card=smi, n_keys=int(keys.size),
         n_slots=int(ga.n_slots), segments=int(ga.mech.plm.n_segments),
         k_pad=int(a.seg_first_key.numel()), key_wide=a.key_wide,
         build_seconds=idx.build_seconds,
         setup_seconds=time.perf_counter() - t0)
    lookup_kernel.launches = 0    # counts from the main path's run only
    served = {}
    batches = {}
    for n_b in LEGACY_BATCHES:
        q = mixed_queries(rng, keys, ga.links.chain_keys, n_b, keys[0])
        res, ms, warm_esc, esc = timed_lookups(idx, q, "pallas")
        check_against_host(res, ga, q)
        b = eng.bucket(n_b)
        served[n_b] = res.backend
        batches[n_b] = q
        emit("legacy_lookup", card=smi, index="narrow", backend="pallas",
             batch=n_b, served_by=res.backend, ms_per_batch=ms,
             ns_per_query=ms * 1e6 / n_b,
             q_tile=min(b, auto_q_tile(b, a.n_slots, eng.w_tile)),
             kernel_escapes=eng.last_escapes, fallbacks=res.fallbacks,
             warmup_oracle_escapes=warm_esc, oracle_escapes=esc,
             answers_equal_host_oracle=True)
    launches = lookup_kernel.launches
    if launches == 0:
        raise AssertionError("the pallas backend never launched "
                             "lookup_kernel")
    big = LEGACY_BATCHES[0]
    if served[big] != "pallas":
        raise AssertionError(f"the {big}-query pallas batch was served by "
                             f"{served[big]!r}, not the kernel")
    xla = {}
    for name, xidx, xkeys in (("narrow", idx, keys),
                              ("wide", main_res["index"],
                               main_res["keys"])):
        xga = xidx.gapped
        q = mixed_queries(rng, xkeys, xga.links.chain_keys, big, xkeys[0])
        res, ms, warm_esc, esc = timed_lookups(xidx, q, "xla-windowed")
        check_against_host(res, xga, q)
        xeng = xidx.sync_device()
        if res.backend != "xla-windowed":
            raise AssertionError(f"xla-windowed on the {name} index was "
                                 f"served by {res.backend!r}")
        xla[name] = ms
        emit("legacy_lookup", card=smi, index=name,
             backend="xla-windowed", batch=big, served_by=res.backend,
             ms_per_batch=ms, ns_per_query=ms * 1e6 / big,
             key_wide=xeng.arrays.key_wide, flat_w=xeng._flat_w,
             trips=xeng._trips, fallbacks=res.fallbacks,
             warmup_oracle_escapes=warm_esc, oracle_escapes=esc,
             answers_equal_host_oracle=True)

    # the kernel at the main path's 2^20 shapes, held against its plain
    # version; these launches are after the count was read
    q = np.sort(batches[big])
    q_tile = auto_q_tile(q.size, a.n_slots, eng.w_tile)
    args = legacy_args(a, q, eng.err_lo, q_tile=q_tile, w_tile=eng.w_tile)
    tiling = dict(q_tile=q_tile, w_tile=eng.w_tile)
    got, err = legacy_vs_plain("legacy_main", args, tiling)
    k_t = kernel_times(lambda: lookup_kernel(*args, **tiling),
                       "lookup_kernel")
    p_ms = cuda_ms(lambda: lookup_kernel_plain(*args, **tiling),
                   launches=5)
    sk, qs = args[5], args[0]
    lib_ms = cuda_ms(lambda: torch.searchsorted(sk, qs, right=True))
    nbytes = legacy_bytes(args, eng.w_tile)
    per_q = (int(2 * eng.w_tile).bit_length()
             + int(a.seg_first_key.numel()).bit_length() + 6)
    nops = qs.numel() * per_q
    t_b, t_o = nbytes / H100_BYTES_PER_S, nops / H100_F32_OPS_PER_S
    row = dict(**k_t, plain_ms=p_ms, library_ms=lib_ms,
               bound_ms=max(t_b, t_o) * 1e3,
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, ops=nops, max_abs_err=err, launches=launches,
               q_tile=q_tile, escapes=int(got[2][:q.size].sum()))
    emit("legacy_timing", card=smi, batch=int(q.size), **row,
         premise=legacy_premise(args, q_tile, eng.w_tile),
         library_call="torch.searchsorted(slot_key, q, right=True): slot "
                      "only, over the whole array",
         kernel_vs_plain=TOL + " (NaN equals NaN)")
    row.update(pallas_served=served, xla_ms=xla)
    return row


# ---------------------------------------------------------------------------
# the serving stack: EpochPipeline and MicroBatchQueue over the fused
# write path, the ingest WAL with crash recovery, snapshots, MDL
# self-tuning and retrain
# ---------------------------------------------------------------------------

# YCSB core workloads (Cooper et al., SoCC 2010) as
# benchmarks/serving_bench.py defines them: (name, read fraction, Zipf
# theta, build); mix 1 lets the §3 MDL auto-tuner pick the mechanism
SERVE_MIXES = (("ycsb_b", 0.95, 0.99, {"method": "auto"}),
               ("ycsb_a", 0.5, 0.0, {"method": "pgm", "eps": 64}))
SERVE_ROUNDS = 32
SERVE_WRITE = 4_096     # fresh keys (gap midpoints) ingested a round
SERVE_CALL = 2_048      # keys a lookup call
SERVE_CALLERS = 8
SERVE_CHECKPOINT = 8    # a checkpoint every 8 rounds (rounds 4, 12, ...)


def zipf_sampler(n_items, theta, rng):
    """Bounded Zipf(theta) over ranks 0..n_items-1 (theta = 0: uniform)
    by the inverse CDF, ranks spread over the key space by a fixed
    permutation (benchmarks/serving_bench.py's YCSB request model)."""
    if theta <= 0.0:
        return lambda size: rng.integers(0, n_items, size)
    w = 1.0 / np.power(np.arange(1, n_items + 1, dtype=np.float64), theta)
    cdf = np.cumsum(w / w.sum())
    perm = rng.permutation(n_items)
    return lambda size: perm[np.searchsorted(cdf, rng.random(size))]


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*")
               if p.is_file())


def check_served(res, ga, q) -> None:
    """One answer against the host oracle ``ga`` at the state it was
    served from: a snapshot answer is the bounded host search's (its
    slot for a query below every key is 0), a device answer is held as
    ``check_against_host`` holds it."""
    if res.backend != "snapshot":
        check_against_host(res, ga, q)
        return
    pay, slot, found = ga.lookup_batch(q, full=True)
    if not (np.array_equal(res.payloads, pay)
            and np.array_equal(res.slots, slot)
            and np.array_equal(res.found, found)):
        raise AssertionError("a snapshot answer differs from the host "
                             "oracle at its epoch")


def serve_callers(queue, calls, n_callers):
    """``calls`` (query arrays) from ``n_callers`` threads, round robin:
    each caller submits, waits out the queue's deadline (its timer
    thread flushes every pending call as one batch) and takes its
    result (flushing itself if the timer has not).  Returns ``(query,
    result, ms)`` per call and the shed submits (a shed caller submits
    again).  A call's time ends in ``torch.cuda.synchronize``."""
    from repro_torch.serving import Overloaded
    out, errors, shed = [], [], [0]
    lock = threading.Lock()

    def caller(mine):
        try:
            for q in mine:
                t0 = time.perf_counter()
                while True:
                    t = queue.submit_lookup(q)
                    time.sleep(queue.max_wait_ms / 1e3)
                    res = queue.result(t)
                    if not isinstance(res, Overloaded):
                        break
                    with lock:
                        shed[0] += 1
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    out.append((q, res, ms))
        except BaseException as e:   # re-raised by the driving thread
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=caller, args=(calls[i::n_callers],))
               for i in range(n_callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a lookup caller did not finish")
    if errors:
        raise errors[0]
    return out, shed[0]


def serve_build(rng, seed, counts, mix_kw, label):
    """The serving index: the first key count of ``counts`` whose slot
    count is under the fused gate (as phase 5)."""
    from repro_torch.core import Index
    for n in counts:
        keys = draw_keys(rng, n)
        t0 = time.perf_counter()
        idx = Index.build(keys, gap_rho=0.15, sample_rate=0.01,
                          rng=np.random.default_rng(seed), device="cuda",
                          **mix_kw)
        build_s = time.perf_counter() - t0
        if idx.gapped.n_slots < FUSED_GATE:
            idx.sync_device()    # a server freezes before it takes calls
            tuned = idx.tuned
            emit("serve_build", mix=label, n_keys=int(n),
                 n_slots=int(idx.gapped.n_slots), gate=FUSED_GATE,
                 method=idx.method, mech_kwargs=idx.mech_kwargs,
                 sample_rate=idx.sample_rate, build_seconds=build_s,
                 freeze_seconds=idx.stats["freeze_seconds"],
                 segments=int(idx.mech.plm.n_segments),
                 tuner=None if tuned is None else {
                     "method": tuned.method,
                     "mech_kwargs": tuned.mech_kwargs,
                     "score": tuned.score,
                     "sample_rate": tuned.sample_rate,
                     "candidates": list(tuned.candidates)})
            return idx, keys
    raise AssertionError(f"{label}: no key count fits n_slots < "
                         f"{FUSED_GATE}")


class ServeOracle:
    """Host-only replays of every write, as the serving gates read
    them: ``served`` holds the state of the served epoch, ``live`` the
    live index's layout; writes wait in ``pending`` until the publish
    that serves them.  A retrain relays out the live index: ``live``
    then starts from a copy of the retrained state."""

    def __init__(self, idx):
        self.idx = idx
        self.live = copy.deepcopy(idx.gapped)
        self.served = self.live
        self.pending = []
        self.retrains = idx.stats["retrains"]

    def write(self, keys, pays):
        self.pending.append((keys, pays))

    def published(self):
        for keys, pays in self.pending:
            self.live.insert_batch(keys, pays)
        self.pending = []
        self.served = self.live
        self.relayout()

    def relayout(self):
        if self.idx.stats["retrains"] != self.retrains:
            self.retrains = self.idx.stats["retrains"]
            self.live = copy.deepcopy(self.idx.gapped)


def restore_check(directory, step, idx, label) -> dict:
    """A checkpoint restored on the card equals the live state it was
    taken from, bit for bit."""
    from repro_torch.core import Index
    t0 = time.perf_counter()
    rest, extra = Index.restore(directory, step=step, device="cuda")
    secs = time.perf_counter() - t0
    assert_same_state(rest.gapped, idx.gapped, f"{label}: restore")
    probe = idx.keys[:: max(1, idx.keys.size // 65_536)]
    if not (rest.epoch == idx.epoch and rest.method == idx.method
            and rest.device == idx.device
            and np.array_equal(rest.mech.predict(probe),
                               idx.mech.predict(probe))):
        raise AssertionError(f"{label}: the restored index differs")
    return {"step": step, "restore_seconds": secs,
            "wal_lsn": extra["wal_lsn"]}


def serve_mix(rng, seed, smi, tmp, n_keys, label, read_frac, theta,
              mix_kw, last) -> dict:
    """One mix: 32 rounds of lookups from 8 callers and one ingest
    through a ``MicroBatchQueue`` over an ``EpochPipeline`` with a WAL,
    an auditor and the MDL-drift trigger; every answer held against the
    host oracle of the epoch it reports.  ``last`` (mix 1) adds the
    retrain during a pinned epoch, a torn WAL and the recovery."""
    from repro_torch.robustness import InvariantAuditor
    from repro_torch.serving import EpochPipeline, IngestWAL, MicroBatchQueue
    counts = [n_keys] if n_keys else [3_600_000, 3_500_000, 3_400_000]
    idx, keys = serve_build(rng, seed, counts, mix_kw, label)
    mids = np.setdiff1d(keys[:-1] + np.floor(np.diff(keys) * 0.5), keys)
    fresh = rng.permutation(mids)[:(SERVE_ROUNDS + 1) * SERVE_WRITE]
    oracle = ServeOracle(idx)
    ck_dir = tmp / f"{label}_checkpoints"
    wal_path = tmp / f"{label}.wal"
    wal = IngestWAL(wal_path, sync_every="adaptive")
    auditor = InvariantAuditor()
    t0 = time.perf_counter()
    pipe = EpochPipeline(idx, wal=wal, auditor=auditor, audit_every=8,
                         retrain_mdl_drift=0.05, retrain_check_every=8)
    mdl_init_s = time.perf_counter() - t0
    queue = MicroBatchQueue(pipe, max_wait_ms=2, max_depth=64)
    flushes = []
    serve_lookup = pipe.lookup

    def counted_lookup(q, **kw):
        flushes.append(int(q.shape[0]))
        return serve_lookup(q, **kw)

    pipe.lookup = counted_lookup   # the queue's one call a flush
    n_calls = max(1, int(round(read_frac / (1.0 - read_frac)
                               * SERVE_WRITE / SERVE_CALL)))
    sample = zipf_sampler(keys.size, theta, rng)
    lat, by_stage, devices, placements = [], {}, {}, {}
    ingest_ms, checkpoints, shed = [], [], 0
    acked_after_ck, written = [], 0
    pays = Counter(1 << 30)     # payloads stay in the narrow freeze
    t_run = time.perf_counter()
    for r in range(SERVE_ROUNDS):
        if r % SERVE_CHECKPOINT == SERVE_CHECKPOINT // 2:
            t0 = time.perf_counter()
            d = pipe.checkpoint(ck_dir, step=r)
            ck_s = time.perf_counter() - t0
            checkpoints.append({"checkpoint_seconds": ck_s,
                                "bytes": dir_bytes(d),
                                **restore_check(ck_dir, r, idx, label)})
            acked_after_ck = []
        served_epoch = pipe.epoch
        calls = []
        for _ in range(n_calls):
            q = keys[sample(SERVE_CALL)]
            if written:   # one in ten reads asks for a written key
                k = SERVE_CALL // 10
                q[:k] = fresh[rng.integers(0, written, k)]
            calls.append(q)
        out, n_shed = serve_callers(queue, calls, SERVE_CALLERS)
        shed += n_shed
        for q, res, ms in out:
            if res.epoch != served_epoch:
                raise AssertionError(f"{label}: an answer reports epoch "
                                     f"{res.epoch}, served {served_epoch}")
            check_served(res, oracle.served, q)
            by_stage.setdefault(res.backend, []).append(ms)
            lat.append(ms)
        batch = fresh[r * SERVE_WRITE:(r + 1) * SERVE_WRITE]
        pay = pays.take(batch.size)
        t0 = time.perf_counter()
        rep = queue.result(queue.submit_ingest(batch, pay))
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
        devices[rep.device] = devices.get(rep.device, 0) + 1
        placements[rep.placement] = placements.get(rep.placement, 0) + 1
        oracle.write(batch, pay)
        oracle.relayout()
        acked_after_ck.append((batch, pay))
        written += batch.size
        if r % 2:
            pipe.publish()
            oracle.published()
    loop_s = time.perf_counter() - t_run
    t0 = time.perf_counter()
    mdl = idx.mdl()
    mdl_s = time.perf_counter() - t0
    res = {"n_keys": int(keys.size), "n_slots": int(idx.gapped.n_slots),
           "method": idx.method, "mech_kwargs": idx.mech_kwargs,
           "read_fraction": read_frac, "zipf": theta,
           "rounds": SERVE_ROUNDS, "lookup_calls_per_round": n_calls,
           "lookup_calls": len(lat),
           "lookup_ms_p50": float(np.percentile(lat, 50)),
           "lookup_ms_p99": float(np.percentile(lat, 99)),
           "lookup_ms_by_stage": {
               k: {"calls": len(v), "p50": float(np.percentile(v, 50)),
                   "p99": float(np.percentile(v, 99)), "max": max(v)}
               for k, v in by_stage.items()},
           "pipeline_live_lookups": pipe.stats["live_lookups"],
           "pipeline_snapshot_lookups": pipe.stats["snapshot_lookups"],
           "flushes": len(flushes),
           "flush_keys": {"min": min(flushes), "median":
                          statistics.median(flushes), "max": max(flushes)},
           "callers_per_flush": (queue.stats["coalesced_lookups"]
                                 / max(1, queue.stats["lookup_dispatches"])),
           "deadline_flushes": queue.stats["deadline_flushes"],
           "shed": shed + queue.stats["shed"],
           "ingest_devices": devices, "ingest_placements": placements,
           "ingest_ms_median": statistics.median(ingest_ms),
           "ingest_ms_max": max(ingest_ms),
           "fused_commits": idx.stats.get("fused_ingests", 0),
           "fused_aborts": idx.stats.get("fused_abort_total", 0),
           "split_commits": idx.stats.get("split_commits", 0),
           "wal_bytes": int(wal.lsn), "wal_stats": dict(wal.stats),
           "checkpoints": checkpoints,
           "mdl_checks": pipe.stats["mdl_checks"],
           "mdl_retrains": pipe.stats["mdl_retrains"],
           "mdl_seconds": mdl_s, "mdl_init_seconds": mdl_init_s,
           "mdl_score": mdl.mdl, "audits": pipe.stats["audits"],
           "publishes": pipe.stats["publishes"],
           "loop_seconds": loop_s, "answers_equal_host_oracle": True}
    if last:
        res.update(serve_retrain(rng, pipe, queue, oracle, idx, keys,
                                 fresh, pays, wal_path, label))
    queue.close()
    pipe.close()                       # closes (fsyncs) the WAL
    if auditor.violations:
        raise AssertionError(f"{label}: auditor: {auditor.violations}")
    res["auditor_checks"] = auditor.checks
    if last:
        res.update(serve_recover(rng, keys, res.pop("pre_state"), ck_dir,
                                 wal_path, *res.pop("last_record"),
                                 len(acked_after_ck), label))
    else:
        res["index"] = idx
        res["fresh_left"] = fresh[SERVE_ROUNDS * SERVE_WRITE:]
    emit("serve_mix", card=smi, mix=label, **{
        k: v for k, v in res.items()
        if k not in ("index", "fresh_left", "recovered")})
    return res


def serve_retrain(rng, pipe, queue, oracle, idx, keys, fresh, pays,
                  wal_path, label) -> dict:
    """Mix 1's end: a retrain while the published snapshot is pinned
    (the snapshot must serve bit-identically across it), its publish,
    and one more ingest, whose WAL record the caller tears."""
    probe = np.concatenate([keys[rng.integers(0, keys.size, 4_096)],
                            fresh[:4_096]])
    snap = pipe._snapshot.retain()
    before = snap.lookup(probe)
    check_served(before, oracle.served, probe)
    t0 = time.perf_counter()
    rec = pipe.retrain(sample_rate=0.01, rng=np.random.default_rng(7))
    retrain_s = time.perf_counter() - t0
    during = pipe.lookup(probe)
    snap.release()
    if not (during.backend == "snapshot" and during.epoch == before.epoch
            and np.array_equal(during.payloads, before.payloads)
            and np.array_equal(during.slots, before.slots)
            and np.array_equal(during.found, before.found)):
        raise AssertionError(f"{label}: the pinned snapshot moved across "
                             "the retrain")
    pre_state = oracle.served    # every acked write, before the retrain
    pre_epoch = idx.epoch - 1
    oracle.relayout()
    k0, p0 = pre_state.live_items()
    k1, p1 = idx.gapped.live_items()
    if not (np.array_equal(k0, k1) and np.array_equal(p0, p1)):
        raise AssertionError(f"{label}: the retrain changed the key set")
    pipe.publish()
    oracle.published()
    after = pipe.lookup(probe)
    check_served(after, oracle.served, probe)
    batch = fresh[SERVE_ROUNDS * SERVE_WRITE:(SERVE_ROUNDS + 1)
                  * SERVE_WRITE]
    start = wal_path.stat().st_size
    queue.result(queue.submit_ingest(batch, pays.take(batch.size)))
    return {"retrain_seconds": retrain_s,
            "retrain_learn_seconds": rec["learn_seconds"],
            "retrain_chains": [rec["chains_before"], rec["chains_after"]],
            "snapshot_bit_identical_across_retrain": True,
            "served_after_retrain_by": after.backend,
            "pre_state": pre_state, "epoch_before_retrain": pre_epoch,
            "last_record": (start, wal_path.stat().st_size)}


def serve_recover(rng, keys, pre_state, ck_dir, wal_path, start, end,
                  n_acked, label) -> dict:
    """Tear the WAL at a random byte inside its last record, recover
    from the newest checkpoint on the card, and hold the result against
    the host-only replay of every acked write; then a 2^16 mixed lookup
    on the recovered index, served by the kernel."""
    from repro_torch.serving import recover_index
    cut = int(rng.integers(start + 1, end))
    with open(wal_path, "r+b") as f:
        f.truncate(cut)
    t0 = time.perf_counter()
    recovered, info = recover_index(ck_dir, wal_path, device="cuda")
    recover_s = time.perf_counter() - t0
    if not (info["torn"] and info["replayed"] == n_acked):
        raise AssertionError(f"{label}: recovery {info}, want {n_acked} "
                             "records replayed from a torn log")
    assert_same_state(recovered.gapped, pre_state, f"{label}: recovery")
    checks = []
    for _ in range(2):   # the first may meet a cold escape buffer
        q = mixed_queries(rng, keys, pre_state.links.chain_keys, 1 << 16,
                          keys[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = recovered.lookup(q)
        torch.cuda.synchronize()
        checks.append({"backend": r.backend,
                       "ms": (time.perf_counter() - t0) * 1e3})
        check_against_host(r, pre_state, q)
        if r.backend == "fused":
            break
    if checks[-1]["backend"] != "fused":
        raise AssertionError(f"{label}: the recovered index's lookup was "
                             f"served by {checks[-1]['backend']!r}")
    return {"wal_torn_at": [start, cut, end],
            "recover_seconds": recover_s,
            "replayed": info["replayed"], "skipped": info["skipped"],
            "restored_step": info["restored_step"],
            "recovered_epoch": recovered.epoch,
            "recovered_equals_host_replay": True,
            "recovered_lookups": checks, "recovered": recovered}


def phase_serve(rng, seed, smi, n_keys) -> dict:
    """Phase 10: the serving stack over the fused write path at the
    fused gate's size, mix 1 (YCSB-B, auto-tuned build, then retrain,
    torn WAL and recovery) and mix 2 (YCSB-A)."""
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    mixes = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        fused_lookup.launches = 0
        ingest_place.launches = 0
        for i, (label, rf, theta, kw) in enumerate(SERVE_MIXES):
            mixes[label] = serve_mix(rng, seed, smi, Path(tmp), n_keys,
                                     label, rf, theta, kw, last=i == 0)
        launches = {"fused_lookup": fused_lookup.launches,
                    "ingest_place": ingest_place.launches}
    if not (launches["fused_lookup"] and launches["ingest_place"]):
        raise AssertionError(f"serve: a kernel of the path never launched "
                             f"({launches})")
    # the kernels at the path's shapes against their plain versions:
    # the largest flush bucket of mix 1 on the recovered index, one
    # ingest batch on mix 2's index (after the counts were read)
    b_label, a_label = (m[0] for m in SERVE_MIXES)
    rec_idx = mixes[b_label].pop("recovered")
    bucket = max(1 << 9, 1 << int(np.ceil(np.log2(SERVE_CALLERS
                                                   * SERVE_CALL))))
    q = rec_idx.keys[rng.integers(0, rec_idx.keys.size, bucket)]
    _a, _s, _g, lookup_err = kernel_case("serve_flush", rec_idx, q)
    a_idx = mixes[a_label]["index"]
    arrays = a_idx.sync_device().arrays
    _got, place_err = place_vs_plain(
        "serve_ingest", place_args(arrays, mixes[a_label]["fresh_left"]),
        arrays.n_slots)
    del mixes[a_label]["index"], mixes[a_label]["fresh_left"]
    res = {"launches": launches, "mixes": mixes,
           "kernel_vs_plain": {"fused_lookup_bucket": bucket,
                               "fused_lookup_max_abs_err": lookup_err,
                               "ingest_place_batch": SERVE_WRITE,
                               "ingest_place_max_abs_err": place_err}}
    emit("serve_phase", card=smi, launches=launches,
         kernel_vs_plain=res["kernel_vs_plain"], tolerance=TOL)
    return res


# ---------------------------------------------------------------------------
# phase 11: the range-sharded index; phase 12: the index's consumers
# ---------------------------------------------------------------------------

SHARDS = 8              # benchmarks/shard_bench.py sweeps 2, 4 and 8
SHARD_WRITE_BATCHES = 8
SHARD_WRITE = 16_384
SHARD_CHECK = 1 << 16
SHARD_SERVE_SHARDS = 4
SHARD_SERVE_ROUNDS = 8
SHARD_SERVE_WRITE = 4_096
SHARD_SERVE_CHECKPOINT = 4   # the checkpoint before round 4 of 8


class UnionOracle:
    """The plain oracle of a written index: the sorted union of the
    build's keys and payloads and every insert, searched with numpy."""

    def __init__(self, keys, pays):
        self.keys = np.asarray(keys, np.float64)
        self.pays = np.asarray(pays, np.int64)

    def copy(self) -> "UnionOracle":
        return UnionOracle(self.keys.copy(), self.pays.copy())

    def insert(self, keys, pays) -> None:
        o = np.argsort(keys, kind="stable")
        at = np.searchsorted(self.keys, keys[o])
        self.keys = np.insert(self.keys, at, keys[o])
        self.pays = np.insert(self.pays, at, pays[o])

    def check(self, res, q, label) -> None:
        at = np.minimum(np.searchsorted(self.keys, q), self.keys.size - 1)
        found = self.keys[at] == q
        pay = np.where(found, self.pays[at], -1)
        bad = {"payloads": int(np.count_nonzero(res.payloads != pay)),
               "found": int(np.count_nonzero(res.found != found))}
        if any(bad.values()):
            raise AssertionError(f"{label}: answers differ from the union "
                                 f"oracle: {bad}")


def sharded_host_check(res, sharded, q, label, bounded=False) -> None:
    """Payloads, slots and found of a sharded answer against each
    shard's host oracle plus its slot base: the plain binary search for
    a device answer (its slot for a query below every key is -1, as on
    the device), the bounded search for a host-served one."""
    dst = np.searchsorted(sharded.router.bounds, q, side="right")
    bases = sharded._slot_bases()
    pay = np.full(q.size, -1, np.int64)
    slot = np.full(q.size, -1, np.int64)
    found = np.zeros(q.size, bool)
    for s in np.unique(dst):
        rows = np.flatnonzero(dst == s)
        p, sl, f = sharded.shards[s].gapped.lookup_batch(
            q[rows], bounded=bounded, full=True)
        pay[rows], found[rows] = p, f
        slot[rows] = np.where(sl >= 0, sl + bases[s], -1)
    bad = {"payloads": int(np.count_nonzero(res.payloads != pay)),
           "slots": int(np.count_nonzero(res.slots != slot)),
           "found": int(np.count_nonzero(res.found != found))}
    if any(bad.values()):
        raise AssertionError(f"{label}: answers differ from the shards' "
                             f"host oracles: {bad}")


def same_as_single(res, want, label) -> None:
    """Payload and found of a sharded answer equal the single-device
    index's answer on the same queries, bit for bit."""
    if not (np.array_equal(res.payloads, want.payloads)
            and np.array_equal(res.found, want.found)):
        raise AssertionError(f"{label}: sharded answers differ from the "
                             "single-device index's")


def uncounted(fn, *args, **kw):
    """``fn(*args, **kw)`` with the kernels' launch counts left as they
    were: a reference answer computed during a phase is not the
    phase's path."""
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    saved = fused_lookup.launches, ingest_place.launches
    try:
        return fn(*args, **kw)
    finally:
        fused_lookup.launches, ingest_place.launches = saved


def absent_keys(rng, present, n):
    """n integer keys drawn uniformly in the range of ``present`` (a
    sorted array) and absent from it, in random order."""
    cand = np.unique(np.floor(rng.uniform(present[0], present[-1], 2 * n)))
    at = np.minimum(np.searchsorted(present, cand), present.size - 1)
    cand = cand[present[at] != cand]
    if cand.size < n:
        raise AssertionError("too few absent keys drawn")
    return rng.permutation(rng.choice(cand, n, replace=False))


def timed_fanout(sh, q, label, reps=5) -> tuple:
    """Warm fan-out lookups of ``q`` (host clock ending in
    ``torch.cuda.synchronize``, median of ``reps``), after warm-up calls
    until the exchange sizing has stopped growing (at most 3)."""
    for _ in range(3):
        over = sh._fan.stats["cap_overflows"] if sh._fan else 0
        res = sh.lookup(q)
        if sh._fan.stats["cap_overflows"] == over:
            break
    fan = sh._fan
    st0 = dict(fan.stats)
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sh.lookup(q)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if res.backend != "sharded-fanout":
        raise AssertionError(f"{label}: served by {res.backend!r}")
    d = {k: fan.stats[k] - st0[k] for k in st0}
    return res, {"ms_per_batch": statistics.median(ms), "ms_runs": ms,
                 "escapes": res.fallbacks,
                 "cap_overflows": d["cap_overflows"],
                 "mispredict_fraction": d["mispredicts"] / max(1, d["routed"]),
                 "exchange_cap": fan._cap_for(fan._bucket(q.size))}


def shard_fanout_check(rng, sh, oracle, label) -> dict:
    """A 2^16 fan-out lookup after a write, held against the union
    oracle and the shards' host oracles; the fan-out must have been
    rebuilt on the shards' new epoch tag (its rebuild timed apart)."""
    q = np.concatenate([
        rng.choice(oracle.keys, 3 * SHARD_CHECK // 4),
        np.floor(rng.uniform(oracle.keys[0], oracle.keys[-1],
                             SHARD_CHECK // 4))])
    old = sh._fan
    t0 = time.perf_counter()
    fan = sh._fanout()
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    if fan is None or fan is old or fan.epochs != tuple(
            s.epoch for s in sh.shards):
        raise AssertionError(f"{label}: the fan-out was not rebuilt on the "
                             "new epoch tag")
    t0 = time.perf_counter()
    res = sh.lookup(q)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if res.backend != "sharded-fanout":
        raise AssertionError(f"{label}: served by {res.backend!r}")
    oracle.check(res, q, label)
    sharded_host_check(res, sh, q, label)
    return {"step": label, "stack_seconds": stack_s, "ms": ms,
            "escapes": res.fallbacks, "epoch": sh.epoch}


def phase_shard(rng, seed, smi, main_res, serve_keys, tmp,
                profile=False) -> dict:
    """Phase 11: the read cell's 32M keys range-sharded 8 ways; reads
    through the fan-out and the grouped path against the single-device
    index, writes against the union oracle and a host-only replay, a
    forced split and a retrain; then the durability of a 4-shard index
    at the serving size."""
    from repro_torch.core import Index
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    keys, single = main_res["keys"], main_res["index"]
    fused_lookup.launches = 0
    ingest_place.launches = 0
    t0 = time.perf_counter()
    sh = Index.build(keys, shards=SHARDS, method="pgm", eps=64,
                     gap_rho=0.15, sample_rate=0.01,
                     rng=np.random.default_rng(seed), device="cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fan = sh._fanout()
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    if fan is None:
        raise AssertionError("shard: the fan-out refused the read cell")
    fan_d, fan_bytes = fan.D, fan.device_bytes()
    emit("shard_build", card=smi, shards=SHARDS, n_keys=int(keys.size),
         per_shard=[{"shard": i, "n_keys": int(s.gapped.n_keys),
                     "n_slots": int(s.gapped.n_slots),
                     "under_placement_gate": s.gapped.n_slots < PLACE_GATE,
                     "under_fused_gate": s.gapped.n_slots < FUSED_GATE}
                    for i, s in enumerate(sh.shards)],
         fanout_devices=fan_d, fanout_device_bytes=fan_bytes,
         single_device_bytes=single.device_bytes(),
         key_wide=fan.statics["key_wide"], wide=fan.statics["wide"],
         trips=fan.statics["trips"], build_seconds=build_s,
         stack_seconds=stack_s)
    del fan
    reads = {}
    for n_b, q in main_res["queries"].items():
        res, row = timed_fanout(sh, q, f"shard/{n_b}")
        same_as_single(res, uncounted(single.lookup, q), f"shard/{n_b}")
        sharded_host_check(res, sh, q, f"shard/{n_b}")
        reads[n_b] = row
        emit("shard_lookup", card=smi, batch=n_b, backend=res.backend,
             **row, answers_equal_single_index=True,
             slots_equal_shard_oracles=True)
        if profile:
            traced(lambda: [sh.lookup(q) for _ in range(3)], smi,
                   "shard_profile", batch=n_b, calls=3)
    # the grouped path: each touched shard's fused stage, one launch each
    qg = mixed_queries(rng, keys, single.gapped.links.chain_keys,
                       SHARD_CHECK, keys[0])
    touched = int(np.unique(np.searchsorted(sh.router.bounds, qg,
                                            side="right")).size)
    n0 = fused_lookup.launches
    t0 = time.perf_counter()
    rg = sh.lookup(qg, backend="fused")
    torch.cuda.synchronize()
    grouped_s = time.perf_counter() - t0
    grouped_launches = fused_lookup.launches - n0
    if rg.backend != "sharded-host" or grouped_launches != touched:
        raise AssertionError(f"shard: grouped fused lookup {rg.backend!r}, "
                             f"{grouped_launches} launches for {touched} "
                             "touched shards")
    same_as_single(rg, uncounted(single.lookup, qg), "shard/grouped")
    sharded_host_check(rg, sh, qg, "shard/grouped")
    small = sh.lookup(qg[:256])
    if small.backend != "sharded-host":
        raise AssertionError(f"shard: a 256-query batch {small.backend!r}")
    same_as_single(small, uncounted(single.lookup, qg[:256]),
                   "shard/small")
    sharded_host_check(small, sh, qg[:256], "shard/small", bounded=True)
    b = sh.router.bounds
    qb = np.tile(np.concatenate([b, b - 1.0, b + 1.0, keys[:1],
                                 keys[:1] - 1.0, keys[-1:] + 17.0]), 64)
    rb = sh.lookup(qb)
    if rb.backend != "sharded-fanout":
        raise AssertionError(f"shard: boundary batch {rb.backend!r}")
    same_as_single(rb, uncounted(single.lookup, qb), "shard/boundaries")
    sharded_host_check(rb, sh, qb, "shard/boundaries")
    emit("shard_paths", card=smi, grouped_fused={
        "batch": SHARD_CHECK, "touched_shards": touched,
        "fused_lookup_launches": grouped_launches,
        "seconds_with_shard_freezes": grouped_s, "fallbacks": rg.fallbacks},
        small_batch_backend=small.backend, boundary_queries=int(qb.size),
        answers_equal_single_index=True)

    writes, oracle = shard_writes(rng, sh, keys, smi)
    launches = {"fused_lookup": fused_lookup.launches,
                "ingest_place": ingest_place.launches}
    if not all(launches.values()):
        raise AssertionError(f"shard: a kernel of the path never launched "
                             f"({launches})")
    vs_plain = shard_kernels_vs_plain(rng, sh, qg, oracle)
    emit("shard_kernels", card=smi, launches=launches,
         kernel_vs_plain=vs_plain, tolerance=TOL)
    del sh, single, oracle
    durable = shard_durability(rng, seed, smi, serve_keys, tmp)
    for k in launches:
        launches[k] += durable["launches"][k]
    return {"launches": launches, "kernel_vs_plain": vs_plain,
            "reads": reads, "writes": writes,
            "durability": durable, "build_seconds": build_s,
            "stack_seconds": stack_s, "fanout_devices": fan_d,
            "fanout_device_bytes": fan_bytes}


def shard_writes(rng, sh, keys, smi) -> dict:
    """Insert batches of absent keys, each shard's labels reported, the
    fan-out checked against the union oracle every 4th batch; the
    shards' states against a host-only replay; then a forced split of
    the largest shard and a retrain of shard 0, each checked."""
    for s in sh.shards:     # a server freezes before it takes writes
        s.sync_device()
    host_gas = [copy.deepcopy(s.gapped) for s in sh.shards]
    oracle = UnionOracle(keys, np.arange(keys.size))
    pays = Counter(1 << 30)
    splits0 = sh.stats["splits"]
    ops, ms, checks = [], [], []
    labels = {i: {"placement": {}, "device": {}}
              for i in range(len(sh.shards))}
    stages = HostTimes()
    with stages:
        for b in range(SHARD_WRITE_BATCHES):
            k = absent_keys(rng, oracle.keys, SHARD_WRITE)
            p = pays.take(k.size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = sh.ingest(k, p)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ops.append((k, p))
            oracle.insert(k, p)
            for s, r in rep.per_shard:
                for f in ("placement", "device"):
                    v = getattr(r, f)
                    labels[s][f][v] = labels[s][f].get(v, 0) + 1
            if (b + 1) % 4 == 0:
                checks.append(shard_fanout_check(rng, sh, oracle,
                                                 f"write {b + 1}"))
    if sh.stats["splits"] != splits0:
        raise AssertionError("shard: a watermark split ran during the "
                             "writes")
    t0 = time.perf_counter()
    for k, p in ops:
        dst = np.searchsorted(sh.router.bounds, k, side="right")
        for s in np.unique(dst):
            rows = np.flatnonzero(dst == s)
            host_gas[s].insert_batch(k[rows], p[rows])
    for s, ga in enumerate(host_gas):
        assert_same_state(sh.shards[s].gapped, ga, f"shard {s}")
    replay_s = time.perf_counter() - t0
    sizes = [s.gapped.n_keys for s in sh.shards]
    largest = int(np.argmax(sizes))
    split = sh.maybe_rebalance(force_shard=largest)
    if split is None or len(sh.shards) != SHARDS + 1:
        raise AssertionError("shard: the forced split did not run")
    checks.append(shard_fanout_check(rng, sh, oracle, "split"))
    retrain = sh.retrain(shard=0)
    checks.append(shard_fanout_check(rng, sh, oracle, "retrain"))
    out = {"insert_batches": len(ops), "inserted": int(sum(
        k.size for k, _ in ops)),
        "ms_per_batch": {"median": statistics.median(ms), "max": max(ms),
                         "runs": ms},
        "ms_per_batch_per_shard": statistics.median(ms) / SHARDS,
        "labels_by_shard": labels, "host_stage_seconds": stages.seconds,
        "state_equals_host_replay": True, "host_replay_seconds": replay_s,
        "split": {k: split[k] for k in ("shard", "n_left", "n_right",
                                        "seconds")},
        "retrain_seconds": retrain["seconds"], "checks": checks,
        "answers_equal_union_oracle": True}
    emit("shard_writes", card=smi, **out)
    return out, oracle


def shard_kernels_vs_plain(rng, sh, qg, oracle) -> dict:
    """Both kernels against their plain versions at the shapes phase 11
    gave them (after its counts were read): the grouped path's bucket
    on the shard that takes the most of ``qg``, and that shard's share
    of a write batch, absent keys in its range."""
    b = sh.router.bounds
    dst = np.searchsorted(b, qg, side="right")
    s = int(np.bincount(dst).argmax())
    shard = sh.shards[s]
    rows = qg[dst == s]
    bucket = shard.sync_device().bucket(rows.size)
    _a, _s, _g, lookup_err = kernel_case(f"shard_{s}_grouped", shard,
                                         np.resize(rows, bucket))
    lo = b[s - 1] if s else -np.inf
    hi = b[s] if s < b.size else np.inf
    present = oracle.keys[(oracle.keys >= lo) & (oracle.keys < hi)]
    batch = absent_keys(rng, present, SHARD_WRITE // SHARDS)
    arrays = shard.sync_device().arrays
    _got, place_err = place_vs_plain(f"shard_{s}_ingest",
                                     place_args(arrays, batch),
                                     arrays.n_slots)
    return {"shard": s, "n_slots": int(arrays.n_slots),
            "fused_lookup_bucket": int(bucket),
            "fused_lookup_max_abs_err": lookup_err,
            "ingest_place_batch": int(batch.size),
            "ingest_place_max_abs_err": place_err}


def shard_durability(rng, seed, smi, n_keys, tmp) -> dict:
    """A 4-shard index at the serving size through ``EpochPipeline``
    with an ``IngestWAL``: ingests, publishes every 2 rounds, lookups
    against the oracle of the published writes, a checkpoint mid-run,
    then one more ingest whose WAL record is torn, and
    ``recover_index`` on the card: every shard equals the pre-crash
    shard."""
    from repro_torch.core import Index
    from repro_torch.dist import ShardedIndex
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    from repro_torch.serving import EpochPipeline, IngestWAL, recover_index
    n = n_keys or 3_600_000
    keys = draw_keys(rng, n)
    n_l0, n_p0 = fused_lookup.launches, ingest_place.launches
    t0 = time.perf_counter()
    sh = Index.build(keys, shards=SHARD_SERVE_SHARDS, method="pgm", eps=64,
                     gap_rho=0.15, sample_rate=0.01,
                     rng=np.random.default_rng(seed), device="cuda")
    build_s = time.perf_counter() - t0
    for s in sh.shards:
        s.sync_device()
    mids = np.setdiff1d(keys[:-1] + np.floor(np.diff(keys) * 0.5), keys)
    fresh = rng.permutation(mids)[:(SHARD_SERVE_ROUNDS + 1)
                                  * SHARD_SERVE_WRITE]
    acked = UnionOracle(keys, np.arange(keys.size))
    served = acked.copy()
    ck_dir, wal_path = tmp / "shard_checkpoints", tmp / "shard.wal"
    pipe = EpochPipeline(sh, wal=IngestWAL(wal_path, sync_every="adaptive"))
    pays = Counter(1 << 30)
    ingest_ms, lookup_ms, by_backend = [], [], {}
    ck, n_after_ck = None, 0
    for r in range(SHARD_SERVE_ROUNDS):
        if r == SHARD_SERVE_CHECKPOINT:
            t0 = time.perf_counter()
            d = pipe.checkpoint(ck_dir, step=r)
            ck = {"step": r, "checkpoint_seconds": time.perf_counter() - t0,
                  "bytes": dir_bytes(d)}
            n_after_ck = 0
        batch = fresh[r * SHARD_SERVE_WRITE:(r + 1) * SHARD_SERVE_WRITE]
        p = pays.take(batch.size)
        t0 = time.perf_counter()
        pipe.ingest(batch, p)
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
        acked.insert(batch, p)
        n_after_ck += 1
        if r % 2:
            pipe.publish()
            served = acked.copy()
        q = np.concatenate([rng.choice(keys, 3_072),
                            fresh[rng.integers(0, (r + 1)
                                               * SHARD_SERVE_WRITE, 1_024)]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.lookup(q)
        torch.cuda.synchronize()
        lookup_ms.append((time.perf_counter() - t0) * 1e3)
        by_backend[res.backend] = by_backend.get(res.backend, 0) + 1
        served.check(res, q, f"shard durability round {r}")
    pre = [copy.deepcopy(s.gapped) for s in sh.shards]
    pre_bounds, pre_epoch = sh.router.bounds.copy(), sh.epoch
    start = wal_path.stat().st_size
    last = fresh[SHARD_SERVE_ROUNDS * SHARD_SERVE_WRITE:]
    pipe.ingest(last, pays.take(last.size))
    end = wal_path.stat().st_size
    pipe.close()
    cut = int(rng.integers(start + 1, end))
    with open(wal_path, "r+b") as f:
        f.truncate(cut)
    t0 = time.perf_counter()
    rec, info = recover_index(ck_dir, wal_path, device="cuda")
    recover_s = time.perf_counter() - t0
    if not (isinstance(rec, ShardedIndex) and info["torn"]
            and info["replayed"] == n_after_ck):
        raise AssertionError(f"shard recovery {info}, want {n_after_ck} "
                             "records replayed from a torn log")
    if not np.array_equal(rec.router.bounds, pre_bounds):
        raise AssertionError("shard recovery: router bounds differ")
    for i, (s, ga) in enumerate(zip(rec.shards, pre)):
        assert_same_state(s.gapped, ga, f"shard recovery, shard {i}")
        if s.device.type != "cuda":
            raise AssertionError("shard recovery: a shard is off the card")
    q = np.concatenate([rng.choice(acked.keys, 49_152),
                        np.floor(rng.uniform(keys[0], keys[-1], 16_384))])
    t0 = time.perf_counter()
    res = rec.lookup(q)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if res.backend != "sharded-fanout":
        raise AssertionError(f"shard recovery: served by {res.backend!r}")
    acked.check(res, q, "shard recovery")
    sharded_host_check(res, rec, q, "shard recovery")
    out = {"n_keys": int(n), "shards": SHARD_SERVE_SHARDS,
           "n_slots": [int(s.gapped.n_slots) for s in rec.shards],
           "build_seconds": build_s, "rounds": SHARD_SERVE_ROUNDS,
           "ingest_ms_median": statistics.median(ingest_ms),
           "lookup_ms_median": statistics.median(lookup_ms),
           "lookups_by_backend": by_backend, "checkpoint": ck,
           "wal_torn_at": [start, cut, end], "recover_seconds": recover_s,
           "replayed": info["replayed"], "skipped": info["skipped"],
           "epoch_before_crash": pre_epoch, "recovered_epoch": rec.epoch,
           "recovered_first_lookup_ms": first_ms,
           "recovered_equals_pre_crash": True,
           "launches": {"fused_lookup": fused_lookup.launches - n_l0,
                        "ingest_place": ingest_place.launches - n_p0}}
    emit("shard_durability", card=smi, **out)
    return out


KV_PAGES = 65_536       # vLLM's block size 16 and max_num_seqs 256
KV_PAGE = 16
KV_REQUESTS = 256
KV_PAGES_PER_REQUEST = 128
KV_GROUP = 64           # requests allocated together
DATA_DOCS = 1_000_000   # examples/streaming_ingest.py's widths
DATA_BATCH = 1_024
DATA_SEQ = 64


def phase_consumers(rng, seed, smi) -> dict:
    """Phase 12: the paged-KV block table and the indexed token dataset
    on the card, each answer held against its own host record."""
    from repro_torch.data import (IndexedTokenDataset, PackedTokenStore,
                                  ShardedLoader)
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    from repro_torch.serving.kv_cache import PagedKVCache, table_key
    fused_lookup.launches = 0
    ingest_place.launches = 0
    t0 = time.perf_counter()
    kv = PagedKVCache.create(n_pages=KV_PAGES, page_size=KV_PAGE,
                             expected_requests=KV_REQUESTS, device="cuda")
    kv.index.sync_device()
    create_s = time.perf_counter() - t0
    rids = np.arange(1, KV_REQUESTS + 1, dtype=np.int64)

    def kv_check(label, n=1 << 16):
        """2^16 (request, page) pairs, half mapped, on the device path,
        against the ``allocated`` dict."""
        mapped = np.array(list(kv.allocated.keys()), np.int64)
        pick = rng.choice(mapped, n // 2) if mapped.size else mapped
        r_un = rng.integers(1, KV_REQUESTS + 64, n - pick.size)
        p_un = rng.integers(KV_PAGES_PER_REQUEST, 2 * KV_PAGES_PER_REQUEST,
                            n - pick.size)
        q_r = np.concatenate([pick >> 20, r_un])
        q_p = np.concatenate([pick & ((1 << 20) - 1), p_un])
        want = np.array([kv.allocated.get(table_key(int(a), int(b)), -1)
                         for a, b in zip(q_r, q_p)], np.int64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = kv.lookup_batch(q_r, q_p, device=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, want):
            raise AssertionError(f"kv {label}: {int((got != want).sum())} "
                                 "pages differ from the allocation record")
        return {"step": label, "ms": ms, "mapped": int(np.sum(want >= 0))}

    alloc_ms, checks = [], []
    odd = np.arange(1, KV_PAGES_PER_REQUEST, 2)
    even = np.arange(0, KV_PAGES_PER_REQUEST, 2)
    for g in range(0, KV_REQUESTS, KV_GROUP):
        grp = rids[g:g + KV_GROUP]
        # fresh pages (the gaps) first, then the skeleton's claims
        for pages in (odd, even):
            r = np.repeat(grp, pages.size)
            pg = np.tile(pages, grp.size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kv.alloc_batch(r, pg)
            torch.cuda.synchronize()
            alloc_ms.append((time.perf_counter() - t0) * 1e3)
        checks.append(kv_check(f"alloc {g + KV_GROUP}"))
    for r in rids[::4]:
        kv.free_request(int(r), KV_PAGES_PER_REQUEST)
    checks.append(kv_check("after frees"))
    kv_out = {"n_pages": KV_PAGES, "page_size": KV_PAGE,
              "requests": KV_REQUESTS,
              "pages_per_request": KV_PAGES_PER_REQUEST,
              "create_seconds": create_s,
              "alloc_ms_median": statistics.median(alloc_ms),
              "utilization": kv.utilization,
              "path_stats": kv.insert_path_stats(), "checks": checks,
              "answers_equal_allocation_record": True}
    emit("consumers_kv", card=smi, **kv_out)

    t0 = time.perf_counter()
    store = PackedTokenStore.synthetic(DATA_DOCS, mean_len=64, vocab=32_000,
                                       seed=seed)
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = IndexedTokenDataset.build(store, method="pgm", eps=64,
                                   sample_rate=0.01, gap_rho=0.15,
                                   device="cuda")
    ds.index.sync_device()
    build_s = time.perf_counter() - t0
    loader = ShardedLoader(ds, global_batch=DATA_BATCH, seq_len=DATA_SEQ,
                           seed=seed)
    keys_sorted = store.sample_keys.astype(np.float64)

    def doc_rows(sample_keys):
        out = np.zeros((sample_keys.size, DATA_SEQ + 1), np.int32)
        for i, o in enumerate(np.searchsorted(keys_sorted, sample_keys)):
            d = store.doc(int(o))[:DATA_SEQ + 1]
            out[i, :d.size] = d
        return out

    batch_ms = []
    for step in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = loader.next_batch()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        sel = loader._perm[step * DATA_BATCH:(step + 1) * DATA_BATCH]
        want = doc_rows(keys_sorted[sel])
        if not (np.array_equal(b["tokens"], want[:, :-1])
                and np.array_equal(b["labels"], want[:, 1:])):
            raise AssertionError(f"data: batch {step} differs from the "
                                 "store")
    # a streamed shipment of new documents, then a batch over them
    new_keys = absent_keys(rng, keys_sorted, 4_096).astype(np.int64)
    docs = [np.arange(8 + i % 40, dtype=np.uint32) for i in range(4_096)]
    t0 = time.perf_counter()
    rep = ds.ingest_batch(docs, new_keys)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ords = ds.ordinals(new_keys.astype(np.float64))
    if not all(np.array_equal(store.doc(int(o)), d)
               for o, d in zip(ords, docs)):
        raise AssertionError("data: a streamed document does not resolve")
    data_out = {"docs": DATA_DOCS, "tokens": int(store.tokens.size),
                "store_seconds": store_s, "build_seconds": build_s,
                "global_batch": DATA_BATCH, "seq_len": DATA_SEQ,
                "batch_ms": batch_ms,
                "streamed": {"docs": len(docs), "seconds": ingest_s,
                             "placement": rep.placement,
                             "device": rep.device},
                "batches_equal_store": True}
    emit("consumers_data", card=smi, **data_out)
    launches = {"fused_lookup": fused_lookup.launches,
                "ingest_place": ingest_place.launches}
    if not all(launches.values()):
        raise AssertionError(f"consumers: a kernel of the path never "
                             f"launched ({launches})")
    vs_plain = consumer_kernels_vs_plain(rng, kv, ds, keys_sorted)
    emit("consumers_kernels", card=smi, launches=launches,
         kernel_vs_plain=vs_plain, tolerance=TOL)
    return {"launches": launches, "kernel_vs_plain": vs_plain, "kv": kv_out,
            "data": data_out}


def consumer_kernels_vs_plain(rng, kv, ds, doc_keys) -> dict:
    """Both kernels against their plain versions at the shapes phase 12
    gave them (after its counts were read): on the block table, 2^16
    (request, page) keys, half mapped, and one alloc group's pages of
    requests never allocated; on the dataset's index, one loader batch
    of sample keys and one streamed shipment of absent keys."""
    from repro_torch.serving.kv_cache import table_key
    mapped = np.array(list(kv.allocated.keys()), np.float64)
    unmapped = np.array([table_key(int(r), int(p)) for r, p in zip(
        rng.integers(1, KV_REQUESTS + 64, 1 << 15),
        rng.integers(KV_PAGES_PER_REQUEST, 2 * KV_PAGES_PER_REQUEST,
                     1 << 15))], np.float64)
    q = np.concatenate([rng.choice(mapped, 1 << 15), unmapped])
    _a, _s, _g, kv_lookup_err = kernel_case("kv_lookup", kv.index, q)
    fresh = np.array([table_key(int(r), int(p))
                      for r in range(KV_REQUESTS + 1,
                                     KV_REQUESTS + 1 + KV_GROUP)
                      for p in range(1, KV_PAGES_PER_REQUEST, 2)],
                     np.float64)
    arrays = kv.index.sync_device().arrays
    _got, kv_place_err = place_vs_plain("kv_alloc", place_args(arrays, fresh),
                                        arrays.n_slots)
    eng = ds.index.sync_device()
    qd = rng.choice(doc_keys, eng.bucket(DATA_BATCH))
    _a, _s, _g, ds_lookup_err = kernel_case("data_batch", ds.index, qd)
    new = absent_keys(rng, doc_keys, 4_096)
    _got, ds_place_err = place_vs_plain("data_ingest",
                                        place_args(eng.arrays, new),
                                        eng.arrays.n_slots)
    return {"kv": {"fused_lookup_batch": int(q.size),
                   "fused_lookup_max_abs_err": kv_lookup_err,
                   "ingest_place_batch": int(fresh.size),
                   "ingest_place_max_abs_err": kv_place_err},
            "data": {"fused_lookup_batch": int(qd.size),
                     "fused_lookup_max_abs_err": ds_lookup_err,
                     "ingest_place_batch": int(new.size),
                     "ingest_place_max_abs_err": ds_place_err}}


# ---------------------------------------------------------------------------
# phase 13: LLM decode serving over the learned-index block table
# ---------------------------------------------------------------------------

CARD = "cuda"
DECODE_ARCH = "internlm2-1.8b"   # configs/internlm2_1_8b.py, full size
DECODE_REQUESTS = 64
DECODE_NEW = 64
DECODE_BATCH = 32
DECODE_LEN = 512
DECODE_PAGE = 16
DECODE_CHECK_B, DECODE_CHECK_S = 2, 64
DECODE_ATOL = 1e-3


def tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from tree_leaves(t)
    else:
        yield tree


def tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts, tuples and
    NamedTuples (param trees and caches)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = (tree_map(fn, v) for v in tree)
        return (type(tree)(*leaves) if hasattr(tree, "_fields")
                else tuple(leaves))
    return fn(tree)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


class DecodeProbe:
    """Wraps the engine's collaborators to split each round (model step
    by CUDA events, page lookup / alloc / sampling by the host clock),
    to check every round's page lookups against the block table's host
    map, and to record the allocs and frees for a host-only replay.
    The wrappers call the engine's own objects; they add no device
    work to the round."""

    def __init__(self, engine):
        self.engine = engine
        self.step_events = []
        self.lookup_s, self.alloc_s, self.sample_s = [], [], []
        self.round_lookup = self.round_alloc = self.round_sample = 0.0
        self.lookup_rounds = []   # (keys, payloads) of every round
        self.ops = []             # ("alloc", rids, pages) / ("free", r, n)
        self.last_bucket = None
        self.logits_finite = True
        self.max_token = -1
        self._pending = {}
        agg, kv = engine.aggregator, engine.kv_pages
        self._submit, self._flush = agg.submit_lookup, agg.flush
        self._result, self._alloc = agg.result, kv.alloc_batch
        self._free, self._lookup = kv.free_request, kv.index.lookup
        self._decode, self._sample = engine._decode, engine._sample
        agg.submit_lookup, agg.flush, agg.result = (
            self.submit, self.flush, self.result)
        kv.alloc_batch, kv.free_request = self.alloc, self.free
        kv.index.lookup = self.index_lookup
        engine._decode, engine._sample = self.decode, self.sample

    def _timed(self, attr, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            setattr(self, attr, getattr(self, attr)
                    + time.perf_counter() - t0)

    def submit(self, keys):
        t = self._timed("round_lookup", self._submit, keys)
        self._pending[t] = np.asarray(keys, np.float64).copy()
        return t

    def flush(self):
        return self._timed("round_lookup", self._flush)

    def result(self, ticket):
        res = self._timed("round_lookup", self._result, ticket)
        keys = self._pending.pop(ticket)
        self.lookup_rounds.append((keys, np.asarray(res.payloads).copy()))
        # the host map at this round, before the misses are allocated
        want = np.array([self.engine.kv_pages.allocated.get(int(k), -1)
                         for k in keys], np.int64)
        got = np.asarray(res.payloads).astype(np.int64)
        if not np.array_equal(got, want):
            raise AssertionError(
                f"round {self.engine.stats['rounds']}: page lookups differ "
                f"from the block table's host map "
                f"({int((got != want).sum())} of {keys.size})")
        return res

    def index_lookup(self, queries, *a, **kw):
        self.last_bucket = np.asarray(queries, np.float64).copy()
        return self._lookup(queries, *a, **kw)

    def alloc(self, rids, pages):
        self.ops.append(("alloc", np.array(rids), np.array(pages)))
        return self._timed("round_alloc", self._alloc, rids, pages)

    def free(self, rid, n):
        self.ops.append(("free", int(rid), int(n)))
        return self._free(rid, n)

    def decode(self, *a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._decode(*a)
        end.record()
        self.step_events.append((start, end))
        return out

    def sample(self, logits):
        nxt = self._timed("round_sample", self._sample, logits)
        self.logits_finite &= bool(np.isfinite(logits).all())
        self.max_token = max(self.max_token, int(nxt.max()))
        return nxt

    def end_round(self):
        self.lookup_s.append(self.round_lookup)
        self.alloc_s.append(self.round_alloc)
        self.sample_s.append(self.round_sample)
        self.round_lookup = self.round_alloc = self.round_sample = 0.0

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.step_events]


def decode_requests(rng, vocab, n, first_id=1):
    """``launch/serve.py``'s traffic: prompts of 4-23 tokens uniform
    below ``vocab``, ``DECODE_NEW`` new tokens each."""
    from repro_torch.serving import Request
    return [Request(request_id=rid,
                    prompt=rng.integers(0, vocab, rng.integers(4, 24),
                                        dtype=np.int32),
                    max_new_tokens=DECODE_NEW)
            for rid in range(first_id, first_id + n)]


def replay_block_table(ops, n_pages):
    """The same allocs and frees on a fresh block table whose index
    never freezes (no lookups): every write on the host path."""
    from repro_torch.serving.kv_cache import PagedKVCache
    kv = PagedKVCache.create(n_pages=n_pages, page_size=DECODE_PAGE,
                             expected_requests=DECODE_BATCH * 4,
                             device="cpu")
    for op in ops:
        if op[0] == "alloc":
            kv.alloc_batch(op[1], op[2])
        else:
            kv.free_request(op[1], op[2])
    if kv.index._engine is not None:
        raise AssertionError("the host replay froze its index")
    return kv


def conditioned(params):
    """The same draws with the attention projections rescaled to std
    1/sqrt(their contraction size), Mamba-2's per-head SSM vectors set
    by its own recipe and the mLSTM gate projections zeroed.

    * Attention: the LM's stacked ``layers.attn``, zamba's
      ``shared_attn.attn`` (contraction 2·d_model) and the enc-dec's
      ``enc_layers.attn``, ``dec_layers.attn`` and
      ``dec_layers.cross``.  The reference's init rule takes ``fan_in =
      shape[-2]``, which for ``wq``/``wk``/``wv`` (d, heads, head_dim)
      is the head count and for ``wo`` the head size: the scores come
      out ~sqrt(d / heads) times too large and the softmax saturates.
    * Mamba-2 (zamba's ``mamba_layers.ssm``): the rule draws ``A_log``,
      ``dt_bias`` and ``D`` as N(0, 1/heads) weights, so dt = softplus(
      ~N(0, 1)) is ~0.7, the state forgets in a step or two and the
      block's output is cubic in its input (``(c·b) dt x``); Mamba-2
      initialises A uniform in [1, 16], dt log-uniform in [1e-3, 1e-1]
      (``dt_bias`` its inverse softplus) and D = 1 (Dao & Gu 2024,
      arXiv:2405.21060), drawn here from a generator seeded 0.
    * mLSTM (xLSTM's ``blocks.b*.cell.w_if``): drawn, the exponential
      input gate and the forget gate swing by O(1) from token to token;
      the xLSTM reference implementation zero-initialises both gate
      projections (arXiv:2405.04517; its gate biases, which this model
      does not have, set the rest), so here i = 0 and f = sigmoid(0).

    As drawn, each of these makes the random-init model chaotic at full
    depth (a one-ulp change of the inputs grows layer by layer), so two
    evaluation orders of one f32 function part by far more than their
    roundings."""
    out = dict(params)
    for top, sub in (("layers", "attn"), ("shared_attn", "attn"),
                     ("enc_layers", "attn"), ("dec_layers", "attn"),
                     ("dec_layers", "cross")):
        if top not in params or sub not in params[top]:
            continue
        a = dict(params[top][sub])
        for k in ("wq", "wk", "wv"):   # (..., d, heads, head_dim)
            a[k] = a[k] * (a[k].shape[-2] / a[k].shape[-3]) ** 0.5
        wo = a["wo"]                   # (..., heads, head_dim, d)
        a["wo"] = wo * (wo.shape[-2] / (wo.shape[-3] * wo.shape[-2])) ** 0.5
        out[top] = {**out.get(top, params[top]), sub: a}
    if "mamba_layers" in params:
        s = dict(params["mamba_layers"]["ssm"])
        shape, dev = s["A_log"].shape, s["A_log"].device
        g = torch.Generator().manual_seed(0)
        a_init = 1.0 + 15.0 * torch.rand(shape, generator=g)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=g))
        s["A_log"] = torch.log(a_init).to(device=dev, dtype=s["A_log"].dtype)
        s["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(
            device=dev, dtype=s["dt_bias"].dtype)
        s["D"] = torch.ones_like(s["D"])
        out["mamba_layers"] = {**params["mamba_layers"], "ssm": s}
    if "blocks" in params:
        out["blocks"] = {
            k: ({**b, "cell": {**b["cell"],
                               "w_if": torch.zeros_like(b["cell"]["w_if"])}}
                if "w_if" in b["cell"] else b)
            for k, b in params["blocks"].items()}
    return out


def decode_numerics(model, params, smi) -> dict:
    """The model at full width and depth, ``DECODE_CHECK_B`` x
    ``DECODE_CHECK_S`` tokens: prefill's last logits against
    ``forward``'s and a ``decode_step`` after the prefill against
    ``forward`` over the S + 1 tokens.  In f32 (TF32 off) on the
    ``conditioned`` params within ``DECODE_ATOL`` with equal argmax;
    the same differences printed for the served params as drawn (f32
    and bf16) and for the conditioned ones in bf16; then the conditioned
    params cut to 2 layers, the card against the CPU in f32."""
    import dataclasses

    from repro_torch.models import lm
    cfg = model.cfg
    B, S = DECODE_CHECK_B, DECODE_CHECK_S
    g = torch.Generator(device="cpu").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(prm, cache_dtype, dev, cfg_=cfg):
        tok = tokens.to(dev)
        full = lm.logits_fn(prm, lm.forward(prm, tok, cfg_), cfg_).float()
        cache = lm.init_kv_cache(cfg_, B, 2 * S, dtype=cache_dtype,
                                 device=dev)
        pre, cache = lm.prefill(prm, tok[:, :S], cache, cfg_)
        dec, _ = lm.decode_step(prm, tok[:, S:], cache, S, cfg_)
        # the real vocabulary (the padded columns are -1e30 in both)
        v = cfg_.vocab
        return (full[:, S - 1, :v].cpu(), full[:, S, :v].cpu(),
                pre[:, :v].float().cpu(), dec[:, :v].float().cpu())

    def diffs(r):
        f_s1, f_s, pre, dec = r
        return {"prefill_vs_forward": float((pre - f_s1).abs().max()),
                "decode_vs_forward": float((dec - f_s).abs().max()),
                "argmax_equal": bool(torch.equal(pre.argmax(-1),
                                                 f_s1.argmax(-1))
                                     and torch.equal(dec.argmax(-1),
                                                     f_s.argmax(-1))),
                "logit_scale": float(f_s.abs().max())}

    try:
        p32 = tree_map(lambda t: t.float(), params)
        drawn = {"f32": diffs(run(p32, torch.float32, CARD)),
                 "bf16": diffs(run(params, torch.bfloat16, CARD))}
        c32 = conditioned(p32)
        del p32
        f32 = diffs(run(c32, torch.float32, CARD))
        bf16 = diffs(run(conditioned(params), torch.bfloat16, CARD))
        if not (f32["prefill_vs_forward"] <= DECODE_ATOL
                and f32["decode_vs_forward"] <= DECODE_ATOL
                and f32["argmax_equal"]):
            raise AssertionError(f"f32 decode numerics: {f32}")
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        p2 = {k: v for k, v in c32.items() if k != "layers"}
        p2["layers"] = tree_map(lambda t: t[:2].contiguous(), c32["layers"])
        del c32
        gpu2 = run(p2, torch.float32, CARD, cfg2)
        cpu2 = run(tree_map(lambda t: t.cpu(), p2), torch.float32, "cpu",
                   cfg2)
        del p2
        card_vs_cpu = max(float((a - b).abs().max())
                          for a, b in zip(gpu2, cpu2))
        if card_vs_cpu > DECODE_ATOL:
            raise AssertionError(f"2-layer f32 logits differ between the "
                                 f"card and the CPU by {card_vs_cpu}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
        torch.cuda.empty_cache()
    out = {"batch": B, "seq": S, "atol": DECODE_ATOL, "f32": f32,
           "bf16": bf16, "drawn_params": drawn,
           "two_layers_card_vs_cpu_f32": card_vs_cpu}
    emit("decode_numerics", card=smi, **out,
         params="the served draws, attention projections rescaled to "
                "std 1/sqrt(contraction size) (chip_smoke.conditioned); "
                "drawn_params: the draws as served, unchecked")
    return out


def step_written_bytes(cfg, caches) -> int:
    """Bytes of decode state a step must write: the LM's new key and
    value in every layer; zamba's whole SSM caches (conv window and
    state are rewritten) and the shared block's new key and value at
    every application; every xLSTM cache (the matrix memories, the
    normalisers and stabilisers are rewritten)."""
    if cfg.arch == "xlstm":
        return tree_bytes(caches)
    if cfg.arch == "zamba":
        kv = caches["k"]
        return (tree_bytes(caches["ssm"])
                + 2 * kv.shape[0] * kv.shape[1] * kv.shape[2]
                * kv.shape[4] * kv.element_size())
    kv = caches[0]["k"]
    return (2 * len(caches) * kv.shape[0] * kv.shape[1] * kv.shape[3]
            * kv.element_size())


def serve_decode(rng, seed, smi, arch, profile=False) -> tuple:
    """``ServingEngine`` over ``arch`` at full width and depth (bf16
    params from ``seed``) on the card, ``DECODE_REQUESTS`` x
    ``DECODE_NEW`` tokens through ``DECODE_BATCH`` slots; every round's
    page lookup held against the block table's host map, the block
    table at the end against a host-only replay, and ``fused_lookup``
    against its plain version at the block table's shapes after the
    counts were read.  Emits ``decode_setup`` and ``decode`` (and
    ``decode_profile`` with ``profile``); returns (result, model,
    params)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = ARCHS[arch]
    model = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=CARD).manual_seed(seed)
    params = model.init_params(gen, CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, max_batch=DECODE_BATCH,
                           max_len=DECODE_LEN, page_size=DECODE_PAGE,
                           temperature=0.0, device=CARD)
    engine.load(params)
    w_bytes, state_bytes = tree_bytes(params), tree_bytes(engine.caches)
    written = step_written_bytes(cfg, engine.caches)
    emit("decode_setup", card=smi, arch=cfg.name, family=cfg.arch,
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv, d_ff=cfg.d_ff, vocab=cfg.vocab,
         padded_vocab=int(params["embed"].shape[0]),
         params=model.param_count(), weight_bytes=w_bytes,
         decode_state_bytes=state_bytes, step_written_bytes=written,
         init_seconds=init_s, max_batch=DECODE_BATCH, max_len=DECODE_LEN,
         page_size=DECODE_PAGE, block_table_pages=engine.kv_pages.n_pages)
    reqs = decode_requests(rng, cfg.vocab, DECODE_REQUESTS)
    for r in reqs:
        engine.submit(r)
    probe = DecodeProbe(engine)
    round_ms = []
    step = engine.step

    def timed_step():
        t1 = time.perf_counter()
        step()
        round_ms.append((time.perf_counter() - t1) * 1e3)
        probe.end_round()

    engine.step = timed_step
    fused_lookup.launches = 0   # counts from the decode's run only
    ingest_place.launches = 0
    stats = engine.run_until_done()
    launches = {"fused_lookup": fused_lookup.launches,
                "ingest_place": ingest_place.launches}
    engine.step = step
    step_ms = probe.step_ms()

    # checks
    n_tok = DECODE_REQUESTS * DECODE_NEW
    if stats["decoded_tokens"] != n_tok or not all(r.done for r in reqs):
        raise AssertionError(f"{arch}: decoded {stats['decoded_tokens']} "
                             f"of {n_tok} tokens")
    if not probe.logits_finite or not 0 <= probe.max_token < cfg.vocab:
        raise AssertionError(f"{arch}: non-finite logits or a token past "
                             "vocab")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.generated):
        raise AssertionError(f"{arch}: a generated token is past vocab")
    if launches["fused_lookup"] != stats["rounds"]:
        raise AssertionError(f"{arch}: {launches['fused_lookup']} "
                             f"fused_lookup launches for {stats['rounds']} "
                             "rounds")
    replay = replay_block_table(probe.ops, engine.kv_pages.n_pages)
    kv = engine.kv_pages
    if (replay.allocated != kv.allocated
            or replay.free_pages != kv.free_pages):
        raise AssertionError(f"{arch}: the block table differs from its "
                             "replay")
    assert_same_state(kv.index.gapped, replay.index.gapped, "decode")
    if replay.index.epoch != kv.index.epoch:
        raise AssertionError(f"{arch}: block-table epoch {kv.index.epoch} "
                             f"against {replay.index.epoch} replayed")

    # the kernel at the block table's shapes, after the counts were read
    _a, _s, _g, lookup_err = kernel_case(f"decode_block_table_{arch}",
                                         kv.index, probe.last_bucket)
    rounds = stats["rounds"]
    wall = stats["wall_s"]
    bound_bytes = w_bytes + state_bytes + written
    out = {
        "arch": cfg.name,
        "requests": DECODE_REQUESTS, "new_tokens": DECODE_NEW,
        "decoded_tokens": stats["decoded_tokens"], "rounds": rounds,
        "wall_seconds": wall, "tokens_per_second": n_tok / wall,
        "round_ms_p50": pct(round_ms, 50), "round_ms_p99": pct(round_ms, 99),
        "model_step_ms_p50": pct(step_ms, 50),
        "model_step_ms_p99": pct(step_ms, 99),
        "page_lookup_ms_p50": pct(probe.lookup_s, 50) * 1e3,
        "page_lookup_ms_p99": pct(probe.lookup_s, 99) * 1e3,
        "alloc_ms_p50": pct(probe.alloc_s, 50) * 1e3,
        "alloc_ms_p99": pct(probe.alloc_s, 99) * 1e3,
        "sampling_ms_p50": pct(probe.sample_s, 50) * 1e3,
        "sampling_ms_p99": pct(probe.sample_s, 99) * 1e3,
        "step_byte_bound_ms": bound_bytes / H100_BYTES_PER_S * 1e3,
        "step_bound_bytes": bound_bytes,
        "launches": launches,
        "page_lookups": stats["page_lookups"],
        "lookup_bucket": int(probe.last_bucket.size),
        "kv_epoch": stats["kv_epoch"],
        "kv_delta_updates": stats["kv_delta_updates"],
        "kv_refreezes": stats["kv_refreezes"],
        "page_lookups_equal_host_map": True,
        "block_table_equals_host_replay": True,
        "fused_lookup_max_abs_err": lookup_err,
    }
    emit("decode", card=smi, **out, kernel_vs_plain=TOL,
         bound="weights + the whole decode state read once + the state a "
               "step writes, at 3.35 TB/s")
    if profile:
        for r in decode_requests(rng, cfg.vocab, DECODE_BATCH,
                                 first_id=DECODE_REQUESTS + 1):
            engine.submit(r)
        engine.step()   # admission and the first round
        n0 = fused_lookup.launches

        def eight_rounds():
            for _ in range(8):
                engine.step()
        traced(eight_rounds, smi, "decode_profile", arch=cfg.name, rounds=8)
        emit("decode_profile_launches", card=smi, arch=cfg.name,
             fused_lookup_per_round=(fused_lookup.launches - n0) / 8)
    del engine, probe
    return out, model, params


def phase_decode(rng, seed, smi, profile=False) -> dict:
    """Phase 13: ``serve_decode`` over internlm2-1.8b, then the model's
    numerics (``decode_numerics``)."""
    out, model, params = serve_decode(rng, seed, smi, DECODE_ARCH, profile)
    out["numerics"] = decode_numerics(model, params, smi)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: recurrent decode serving (Mamba-2 + shared attention, xLSTM)
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("zamba2-1.2b", "xlstm-125m")   # configs/, full size


def first_group(cfg, params):
    """The config and params cut to the first layers that run every
    block kind: zamba's first ``attn_every`` Mamba layers (one
    shared-block application, ``attn_every`` as configured), xLSTM's
    first ``SLSTM_EVERY`` blocks (its sLSTM is block 7)."""
    import dataclasses

    from repro_torch.models import xlstm_lm
    if cfg.arch == "zamba":
        n = min(cfg.attn_every, cfg.n_layers)
        cut = {**params, "mamba_layers": tree_map(
            lambda t: t[:n].contiguous(), params["mamba_layers"])}
    else:
        n = min(xlstm_lm.SLSTM_EVERY, cfg.n_layers)
        cut = {**params, "blocks": {f"b{i}": params["blocks"][f"b{i}"]
                                    for i in range(n)}}
    return dataclasses.replace(cfg, n_layers=n), cut


def recurrent_numerics(model, params, smi) -> dict:
    """The recurrent model at full width and depth, ``DECODE_CHECK_B`` x
    ``DECODE_CHECK_S`` tokens: the chunked ``forward`` over the S tokens
    against S ``decode_step``s (the sequential recurrence) from zero
    caches, at every position.  In f32 (TF32 off, f32 caches) on the
    ``conditioned`` params within ``DECODE_ATOL`` with equal argmax at
    every position; the same differences printed for the conditioned
    params in bf16 (the served cache dtypes) and for the drawn params in
    f32; then ``first_group`` of the conditioned params, the card
    against the CPU in f32."""
    from repro_torch.models import build_model, lm, xlstm_lm, zamba
    cfg = model.cfg
    fwd = zamba.forward if cfg.arch == "zamba" else xlstm_lm.forward
    B, S = DECODE_CHECK_B, DECODE_CHECK_S
    g = torch.Generator(device="cpu").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(prm, cache_dtype, dev, cfg_=cfg):
        m = model if cfg_ is cfg else build_model(cfg_)
        tok = tokens.to(dev)
        v = cfg_.vocab   # the real vocabulary (padded columns are -1e30)
        hidden, _ = fwd(prm, tok, cfg_)
        full = lm.logits_fn(prm, hidden, cfg_)[..., :v].float().cpu()
        caches = m.init_caches(B, S, device=dev)   # the served dtypes
        if cache_dtype is not None:
            caches = tree_map(lambda c: c.to(cache_dtype), caches)
        dec = []
        for t in range(S):
            lg, caches = m.decode_fn(prm, {"tokens": tok[:, t:t + 1]},
                                     caches, t)
            dec.append(lg[:, :v].float().cpu())
        return full, torch.stack(dec, dim=1)

    def diffs(r):
        full, dec = r
        return {"sequential_vs_chunked": float((dec - full).abs().max()),
                "argmax_equal": bool(torch.equal(dec.argmax(-1),
                                                 full.argmax(-1))),
                "argmax_equal_share": float(
                    (dec.argmax(-1) == full.argmax(-1)).float().mean()),
                "logit_scale": float(full.abs().max())}

    try:
        p32 = tree_map(lambda t: t.float(), params)
        drawn = {"f32": diffs(run(p32, torch.float32, CARD))}
        c32 = conditioned(p32)
        del p32
        f32 = diffs(run(c32, torch.float32, CARD))
        bf16 = diffs(run(conditioned(params), None, CARD))
        if not (f32["sequential_vs_chunked"] <= DECODE_ATOL
                and f32["argmax_equal"]):
            raise AssertionError(f"{cfg.name}: f32 chunked vs sequential "
                                 f"numerics: {f32}")
        cfg2, p2 = first_group(cfg, c32)
        del c32
        gpu2 = run(p2, torch.float32, CARD, cfg2)
        cpu2 = run(tree_map(lambda t: t.cpu(), p2), torch.float32, "cpu",
                   cfg2)
        del p2
        card_vs_cpu = max(float((a - b).abs().max())
                          for a, b in zip(gpu2, cpu2))
        if card_vs_cpu > DECODE_ATOL:
            raise AssertionError(f"{cfg.name}: {cfg2.n_layers}-layer f32 "
                                 f"logits differ between the card and the "
                                 f"CPU by {card_vs_cpu}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
        torch.cuda.empty_cache()
    out = {"arch": cfg.name, "batch": B, "seq": S, "atol": DECODE_ATOL,
           "f32": f32, "bf16": bf16, "drawn_params": drawn,
           "first_group_layers": cfg2.n_layers,
           "first_group_card_vs_cpu_f32": card_vs_cpu}
    emit("decode_numerics", card=smi, **out,
         params="the served draws conditioned (chip_smoke.conditioned: "
                "zamba's shared-block attention rescaled to std "
                "1/sqrt(contraction size), Mamba-2's A_log / dt_bias / D "
                "by its recipe; xLSTM's mLSTM gate projections zeroed); "
                "drawn_params: the draws as served, unchecked")
    return out


def phase_recurrent(rng, seed, smi, profile=False) -> dict:
    """Phase 14: ``serve_decode`` over each of ``RECURRENT_ARCHS``, then
    its chunked-vs-sequential numerics (``recurrent_numerics``).
    Returns the per-config results and their summed launches."""
    per = {}
    for arch in RECURRENT_ARCHS:
        out, model, params = serve_decode(rng, seed, smi, arch, profile)
        out["numerics"] = recurrent_numerics(model, params, smi)
        del params
        torch.cuda.empty_cache()
        per[arch] = out
    return {"per_arch": per,
            "launches": {k: sum(o["launches"][k] for o in per.values())
                         for k in ("fused_lookup", "ingest_place")},
            "fused_lookup_max_abs_err": max(
                o["fused_lookup_max_abs_err"] for o in per.values())}


# ---------------------------------------------------------------------------
# phase 15: training internlm2-1.8b at full size, with a crash and a resume
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internlm2-1.8b"    # configs/internlm2_1_8b.py, full size
TRAIN_DOCS = 2_048               # launch/train.py's --n-docs
TRAIN_BATCH, TRAIN_SEQ = 8, 512  # launch/train.py's batch, phase 13's max_len
TRAIN_STEPS, TRAIN_WARMUP = 12, 2
TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 6, 9
TRAIN_HELDOUT_STEP = 100         # a loader step the 12 steps never reach
TRAIN_RTOL = 1e-3
TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 64
H100_BF16_FLOPS = 989e12         # H100 SXM data sheet, dense bf16


class TrainProbe:
    """Wraps a trainer's model loss, ``loss_and_grads`` and
    ``train_step`` to time each step with CUDA events (the forward, the
    backward with its recomputation, the rest of the step: the
    optimizer, run a leaf at a time), and its checkpoint manager's calls
    with the host clock.  The wrappers call the trainer's own functions
    and add no device work to a step."""

    def __init__(self, trainer):
        import dataclasses
        # per step: (start, after forward, after backward, after opt)
        self.steps = []
        self.ckpt_s = {"save_async": [], "wait": [], "save": [],
                       "restore": []}
        lg, step = trainer.loss_and_grads, trainer.train_step
        loss_fn = trainer.model.loss_fn
        ck = trainer.ckpt

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def forward(*a, **kw):
            out = loss_fn(*a, **kw)
            self._open.append(event())
            return out

        def loss_and_grads(params, batch):
            self._open = [event()]
            out = lg(params, batch)
            self._open.append(event())
            return out

        def train_step(*a, **kw):
            out = step(*a, **kw)
            self.steps.append((*self._open, event()))
            return out

        trainer.model = dataclasses.replace(trainer.model, loss_fn=forward)

        def timed(name, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.ckpt_s[name].append(time.perf_counter() - t0)
            return run

        trainer.loss_and_grads, trainer.train_step = loss_and_grads, \
            train_step
        for name in self.ckpt_s:
            setattr(ck, name, timed(name, getattr(ck, name)))

    def times(self):
        """``[(step ms, forward ms, backward ms, optimizer ms)]``."""
        torch.cuda.synchronize()
        return [(a.elapsed_time(d), a.elapsed_time(b), b.elapsed_time(c),
                 c.elapsed_time(d)) for a, b, c, d in self.steps]


def train_model_flops(cfg, model, tokens: int, seq: int) -> float:
    """6·N·T + 12·L·d_attn·S·T (PaLM, Chowdhery et al. 2022, App. B):
    N the params less the input embedding (the head counts), T the
    tokens of a step, S the sequence length."""
    n = model.param_count()
    if not cfg.tie_embeddings:
        n -= model.param_specs()["embed"].shape[0] * cfg.d_model
    d_attn = cfg.n_heads * (cfg.head_dim or cfg.d_model // cfg.n_heads)
    return 6.0 * n * tokens + 12.0 * cfg.n_layers * d_attn * seq * tokens


def state_bytes(model) -> int:
    """Bytes of a trainer state: the params in their dtypes and AdamW's
    two f32 moments (the residual is 0-d without compression)."""
    total = 0
    for _, p in model._leaves():
        n = int(np.prod(p.shape))
        total += n * (torch.empty((), dtype=p.dtype).element_size() + 8)
    return total


def cut_config(arch: str):
    """The card-vs-CPU cuts: the first layers of ``arch`` at full width
    (2 LM layers; zamba's first ``attn_every`` Mamba-2 layers and its
    shared block; xLSTM's first 8 blocks, the 8th its sLSTM)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import xlstm_lm
    cfg = ARCHS[arch]
    n = {"zamba": cfg.attn_every,
         "xlstm": xlstm_lm.SLSTM_EVERY}.get(cfg.arch, 2)
    return dataclasses.replace(cfg, n_layers=n)


def grads_on(model, params, batch, dev):
    """``(loss, {leaf name: grad})`` on ``dev`` in the params' dtype."""
    from repro_torch.tree import leaf_paths
    prm = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                   params)
    paths = leaf_paths(prm)
    loss = model.loss_fn(prm, {k: v.to(dev) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in paths])
    return float(loss.detach()), {
        "__".join(map(str, p)): g.detach().cpu() for (p, _), g in
        zip(paths, grads)}


def rel_max(got, want) -> float:
    """max |got - want| over max |want| (relative in max-norm)."""
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def train_numerics(smi, seed) -> dict:
    """Loss and every grad on the card against the CPU in f32 (TF32
    off, ``conditioned`` params, a ``TRAIN_CHECK_B`` x ``TRAIN_CHECK_S``
    batch) for four cuts at full width: internlm2-1.8b's first 2 layers,
    granite-moe-1b-a400m's (MoE), zamba2-1.2b's first group, xlstm-125m's
    first 8 blocks; within ``TRAIN_RTOL`` relative in max-norm.  Then
    the remat policies on the card: ``"full"`` and ``"dots"`` against
    ``"none"`` for the internlm2 and zamba cuts (the families with
    remat), within the same bound, their bit equality printed."""
    import dataclasses

    from repro_torch.models import build_model
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per, remat = {}, {}
    try:
        for arch in (TRAIN_ARCH, "granite-moe-1b-a400m", "zamba2-1.2b",
                     "xlstm-125m"):
            cfg = cut_config(arch)
            model = build_model(cfg)
            g = torch.Generator(device="cpu").manual_seed(seed + 23)
            params = conditioned(tree_map(
                lambda t: t.float(), model.init_params(g, "cpu")))
            shape = (TRAIN_CHECK_B, TRAIN_CHECK_S)
            batch = {"tokens": torch.randint(0, cfg.vocab, shape,
                                             generator=g),
                     "labels": torch.randint(0, cfg.vocab, shape,
                                             generator=g),
                     "mask": torch.ones(shape)}
            t0 = time.perf_counter()
            card = grads_on(model, params, batch, CARD)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = grads_on(model, params, batch, "cpu")
            cpu_s = time.perf_counter() - t0
            errs = {k: rel_max(card[1][k], cpu[1][k]) for k in cpu[1]}
            worst = max(errs, key=errs.get)
            row = {"layers": cfg.n_layers, "remat": cfg.remat,
                   "loss_card": card[0], "loss_cpu": cpu[0],
                   "loss_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
                   "grad_max_rel_err": errs[worst], "worst_leaf": worst,
                   "finite": all(bool(torch.isfinite(t).all())
                                 for t in card[1].values()),
                   "card_s": card_s, "cpu_s": cpu_s}
            per[arch] = row
            if not (row["finite"] and row["loss_rel_err"] <= TRAIN_RTOL
                    and row["grad_max_rel_err"] <= TRAIN_RTOL):
                raise AssertionError(f"{arch}: card vs CPU f32 grads: {row}")
            if cfg.arch in ("lm", "zamba") and cfg.moe is None:
                base = None
                for policy in ("none", "full", "dots"):
                    m = build_model(dataclasses.replace(cfg, remat=policy))
                    out = grads_on(m, params, batch, CARD)
                    if base is None:
                        base = out
                        continue
                    err = max(rel_max(out[1][k], base[1][k])
                              for k in base[1])
                    bits = (out[0] == base[0] and all(
                        torch.equal(out[1][k], base[1][k]) for k in base[1]))
                    remat[f"{arch}:{policy}"] = {
                        "grad_max_rel_err_vs_none": err,
                        "bit_identical": bits}
                    if err > TRAIN_RTOL or abs(out[0] - base[0]) > \
                            TRAIN_RTOL * abs(base[0]):
                        raise AssertionError(
                            f"{arch}: remat {policy} differs from none by "
                            f"{err}")
            del params, card, cpu
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
        torch.cuda.empty_cache()
    out = {"batch": TRAIN_CHECK_B, "seq": TRAIN_CHECK_S,
           "rtol": TRAIN_RTOL, "card_vs_cpu_f32": per, "remat_on_card": remat}
    emit("train_numerics", card=smi, **out,
         params="draws in f32, conditioned (chip_smoke.conditioned)")
    return out


def phase_train(rng, seed, smi, tmp, profile=False) -> dict:
    """Phase 15: ``Trainer`` over internlm2-1.8b at full width and depth
    (bf16 params, AdamW, ``remat="full"``) on ``launch/train.py``'s data
    path, ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens with a checkpoint every ``TRAIN_CKPT_EVERY``: run 1 crashes at
    step ``TRAIN_CRASH_AT``; run 2, a fresh trainer and loader on the
    same directory, resumes at 6 and ends at 12.  Checks: every loss
    finite, run 2's replayed steps equal run 1's, the final checkpoint
    restores bit for bit, the held-out loss before and after; then
    ``train_numerics``.  Emits ``train_setup``, ``train`` (and
    ``train_profile`` with ``profile``)."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import (IndexedTokenDataset, PackedTokenStore,
                                  ShardedLoader)
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    from repro_torch.models import build_model
    from repro_torch.train import (CheckpointManager, FailureInjector,
                                   TrainConfig, Trainer)
    from repro_torch.tree import leaf_paths
    cfg = ARCHS[TRAIN_ARCH]
    if (cfg.remat, cfg.optimizer) != ("full", "adamw"):
        raise AssertionError(f"{cfg.name}: remat {cfg.remat}, optimizer "
                             f"{cfg.optimizer}")
    model = build_model(cfg)
    baseline = torch.cuda.memory_allocated()
    ckpt_dir = Path(tmp) / "train_ckpt"
    need = 2 * state_bytes(model)
    free = shutil.disk_usage(tmp).free
    if free < need * 1.05:
        raise AssertionError(f"{tmp}: {free / 1e9:.1f} GB free, two "
                             f"checkpoints need {need / 1e9:.1f} GB")
    t0 = time.perf_counter()
    store = PackedTokenStore.synthetic(TRAIN_DOCS, mean_len=TRAIN_SEQ + 1,
                                       vocab=cfg.vocab, seed=seed)

    def loader():
        ds = IndexedTokenDataset.build(store, method="pgm", sample_rate=0.1,
                                       gap_rho=0.15, device=CARD)
        return ShardedLoader(ds, global_batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, seed=seed)

    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
                       schedule="cosine", ckpt_every=TRAIN_CKPT_EVERY,
                       ckpt_dir=str(ckpt_dir), keep_ckpts=1, log_every=1)
    held = loader()
    held.seek(TRAIN_HELDOUT_STEP)
    trainer1 = Trainer(model, tcfg, loader(),
                       failure_injector=FailureInjector(
                           {TRAIN_CRASH_AT: "crash"}), device=CARD)
    heldout = trainer1.device_batch(held.next_batch())
    with torch.no_grad():
        p0 = model.init_params(
            torch.Generator(device=CARD).manual_seed(seed), CARD)
        loss_before = float(model.loss_fn(p0, heldout))
        del p0
    setup_s = time.perf_counter() - t0
    emit("train_setup", card=smi, arch=cfg.name,
         params=model.param_count(), remat=cfg.remat,
         optimizer=cfg.optimizer, tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
         state_bytes=state_bytes(model), tmp_free_bytes=free,
         setup_seconds=setup_s)

    fused_lookup.launches = 0
    ingest_place.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe1 = TrainProbe(trainer1)
    t0 = time.perf_counter()
    try:
        trainer1.run(seed=seed)
        raise AssertionError(f"run 1 did not crash at {TRAIN_CRASH_AT}")
    except RuntimeError as e:
        if f"injected crash at step {TRAIN_CRASH_AT}" not in str(e):
            raise
    # the crash is injected into a live process: its async save of
    # step 6 completes before the restart reads the directory
    trainer1.ckpt.wait()
    trainer1.watchdog.close()
    run1_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated()
    run1 = trainer1.metrics
    if [m["step"] for m in run1] != list(range(1, TRAIN_CRASH_AT + 1)):
        raise AssertionError(f"run 1 logged {[m['step'] for m in run1]}")
    latest = CheckpointManager(str(ckpt_dir)).latest_step()
    if latest != TRAIN_CKPT_EVERY:
        raise AssertionError(f"latest checkpoint {latest}, not "
                             f"{TRAIN_CKPT_EVERY}")
    del trainer1
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    loader2 = loader()
    trainer2 = Trainer(model, tcfg, loader2, device=CARD)
    probe2 = TrainProbe(trainer2)
    t0 = time.perf_counter()
    out = trainer2.run(seed=seed)
    run2_s = time.perf_counter() - t0
    resume_peak = torch.cuda.max_memory_allocated()
    launches = {"fused_lookup": fused_lookup.launches,
                "ingest_place": ingest_place.launches}
    run2 = out["metrics"]
    if [m["step"] for m in run2] != list(range(TRAIN_CKPT_EVERY + 1,
                                               TRAIN_STEPS + 1)):
        raise AssertionError(f"run 2 logged {[m['step'] for m in run2]}")
    if loader2.step != TRAIN_STEPS:
        raise AssertionError(f"loader at {loader2.step}, not {TRAIN_STEPS}")
    losses = [m["loss"] for m in run1 + run2]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    replay = {m["step"]: m for m in run2 if m["step"] <= TRAIN_CRASH_AT}
    diffs = {s: abs(replay[s]["loss"] - run1[s - 1]["loss"])
             / abs(run1[s - 1]["loss"]) for s in replay}
    replay_err = max(diffs.values())
    if replay_err > TRAIN_RTOL:
        raise AssertionError(f"replayed steps differ: {diffs}")
    state = out["state"]
    replay_op = None
    if replay_err != 0.0:
        # name where the nondeterminism is: two loss_and_grads on one
        # state and batch, the loss and the grad leaves that differ
        la, ga = trainer2.loss_and_grads(state["params"], heldout)
        lb, gb = trainer2.loss_and_grads(state["params"], heldout)
        replay_op = {
            "forward_equal": bool(torch.equal(la, lb)),
            "grad_leaves_differing": [
                "__".join(map(str, p)) for (p, a), (_, b) in zip(
                    leaf_paths(ga), leaf_paths(gb))
                if not torch.equal(a, b)][:8]}
        del ga, gb

    t0 = time.perf_counter()
    restored, extra = CheckpointManager(str(ckpt_dir)).restore(
        template=state)
    verify_restore_s = time.perf_counter() - t0
    bit_equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaf_paths(restored), leaf_paths(state)))
    if not bit_equal or extra != {"step": TRAIN_STEPS,
                                  "loader_step": TRAIN_STEPS}:
        raise AssertionError(f"final checkpoint restores other state "
                             f"(extra {extra})")
    del restored
    torch.cuda.empty_cache()
    with torch.no_grad():
        loss_after = float(model.loss_fn(state["params"], heldout))

    steady = probe1.times()[1:] + probe2.times()[1:]
    step_ms = [t[0] for t in steady]
    opt_ms = [t[3] for t in steady]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_model_flops(cfg, model, tokens, TRAIN_SEQ)
    p50 = pct(step_ms, 50)
    ck = {k: probe1.ckpt_s[k] + probe2.ckpt_s[k] for k in probe1.ckpt_s}
    result = {
        "arch": cfg.name, "steps": TRAIN_STEPS, "crash_at": TRAIN_CRASH_AT,
        "resumed_at": TRAIN_CKPT_EVERY, "tokens_per_step": tokens,
        "losses_run1": [m["loss"] for m in run1],
        "losses_run2": [m["loss"] for m in run2],
        "gnorms": [m["gnorm"] for m in run1 + run2],
        "replayed_steps_max_rel_diff": replay_err,
        "replay_nondeterminism": replay_op,
        "heldout_loss_before": loss_before, "heldout_loss_after": loss_after,
        "final_checkpoint_restores_bit_for_bit": bit_equal,
        "step_ms_p50": p50, "step_ms_p99": pct(step_ms, 99),
        "forward_ms_p50": pct([t[1] for t in steady], 50),
        "backward_ms_p50": pct([t[2] for t in steady], 50),
        "optimizer_ms_p50": pct(opt_ms, 50),
        "optimizer_share": sum(opt_ms) / sum(step_ms),
        "first_step_ms": [probe1.times()[0][0], probe2.times()[0][0]],
        "steps_timed": len(steady),
        "tokens_per_second": tokens / (p50 / 1e3),
        "model_flops_per_step": flops,
        "mfu": flops / (p50 / 1e3) / H100_BF16_FLOPS,
        "peak_memory_bytes": train_peak, "baseline_memory_bytes": baseline,
        "resume_peak_memory_bytes": resume_peak,
        "checkpoint_bytes": state_bytes(model),
        "save_async_host_copy_s": ck["save_async"],
        "async_wait_s": ck["wait"], "save_s": ck["save"],
        "restore_s": ck["restore"] + [verify_restore_s],
        "run1_wall_s": run1_s, "run2_wall_s": run2_s,
        "launches": launches,
    }
    emit("train", card=smi, **result,
         mfu_basis="6·N·T + 12·L·d_attn·S·T over 989 TFLOP/s (H100 SXM "
                   "dense bf16); N = params less the input embedding",
         step_timing="CUDA events around the forward, the backward "
                     "(with the remat recomputation) and the optimizer, "
                     "each run's first step left out",
         memory="peak_memory_bytes: run 1 (init and 9 steps); "
                "resume_peak_memory_bytes: run 2 (the restore holds "
                "init_state's template beside the restored state); both "
                "include baseline_memory_bytes, what earlier phases "
                "still held when the phase began",
         checkpoints="save_s: every write (run 1's step-6 async write, "
                     "run 2's step-12 async write, then its final "
                     "synchronous save of step 12, as the reference "
                     "trainer writes them); save_async_host_copy_s: the "
                     "copy to the host before each async write; "
                     "async_wait_s: every wait (backpressure, after the "
                     "crash, before the final save); restore_s: run 2's "
                     "resume, then the final checkpoint's check")
    if profile:
        def two_steps():
            for _ in range(2):
                trainer2.train_step(
                    state, trainer2.device_batch(loader2.next_batch()))
        trace = traced(two_steps, smi, "train_profile", arch=cfg.name,
                       steps=2)
        result["profile"] = {
            "launches_per_step": trace["device_ops"] / 2,
            "device_idle_share": trace["device_idle_share"]}
        emit("train_profile_launches", card=smi, arch=cfg.name,
             **result["profile"])
    del state, out, trainer2, probe1, probe2
    torch.cuda.empty_cache()
    result["numerics"] = train_numerics(smi, seed)
    return result


# ---------------------------------------------------------------------------
# phase 16: partitioning over a one-rank mesh
# ---------------------------------------------------------------------------

PART_STEPS = 2
PART_MOE_ARCH = "granite-moe-1b-a400m"   # configs/, full width
PART_EP_ATOL = 2e-4                      # the reference's (test_moe_ep.py)


def same_tree(a, b) -> bool:
    """Leaf for leaf bit-identical (DTensors compared whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import leaf_paths

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    pa, pb = leaf_paths(a), leaf_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        torch.equal(whole(x).detach(), whole(y).detach())
        for (_, x), (_, y) in zip(pa, pb))


def partition_train(seed, tmp, mesh, store) -> dict:
    """``TRAIN_ARCH`` at full width and 2 layers (bf16, AdamW,
    ``remat="full"``): ``PART_STEPS`` ``Trainer`` steps on
    ``launch/train.py``'s data path, once without a constrainer and
    once with ``activation_constrainer(mesh)`` (the state sharded over
    the mesh, the step the tensor-parallel design: the model on the
    rank's shards, every collective over a group of one); losses,
    gnorms and every state leaf bit for bit.  Then the sharded state's
    checkpoint, restored through ``elastic_restore`` onto a (1, 1) mesh,
    bit for bit."""
    from repro_torch.data import IndexedTokenDataset, ShardedLoader
    from repro_torch.dist import activation_constrainer
    from repro_torch.dist.partitioning import batch_shard
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.elastic import elastic_restore
    cfg = cut_config(TRAIN_ARCH)
    model = build_model(cfg)
    shard_id, n_shards = batch_shard(mesh)
    runs = {}
    for label, hook in (("plain", None),
                        ("mesh", activation_constrainer(mesh,
                                                        fsdp=cfg.fsdp))):
        ds = IndexedTokenDataset.build(store, method="pgm", sample_rate=0.1,
                                       gap_rho=0.15, device=CARD)
        loader = ShardedLoader(ds, global_batch=TRAIN_BATCH,
                               seq_len=TRAIN_SEQ, seed=seed,
                               shard_id=shard_id, n_shards=n_shards)
        tr = Trainer(model, TrainConfig(
            total_steps=PART_STEPS, warmup_steps=1,
            ckpt_dir=str(Path(tmp) / f"part_{label}")), loader,
            constrain=hook, device=CARD)
        state = tr.init_state(seed)
        metrics, step_s = [], []
        for _ in range(PART_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(tr.train_step(
                state, tr.device_batch(loader.next_batch())))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        runs[label] = {"trainer": tr, "state": state, "step_s": step_s,
                       "losses": [float(m["loss"]) for m in metrics],
                       "gnorms": [float(m["gnorm"]) for m in metrics]}
    plain, sharded = runs["plain"], runs["mesh"]
    design = sharded["trainer"].design
    if design != "tensor-parallel":
        raise AssertionError(f"the mesh trainer ran {design}")
    bits = (plain["losses"] == sharded["losses"]
            and plain["gnorms"] == sharded["gnorms"]
            and same_tree(plain["state"], sharded["state"]))
    if not bits or not all(math.isfinite(x) for x in plain["losses"]):
        raise AssertionError(
            f"the mesh trainer differs: losses {plain['losses']} / "
            f"{sharded['losses']}, gnorms {plain['gnorms']} / "
            f"{sharded['gnorms']}")
    tr = sharded["trainer"]
    t0 = time.perf_counter()
    tr.ckpt.save(PART_STEPS, sharded["state"], extra={"step": PART_STEPS})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, rmesh, extra = elastic_restore(
        model, tr.cfg.ckpt_dir, template=plain["state"], device=CARD)
    restore_s = time.perf_counter() - t0
    restored_bits = (tuple(rmesh.shape) == (1, 1)
                     and extra == {"step": PART_STEPS}
                     and same_tree(restored, sharded["state"]))
    if not restored_bits:
        raise AssertionError("elastic_restore onto (1, 1) differs from the "
                             "saved state")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "steps": PART_STEPS,
           "design": design, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
           "losses": sharded["losses"], "gnorms": sharded["gnorms"],
           "bit_identical_with_and_without_mesh": bits,
           "plain_step_s": plain["step_s"],
           "mesh_step_s": sharded["step_s"],
           "elastic_restore_bit_for_bit": restored_bits,
           "checkpoint_bytes": dir_bytes(Path(tr.cfg.ckpt_dir)),
           "checkpoint_save_s": save_s, "elastic_restore_s": restore_s}
    del runs, plain, sharded, tr, restored
    torch.cuda.empty_cache()
    return out


def partition_moe(seed, mesh) -> dict:
    """``PART_MOE_ARCH`` at full width and 2 layers in f32 (TF32 off,
    ``conditioned`` params, 2 x 64 tokens): the forward's hidden states
    with ``moe_impl="ep"`` over the mesh (``moe_ep_shardmap``) against
    ``moe_gspmd`` within the reference's 2e-4, and the loss and grads
    through the trainer's ``loss_and_grads`` within ``TRAIN_RTOL``."""
    import dataclasses

    from repro_torch.dist import activation_constrainer
    from repro_torch.models import build_model, lm
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths
    cfg = cut_config(PART_MOE_ARCH)
    ep_cfg = dataclasses.replace(cfg, moe_impl="ep")
    constrain = activation_constrainer(mesh, fsdp=cfg.fsdp)
    g = torch.Generator(device="cpu").manual_seed(seed + 29)
    gs_model, ep_model = build_model(cfg), build_model(ep_cfg)
    params = conditioned(tree_map(
        lambda t: t.float().to(CARD), gs_model.init_params(g, "cpu")))
    shape = (TRAIN_CHECK_B, TRAIN_CHECK_S)
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=g),
             "labels": torch.randint(0, cfg.vocab, shape, generator=g),
             "mask": torch.ones(shape)}
    batch = {k: v.to(CARD) for k, v in batch.items()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            h_gs = lm.forward(params, batch["tokens"], cfg)
            h_ep = lm.forward(params, batch["tokens"], ep_cfg, constrain)
        err = float((h_ep - h_gs).abs().max())
        tc = TrainConfig(ckpt_dir=tempfile.mkdtemp(prefix="chip_smoke_moe_"))
        one = Trainer(gs_model, tc, None, device=CARD)
        sh = Trainer(ep_model, tc, None, constrain=constrain, device=CARD)
        clone = lambda tr: tree_map(lambda t: t.detach().clone(), tr)  # noqa
        l1, g1 = one.loss_and_grads(clone(params), batch)
        l2, g2 = sh.loss_and_grads(clone(params), batch)
        shutil.rmtree(tc.ckpt_dir, ignore_errors=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    grad_err = max(rel_max(b, a) for (_, a), (_, b) in
                   zip(leaf_paths(g1), leaf_paths(g2)))
    loss_err = abs(float(l2) - float(l1)) / abs(float(l1))
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "hidden_max_abs_err": err, "hidden_bit_identical": err == 0.0,
           "atol": PART_EP_ATOL, "loss_rel_err": loss_err,
           "grad_max_rel_err": grad_err, "rtol": TRAIN_RTOL}
    if not (err <= PART_EP_ATOL and loss_err <= TRAIN_RTOL
            and grad_err <= TRAIN_RTOL):
        raise AssertionError(f"expert parallelism differs: {out}")
    del params, g1, g2, h_gs, h_ep
    torch.cuda.empty_cache()
    return out


# the four other families at full width, each block kind once: (arch,
# layers); the batch of drawn tokens (and frontend embeddings)
PART_FAMILIES = (("internvl2-2b", 2), ("whisper-base", 2),
                 ("zamba2-1.2b", 6), ("xlstm-125m", 8))
PART_FAMILY_B, PART_FAMILY_S = 4, 128


def partition_families(seed, tmp, mesh) -> dict:
    """``PART_FAMILIES`` (bf16 as drawn, each config's remat and
    optimizer; whisper's encoder cut like its decoder): ``PART_STEPS``
    ``Trainer`` steps on ``PART_FAMILY_B`` x ``PART_FAMILY_S`` batches
    from ``input_sample``, once without a constrainer and once with
    ``activation_constrainer(mesh)`` (the tensor-parallel design on the
    rank's shards, every collective over a group of one); losses,
    gnorms and every state leaf bit for bit."""
    import dataclasses

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.dist import activation_constrainer
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    out = {}
    shape = ShapeConfig("part", PART_FAMILY_S, PART_FAMILY_B, "train")
    for arch, layers in PART_FAMILIES:
        base = ARCHS[arch]
        kw = {"n_enc_layers": layers} if base.n_enc_layers else {}
        cfg = dataclasses.replace(base, n_layers=layers, **kw)
        model = build_model(cfg)
        g = torch.Generator(device="cpu").manual_seed(seed + 31)
        batches = [{k: v if v.is_floating_point() else v.long()
                    for k, v in model.input_sample(shape, g, CARD).items()}
                   for _ in range(PART_STEPS)]
        runs = []
        for label, hook in (("plain", None),
                            ("mesh", activation_constrainer(
                                mesh, fsdp=cfg.fsdp))):
            tr = Trainer(model, TrainConfig(
                total_steps=PART_STEPS, warmup_steps=1,
                ckpt_dir=str(Path(tmp) / f"part_{arch}_{label}")), None,
                constrain=hook, device=CARD)
            state = tr.init_state(seed)
            metrics, step_s = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics.append(tr.train_step(state, b))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            runs.append({"trainer": tr, "state": state, "step_s": step_s,
                         "losses": [float(m["loss"]) for m in metrics],
                         "gnorms": [float(m["gnorm"]) for m in metrics]})
        plain, sharded = runs
        design = sharded["trainer"].design
        bits = (plain["losses"] == sharded["losses"]
                and plain["gnorms"] == sharded["gnorms"]
                and same_tree(plain["state"], sharded["state"]))
        out[arch] = {"layers": layers, "design": design,
                     "tokens_per_step": PART_FAMILY_B * PART_FAMILY_S,
                     "losses": sharded["losses"],
                     "gnorms": sharded["gnorms"],
                     "bit_identical_with_and_without_mesh": bits,
                     "plain_step_s": plain["step_s"],
                     "mesh_step_s": sharded["step_s"]}
        del runs, plain, sharded, batches
        torch.cuda.empty_cache()
        if design != "tensor-parallel":
            raise AssertionError(f"the {arch} mesh trainer ran {design}")
        if not bits or not all(math.isfinite(x)
                               for x in out[arch]["losses"]):
            raise AssertionError(f"the {arch} mesh trainer differs: "
                                 f"{out[arch]}")
    return out


def phase_partition(seed, smi, tmp) -> dict:
    """Phase 16: one process in an ``nccl`` group of one (a file store
    under ``tmp``; ``gloo`` when ``CARD`` is the CPU), the mesh of
    ``make_mesh_for(1, 1)``: ``partition_train``, ``partition_moe`` and
    ``partition_families``, then the group destroyed.  Emits
    ``partition``."""
    import torch.distributed as dist

    from repro_torch.data import PackedTokenStore
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    from repro_torch.launch.mesh import make_mesh_for
    t0 = time.perf_counter()
    if CARD == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if CARD == "cuda" else "gloo",
                            init_method=f"file://{Path(tmp) / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh_for(1, 1, device=CARD)
        store = PackedTokenStore.synthetic(
            TRAIN_DOCS, mean_len=TRAIN_SEQ + 1,
            vocab=ARCHS[TRAIN_ARCH].vocab, seed=seed)
        fused_lookup.launches = 0
        ingest_place.launches = 0
        train = partition_train(seed, tmp, mesh, store)
        launches = {"fused_lookup": fused_lookup.launches,
                    "ingest_place": ingest_place.launches}
        moe = partition_moe(seed, mesh)
        families = partition_families(seed, tmp, mesh)
        out = {"mesh": list(mesh.shape),
               "mesh_dims": list(mesh.mesh_dim_names),
               "backend": dist.get_backend(), "train": train, "moe": moe,
               "families": families, "launches": launches}
    finally:
        dist.destroy_process_group()
    out["phase_seconds"] = time.perf_counter() - t0
    emit("partition", card=smi, **out)
    return out


# phase 17: the dry run's counts against the card.  (arch, shape, rows
# of one rank's share on pod16x16): the train rows cut (the module doc)
DRY_CELLS = (("internlm2-1.8b", "train_4k", 4),
             ("granite-moe-1b-a400m", "train_4k", 8),
             ("internlm2-1.8b", "decode_32k", 8))
DRY_DEPTHS = (2, 4)
DRY_PEAK_RTOL = 0.25
DRY_TIMED = 3
# the tensor-parallel rank shares: (arch, shape, depths), a pod16x16
# rank's own 16 rows at its local shard shapes
DRY_TP_CELLS = (("internlm2-1.8b", "train_4k", DRY_DEPTHS),
                ("zamba2-1.2b", "train_4k", (6, 12)))


def dry_depth(model, shape, seed, mesh=None) -> dict:
    """One depth of a cell: the count on ``meta``, then the same step
    on the card (its first run under ``FlopCounterMode``, the warm-up),
    then ``DRY_TIMED`` steps timed with CUDA events, the peak over them
    from ``max_memory_allocated``.  ``mesh``: the step of one rank of
    it (in the ``fake`` group the caller holds), else the plain one."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    step, args = dryrun.build_step(model, shape, mesh)
    counted = dryrun.count_step(step, args)
    del step, args
    step, args = dryrun.build_step(model, shape, mesh, device=CARD,
                                   seed=seed)
    with FlopCounterMode(display=False) as flops:
        step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRY_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    design = step.design
    del step, args
    torch.cuda.empty_cache()
    return {"layers": model.cfg.n_layers, "design": design,
            "card_flops": float(flops.get_total_flops()),
            "counted_flops": counted["flops_per_device"],
            "flops_equal": float(flops.get_total_flops())
            == counted["flops_per_device"],
            "card_peak_bytes": peak, "peak_bytes": counted["peak_bytes"],
            "peak_rel_err": (peak - counted["peak_bytes"])
            / counted["peak_bytes"],
            "argument_bytes": counted["argument_size_in_bytes"],
            "bytes_per_device": counted["bytes_per_device"],
            "step_ms": statistics.median(times), "step_ms_runs": times,
            "count_s": counted["count_s"]}


def dry_cell(arch, shape_name, rows, seed) -> dict:
    """A cell at ``DRY_DEPTHS``, the depth law to full depth, and the
    full-depth count's roofline terms at the H100's constants."""
    import dataclasses

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun, extrapolate, roofline
    from repro_torch.models import build_model
    base = ARCHS[arch]
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=rows)
    runs = [dry_depth(build_model(dataclasses.replace(base, n_layers=n)),
                      shape, seed) for n in DRY_DEPTHS]
    (a, ra), (b, rb) = [(r["layers"], r) for r in runs]
    full = extrapolate.at_depth(ra, rb, a, b, base.n_layers, fields=(
        "step_ms", "card_peak_bytes", "peak_bytes", "card_flops"))
    model = build_model(base)
    step, args = dryrun.build_step(model, shape, None)
    counted = dryrun.count_step(step, args)
    del step, args
    terms = {"compute_ms": 1e3 * counted["flops_per_device"]
             / roofline.PEAK_FLOPS,
             "memory_ms": 1e3 * counted["bytes_per_device"]
             / roofline.HBM_BW}
    bound = max(terms.values())
    return {"arch": arch, "shape": shape_name, "rows": rows,
            "tokens": rows * (shape.seq_len if shape.kind != "decode"
                              else 1),
            "depths": runs, "full_layers": base.n_layers,
            "extrapolated": full,
            "full_count": {k: counted[k] for k in (
                "flops_per_device", "bytes_per_device", "peak_bytes",
                "argument_size_in_bytes", "fits", "count_s")},
            "roofline_ms": terms,
            "dominant": max(terms, key=terms.get)[:-3],
            "measured_roofline_fraction": bound / full["step_ms"]}


def dry_tp_cell(seed, arch, shape_name, depths) -> dict:
    """A tensor-parallel rank share (``DRY_TP_CELLS``) on the card: rank
    255 of a ``fake`` group of 256 over the pod16x16 mesh, its own 16
    rows and its shards at full width, at ``depths``.  The ``fake``
    group's collectives move nothing (an all-gather copies the local
    shard), as in the count; FLOPs and peak against ``count_step`` of
    the same step on ``meta`` (``dry_depth``), the depth law to full
    depth beside the full-depth count's roofline terms."""
    import dataclasses

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun, extrapolate, roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    base, shape = ARCHS[arch], SHAPES[shape_name]
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device=CARD)
        runs = [dry_depth(build_model(dataclasses.replace(base, n_layers=n)),
                          shape, seed, mesh) for n in depths]
        step, args = dryrun.build_step(build_model(base), shape, mesh)
        counted = dryrun.count_step(step, args)
        del step, args
    (a, ra), (b, rb) = [(r["layers"], r) for r in runs]
    full = extrapolate.at_depth(ra, rb, a, b, base.n_layers, fields=(
        "step_ms", "card_peak_bytes", "peak_bytes", "card_flops"))
    terms = {"compute_ms": 1e3 * counted["flops_per_device"]
             / roofline.PEAK_FLOPS,
             "memory_ms": 1e3 * counted["bytes_per_device"]
             / roofline.HBM_BW}
    bound = max(terms.values())
    return {"arch": arch, "shape": shape_name, "mesh": "pod16x16",
            "rows": shape.global_batch // 16,
            "tokens": shape.global_batch // 16 * shape.seq_len,
            "depths": runs, "full_layers": base.n_layers,
            "extrapolated": full,
            "full_count": {k: counted[k] for k in (
                "flops_per_device", "bytes_per_device", "peak_bytes",
                "argument_size_in_bytes", "collective_bytes_per_device",
                "collectives", "fits", "count_s")},
            "roofline_ms": terms,
            "dominant": max(terms, key=terms.get)[:-3],
            "measured_roofline_fraction": bound / full["step_ms"]}


def phase_dryrun(seed, smi) -> dict:
    """Phase 17 (see the module doc); emits ``dryrun``.  Every check is
    asserted after the line is printed, so a miss shows its numbers."""
    from repro_torch.kernels.gap_place import ingest_place
    from repro_torch.kernels.lookup import fused_lookup
    from repro_torch.launch import dryrun, roofline
    t0 = time.perf_counter()
    fused_lookup.launches = 0
    ingest_place.launches = 0
    cells = [dry_cell(a, s, rows, seed) for a, s, rows in DRY_CELLS]
    tp_cells = [dry_tp_cell(seed, *c) for c in DRY_TP_CELLS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        rec = dryrun.run_cell("whisper-base", "decode_32k", False, tmp)
    total = (torch.cuda.get_device_properties(0).total_memory
             if CARD == "cuda" else roofline.HBM_BYTES)
    out = {"cells": cells, "tp_cells": tp_cells,
           "whisper_cell": {k: rec.get(k) for k in (
               "status", "design", "n_devices", "flops_per_device",
               "bytes_per_device", "collective_bytes_per_device",
               "collectives", "peak_bytes", "fits", "count_s", "error")},
           "hbm_bytes": roofline.HBM_BYTES, "total_memory": total,
           "launches": {"fused_lookup": fused_lookup.launches,
                        "ingest_place": ingest_place.launches},
           "phase_seconds": time.perf_counter() - t0}
    emit("dryrun", card=smi, **out)
    runs = [r for c in cells + tp_cells for r in c["depths"]]
    if {r["design"] for c in tp_cells for r in c["depths"]} != {
            "tensor-parallel"}:
        raise AssertionError("a rank share ran another design")
    if not all(r["flops_equal"] for r in runs):
        raise AssertionError("the card's FLOPs differ from the count")
    if not all(abs(r["peak_rel_err"]) <= DRY_PEAK_RTOL for r in runs):
        raise AssertionError("a measured peak is off the count by more "
                             f"than {DRY_PEAK_RTOL:.0%}")
    if (rec["status"] != "ok" or rec["n_devices"] != 256
            or rec["design"] != "tensor-parallel"):
        raise AssertionError(f"the whisper-base cell: {rec}")
    if total != roofline.HBM_BYTES:
        raise AssertionError(f"roofline.HBM_BYTES {roofline.HBM_BYTES} is "
                             f"not the card's {total}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the 64-bit image behind the serving queue (YCSB's hashed keys)
# ---------------------------------------------------------------------------

U64_CALLERS = 8        # the YCSB cell's clients
U64_CALL = 2048        # keys a request
U64_NEAR = 256         # of them, neighbours k - 1 / k + 1 of records
U64_ROUNDS = 48        # requests a caller in the counted run


def u64_requests(rng, keys, n) -> list:
    """``n`` requests of ``U64_CALL`` keys: records, and ``U64_NEAR``
    neighbours of records (absent but where two keys are adjacent)."""
    out = []
    for _ in range(n):
        rec = keys[rng.integers(0, keys.size, U64_CALL - U64_NEAR)]
        near = keys[rng.integers(1, keys.size, U64_NEAR)]
        near = np.where(rng.random(U64_NEAR) < 0.5, near - np.uint64(1),
                        near + np.uint64(1))
        out.append(rng.permutation(np.concatenate([rec, near])))
    return out


def u64_callers(queue, reqs_by_caller, max_wait_ms) -> list:
    """Each caller thread submits its requests one at a time, waits out
    the queue's deadline and takes its result; ``(keys, result)`` of
    every request."""
    done, errors = [], []
    lock = threading.Lock()

    def caller(reqs):
        try:
            for q in reqs:
                t = queue.submit_lookup(q)
                time.sleep(max_wait_ms / 1e3)
                res = queue.result(t)
                with lock:
                    done.append((q, res))
        except BaseException as e:   # re-raised below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=caller, args=(r,), daemon=True)
               for r in reqs_by_caller]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a u64 caller did not finish")
    return done


def kernel_case_u64(name, idx, q):
    """``fused_lookup_u64`` against ``fused_lookup_u64_plain`` on the
    engine's own inputs for the dispatch buffer ``q`` (a whole bucket),
    as ``QueryEngine`` builds them."""
    from repro_torch.core import keys64 as k64
    from repro_torch.kernels import ops
    from repro_torch.kernels.lookup import (fused_lookup_u64,
                                            fused_lookup_u64_plain)
    eng = idx.sync_device()
    a = eng.arrays
    b = q.shape[0]
    assert eng.bucket(b) == b, "case batches are whole buckets"
    qs = torch.sort(torch.from_numpy(k64.query_ordered(q)[0]).cuda()).values
    q_tile = min(b, ops.auto_q_tile(b, a.n_slots, eng.w_tile))
    args = ops.fused_args_u64(qs, a, eng._elo, eng._radix_table,
                              eng._radix_key, eng._radix_scale,
                              q_tile=q_tile, w_tile=eng.w_tile)
    statics = dict(q_tile=q_tile, w_tile=eng.w_tile,
                   flat_w=eng._fused_width_for(b), max_chain=a.max_chain,
                   n_slots=a.n_slots, wide=a.wide)
    got = fused_lookup_u64(*args, **statics)
    want = fused_lookup_u64_plain(*args, **statics)
    torch.cuda.synchronize()
    err = compare_outputs(name, got, want)
    return args, statics, got, err


def fused_bytes_u64(args, statics, got) -> int:
    """``fused_bytes`` of the 64-bit kernel: 8-byte queries and slot
    keys, the small tables, each distinct window and answer slot once,
    the outputs; link probes left out (a lower bound)."""
    from repro_torch.kernels.lookup import window_base_u64
    (q, tile_block, radix_table, radix_key, radix_scale, segk, slope, iclo,
     _sk, _pay, _payhi, _off, _lk, _lp, _lph) = args
    q_tile, w_tile, flat_w = (statics["q_tile"], statics["w_tile"],
                              statics["flat_w"])
    n_q = q.shape[0]
    base = (tile_block.long() * w_tile).repeat_interleave(q_tile)
    if flat_w:
        lo0 = window_base_u64(q, radix_table, radix_key, radix_scale, segk,
                              slope, iclo, n_slots=statics["n_slots"])
        win = (lo0 - base)[:, None] + torch.arange(flat_w + 1,
                                                   device=q.device)
        win = base[:, None] + win.clamp(0, 2 * w_tile - 1)
        small = sum(t.numel() * t.element_size()
                    for t in (radix_table, radix_key, radix_scale, segk,
                              slope, iclo))
    else:
        win = (tile_block.long().unique()[:, None] * w_tile
               + torch.arange(2 * w_tile, device=q.device))
        small = 0
    n_win = int(torch.unique(win).numel())
    pay_bytes = 8 if statics["wide"] else 4
    slot = got[0].long()
    n_ans = int(torch.unique(slot[slot >= 0]).numel())
    inputs = (n_q * 8 + tile_block.numel() * 4 + small + n_win * 8
              + n_ans * (pay_bytes + 8))
    outputs = n_q * (4 * 4 + (4 if statics["wide"] else 0) + 1) \
        + tile_block.numel() * 4
    return inputs + outputs


def u64_kernel_row(u64) -> dict:
    """Phase 18's row of the kernels line."""
    t = u64["timing"]
    return {"name": "fused_lookup_u64", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_lookup.cu "
                      "(fused_lookup64_kernel)",
            "replaces": "src/repro/kernels/lookup.py:415 over the 64-bit "
                        "image (the reference holds no 64-bit keys)",
            "launches": u64["launches"]["fused_lookup_u64"],
            "max_abs_err": u64["max_abs_err"],
            **{k: t[k] for k in ("ms", "device_ms", "graph_ms", "host_us",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}


def phase_u64(rng, seed, smi, n_keys) -> dict:
    """Phase 18: YCSB's hashed record keys (the YCSB cell's
    ``record_keys``: ``fnvhash64`` of keynums 0 .. n_keys - 1, below
    2^63) on the 64-bit image, built as the YCSB cell
    builds them, served by ``MicroBatchQueue`` over an ``EpochPipeline``
    to 8 caller threads of 2,048-key requests (records and their
    neighbours), every answer against ``repro_torch.plain_kv``; the
    launch counts set to 0 just before the counted run and read just
    after; then the kernel at every dispatch buffer the run gave it
    against its plain version, bit for bit, and timed at the largest."""
    from repro_torch.core import Index
    from repro_torch.kernels.lookup import (fused_lookup, fused_lookup_u64,
                                            fused_lookup_u64_plain)
    from repro_torch.plain_kv import PlainKV
    from repro_torch.serving import EpochPipeline, MicroBatchQueue
    from portbench.harness import PB, load_module
    t0 = time.perf_counter()
    # the YCSB cell's own key draw
    keys, _ = load_module(PB / "drivers" / "ycsb_hashed.py").record_keys(
        n_keys)
    pays = rng.integers(0, 2 ** 30, keys.size)
    gen_s = time.perf_counter() - t0
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.01, payloads=pays,
                      rng=np.random.default_rng(seed), device="cuda")
    eng = idx.sync_device()
    a = eng.arrays
    if not a.key_u64:
        raise AssertionError("hashed 63-bit keys did not take the 64-bit "
                             "image")
    emit("u64_build", card=smi, n_keys=int(keys.size),
         n_slots=int(a.n_slots), device_bytes=int(idx.device_bytes()),
         keygen_seconds=gen_s, build_seconds=idx.build_seconds,
         freeze_seconds=idx.stats["freeze_seconds"])
    pipe = EpochPipeline(idx, publish_every=1)
    queue = MicroBatchQueue(pipe, max_wait_ms=2, max_depth=64)
    seen = {}   # one dispatch buffer of each bucket size the queue sent
    lookup = idx.lookup

    def recording(q, *args, **kwargs):
        seen[q.shape[0]] = np.array(q, copy=True)
        return lookup(q, *args, **kwargs)

    idx.lookup = recording
    ref = PlainKV(keys, pays)
    try:
        # warm-up: every bucket 1..8 callers coalesce to, uncounted
        for n in range(1, U64_CALLERS + 1):
            for _ in range(3):
                u64_callers(queue, [u64_requests(rng, keys, 1)
                                    for _ in range(n)], 0.0)
        reqs = [u64_requests(rng, keys, U64_ROUNDS)
                for _ in range(U64_CALLERS)]
        q0, s0, e0 = dict(queue.stats), dict(idx.stats), dict(eng.stats)
        fused_lookup.launches = fused_lookup_u64.launches = 0
        t1 = time.perf_counter()
        done = u64_callers(queue, reqs, queue.max_wait_ms)
        wall = time.perf_counter() - t1
        launches = {"fused_lookup_u64": fused_lookup_u64.launches,
                    "fused_lookup": fused_lookup.launches}
        q1, s1 = queue.stats, idx.stats
    finally:
        queue.close()
        pipe.close()
        idx.lookup = lookup
    dispatches = q1["lookup_dispatches"] - q0["lookup_dispatches"]
    wrong = 0
    for q, res in done:
        want_pay, want_found = ref.answer(q)
        wrong += int(np.count_nonzero((res.payloads != want_pay)
                                      | (res.found != want_found)))
    escapes = eng.stats["oracle_escapes"] - e0["oracle_escapes"]
    run = {"requests": len(done), "keys": len(done) * U64_CALL,
           "dispatches": dispatches,
           "lookups_u64": s1["lookups_u64"] - s0.get("lookups_u64", 0),
           "keys_per_dispatch": (q1["lookup_keys"] - q0["lookup_keys"])
           / max(dispatches, 1),
           "oracle_escapes": escapes, "wall_seconds": wall,
           "keys_per_second": len(done) * U64_CALL / wall,
           "launches": launches, "wrong_answers": wrong}
    emit("u64_serve", card=smi, **run)
    if wrong:
        raise AssertionError(f"u64: {wrong} answers differ from the plain "
                             "reference")
    if run["lookups_u64"] != dispatches or launches["fused_lookup"]:
        raise AssertionError(f"u64: dispatches off the 64-bit path: {run}")
    if launches["fused_lookup_u64"] != dispatches:
        raise AssertionError(f"u64: a dispatch without one launch: {run}")
    # the kernel at every dispatch shape against its plain version;
    # these launches are after the count was read
    err, cases = 0, {}
    for b in sorted(seen):
        args, statics, got, e = kernel_case_u64(f"u64_dispatch_{b}", idx,
                                                seen[b])
        err = max(err, e)
        cases[b] = {"q_tile": statics["q_tile"], "flat_w": statics["flat_w"],
                    "escapes": int(got[4].sum()), "outputs_equal": 7}
    emit("u64_kernel_vs_plain", card=smi, buckets=cases, tolerance=TOL)
    b = max(seen)
    args, statics, got, _ = kernel_case_u64("u64_timing", idx, seen[b])
    k_t = kernel_times(lambda: fused_lookup_u64(*args, **statics),
                       "fused_lookup64_kernel")
    p_ms = cuda_ms(lambda: fused_lookup_u64_plain(*args, **statics),
                   launches=5)
    sk, qs = args[8], args[0]
    lib_ms = cuda_ms(lambda: torch.searchsorted(sk, qs, right=True))
    nbytes = fused_bytes_u64(args, statics, got)
    per_q = statics["flat_w"] + 1 if statics["flat_w"] else 2 * statics[
        "w_tile"]
    nops = qs.shape[0] * (per_q + 10 + int(a.max_chain).bit_length())
    timing = dict(
        **k_t, plain_ms=p_ms, library_ms=lib_ms,
        bound_ms=max(nbytes / H100_BYTES_PER_S,
                     nops / H100_F32_OPS_PER_S) * 1e3,
        bound_by=("bytes" if nbytes / H100_BYTES_PER_S
                  >= nops / H100_F32_OPS_PER_S else "operations"),
        max_abs_err=err, bytes=nbytes, ops=nops, batch=b,
        flat_w=statics["flat_w"], q_tile=statics["q_tile"])
    emit("u64_kernel_timing", card=smi, **timing,
         library_call="torch.searchsorted(slot_key, q, right=True) over "
                      "the ordered int64 slot keys: slot only",
         kernel_vs_plain=TOL)
    return {"launches": launches, "serve": run, "timing": timing,
            "max_abs_err": err}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-keys", type=int, default=32_000_000)
    ap.add_argument("--fused-keys", type=int, default=0,
                    help="keys in phase 5's build (default: the largest "
                         "of 3.6M, 3.5M, 3.4M whose n_slots < 2^22)")
    ap.add_argument("--fused-batches", type=int, default=64,
                    help="insert batches of the w = 0.3 traffic in phase 5 "
                         "(0: all of the held-out keys, 151 batches)")
    ap.add_argument("--place-keys", type=int, default=0,
                    help="keys in phase 6's build (default: the largest "
                         "of 14.5M, 14M whose n_slots < 2^24)")
    ap.add_argument("--place-batches", type=int, default=16,
                    help="insert batches of 16,384 keys in phase 6")
    ap.add_argument("--narrow-keys", type=int, default=8_000_000,
                    help="keys (below 2^24) of the legacy phase's narrow "
                         "index")
    ap.add_argument("--serve-keys", type=int, default=0,
                    help="keys in phase 10's builds (default: the largest "
                         "of 3.6M, 3.5M, 3.4M whose n_slots < 2^22) and "
                         "in phase 11's durability run (default 3.6M)")
    ap.add_argument("--u64-keys", type=int, default=20_000_000,
                    help="keynums hashed into phase 18's 64-bit keys")
    ap.add_argument("--only-u64", action="store_true",
                    help="run the kernel build, the launch floor and "
                         "phase 18 alone, and print fused_lookup_u64's "
                         "row of the kernels line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace three lookups per batch size (read "
                         "path and shard fan-out), two insert batches "
                         "of each write path, eight decode rounds and "
                         "two training steps with torch.profiler and "
                         "print the device-time breakdown")
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
         ptxas={n: _build.ptxas_report(n).strip().splitlines()
                for n in _build.SOURCES})

    floor = launch_floor(smi)
    rng = np.random.default_rng(args.seed)
    from repro_torch.kernels import delta
    freezes = {}

    def counted(name, phase, *a, **kw):
        n0 = delta.device_freezes
        out = phase(*a, **kw)
        freezes[name] = delta.device_freezes - n0
        emit("device_freezes", card=smi, after=name, count=freezes[name])
        return out

    if args.only_u64:
        u64 = counted("u64", phase_u64, rng, args.seed, smi, args.u64_keys)
        print(json.dumps({"kernels": [u64_kernel_row(u64)]}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    cases = phase_cases(rng)
    main_res = counted("main", phase_main, rng, args.n_keys, args.seed, smi,
                       args.profile)
    place_rows = phase_place_cases(rng)
    fused_res = counted("fused", phase_fused, rng, args.seed, smi,
                        args.fused_keys, args.fused_batches or 10 ** 9,
                        args.profile)
    fused_idx = fused_res.pop("index")
    lo, hi = fused_idx.keys[0], fused_idx.keys[-1]
    fused_timing = time_place(
        fused_idx, np.floor(rng.uniform(lo, hi, 16_384)), smi, "fused")
    del fused_idx
    two_res = counted("two_dispatch", phase_two_dispatch, rng, args.seed,
                      smi, args.place_keys, args.place_batches, args.profile)
    place_timing = time_place(two_res.pop("index"),
                              two_res["held_left"][:16_384], smi,
                              "two_dispatch")
    legacy_rows = phase_legacy_cases(rng) + phase_bracket_cases()
    eq3 = phase_eq3(main_res, smi)
    legacy = counted("legacy", phase_legacy, rng, args.seed, smi,
                     args.narrow_keys, main_res)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        shard = counted("shard", phase_shard, rng, args.seed, smi, main_res,
                        args.serve_keys, Path(tmp), args.profile)
    del main_res["index"], main_res["keys"], main_res["queries"]
    serve = counted("serve", phase_serve, rng, args.seed, smi,
                    args.serve_keys)
    u64 = counted("u64", phase_u64, rng, args.seed, smi, args.u64_keys)
    consumers = counted("consumers", phase_consumers, rng, args.seed, smi)
    decode = phase_decode(rng, args.seed, smi, args.profile)
    recurrent = phase_recurrent(rng, args.seed, smi, args.profile)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train = phase_train(rng, args.seed, smi, tmp, args.profile)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_part_") as tmp:
        part = phase_partition(args.seed, smi, tmp)
    dry = phase_dryrun(args.seed, smi)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported during the run")

    big = main_res["per_batch"][max(main_res["per_batch"])]
    # phases 10-12's kernel-vs-plain checks at their own shapes
    later_vs_plain = [serve["kernel_vs_plain"], shard["kernel_vs_plain"],
                      *consumers["kernel_vs_plain"].values()]
    decode_lookup_err = max(decode["fused_lookup_max_abs_err"],
                            recurrent["fused_lookup_max_abs_err"])

    def times(row):
        return {k: row[k] for k in ("ms", "device_ms", "graph_ms", "host_us",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}

    kernels = [{
        "name": "fused_lookup",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_lookup.cu",
        "replaces": "src/repro/kernels/lookup.py:415",
        # the read path, the write phases' lookup checks, the serving
        # stack's live lookups and its lookups after recovery, the
        # sharded index's grouped path and shard durability, the
        # consumers' lookups, the decode loops' page lookups (phases 13
        # and 14)
        "launches": (main_res["launches"]
                     + fused_res["launches"]["fused_lookup"]
                     + two_res["launches"]["fused_lookup"]
                     + serve["launches"]["fused_lookup"]
                     + shard["launches"]["fused_lookup"]
                     + consumers["launches"]["fused_lookup"]
                     + decode["launches"]["fused_lookup"]
                     + recurrent["launches"]["fused_lookup"]
                     + train["launches"]["fused_lookup"]
                     + part["launches"]["fused_lookup"]
                     + dry["launches"]["fused_lookup"]),
        "max_abs_err": max([b["max_abs_err"]
                            for b in main_res["per_batch"].values()]
                           + [r["fused_lookup_max_abs_err"]
                              for r in later_vs_plain]
                           + [decode_lookup_err]),
        **times(big),
    }, {
        "name": "ingest_place",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ingest_place.cu",
        "replaces": "src/repro/kernels/gap_place.py:618",
        "launches": (fused_res["launches"]["ingest_place"]
                     + two_res["launches"]["ingest_place"]
                     + serve["launches"]["ingest_place"]
                     + shard["launches"]["ingest_place"]
                     + consumers["launches"]["ingest_place"]
                     + decode["launches"]["ingest_place"]
                     + recurrent["launches"]["ingest_place"]
                     + train["launches"]["ingest_place"]
                     + part["launches"]["ingest_place"]
                     + dry["launches"]["ingest_place"]),
        "max_abs_err": max([place_timing["max_abs_err"]]
                           + [r["ingest_place_max_abs_err"]
                              for r in later_vs_plain]),
        **times(place_timing),
    }, {
        "name": "gap_place",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gap_place.cu",
        "replaces": "src/repro/kernels/gap_place.py:271",
        "launches": eq3["launches"],
        "max_abs_err": max([eq3["max_abs_err"]]
                           + [r["max_abs_err"] for r in legacy_rows
                              if r["kernel"] == "gap_place"]),
        **times(eq3),
    }, {
        "name": "lookup_kernel",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lookup_kernel.cu",
        "replaces": "src/repro/kernels/lookup.py:120",
        "launches": legacy["launches"],
        "max_abs_err": max([legacy["max_abs_err"]]
                           + [r["max_abs_err"] for r in legacy_rows
                              if r["kernel"] == "lookup_kernel"]),
        **times(legacy),
    }, u64_kernel_row(u64)]
    emit("summary", card=smi, cases=len(cases), place_cases=len(place_rows),
         launch_floor={k: floor[k] for k in ("ms", "device_ms", "graph_ms",
                                             "host_us")},
         device_freezes=freezes,
         read_path=main_res["main"],
         read_path_ms={"kernel_engine": main_res["lookup_ms"],
                       "xla_engine": main_res["xla_ms"]},
         fused_write_path=fused_res["launches"],
         fused_commit_rate_w03=fused_res["w03_fused_commit_rate"],
         two_dispatch_write_path=two_res["launches"],
         place_timing_fused_index=fused_timing,
         legacy_cases=len(legacy_rows), eq3_launches=eq3["launches"],
         legacy_path={"lookup_kernel": legacy["launches"],
                      "pallas_served_by": legacy["pallas_served"],
                      "xla_windowed_ms": legacy["xla_ms"]},
         serve_path=serve["launches"],
         u64_path={**u64["launches"], **{k: u64["serve"][k] for k in (
             "dispatches", "keys_per_dispatch", "keys_per_second")}},
         serve={label: {k: m[k] for k in (
             "method", "lookup_ms_p50", "lookup_ms_p99",
             "pipeline_live_lookups", "pipeline_snapshot_lookups",
             "ingest_devices", "fused_commits")}
             for label, m in serve["mixes"].items()},
         serve_recovery={k: serve["mixes"][SERVE_MIXES[0][0]][k] for k in (
             "recover_seconds", "replayed", "skipped",
             "retrain_seconds")},
         shard_path=shard["launches"],
         shard={"fanout_devices": shard["fanout_devices"],
                "fanout_ms": {n: r["ms_per_batch"]
                              for n, r in shard["reads"].items()},
                "write_ms_per_batch": shard["writes"]["ms_per_batch"][
                    "median"],
                "recover_seconds": shard["durability"]["recover_seconds"],
                "checkpoint": shard["durability"]["checkpoint"]},
         consumers_path=consumers["launches"],
         decode={k: decode[k] for k in (
             "decoded_tokens", "rounds", "wall_seconds",
             "tokens_per_second", "round_ms_p50", "round_ms_p99",
             "model_step_ms_p50", "page_lookup_ms_p50", "alloc_ms_p50",
             "sampling_ms_p50", "step_byte_bound_ms", "launches")},
         decode_numerics={k: decode["numerics"][k] for k in (
             "f32", "bf16", "two_layers_card_vs_cpu_f32")},
         recurrent_decode={arch: {
             **{k: o[k] for k in (
                 "tokens_per_second", "round_ms_p50", "round_ms_p99",
                 "model_step_ms_p50", "page_lookup_ms_p50",
                 "step_byte_bound_ms", "launches")},
             "numerics": {k: o["numerics"][k] for k in (
                 "f32", "bf16", "first_group_card_vs_cpu_f32")}}
             for arch, o in recurrent["per_arch"].items()},
         train={**{k: train[k] for k in (
             "step_ms_p50", "step_ms_p99", "optimizer_share",
             "tokens_per_second", "mfu", "peak_memory_bytes",
             "save_s", "async_wait_s", "restore_s",
             "replayed_steps_max_rel_diff", "heldout_loss_before",
             "heldout_loss_after", "launches")},
             "card_vs_cpu_f32": {
                 a: r["grad_max_rel_err"] for a, r in
                 train["numerics"]["card_vs_cpu_f32"].items()}},
         partition={"phase_seconds": part["phase_seconds"],
                    "design": part["train"]["design"],
                    "bit_identical_with_and_without_mesh": part["train"][
                        "bit_identical_with_and_without_mesh"],
                    "elastic_restore_bit_for_bit": part["train"][
                        "elastic_restore_bit_for_bit"],
                    "moe_ep_hidden_max_abs_err": part["moe"][
                        "hidden_max_abs_err"],
                    "families_bit_identical": {
                        a: f["bit_identical_with_and_without_mesh"]
                        for a, f in part["families"].items()},
                    "launches": part["launches"]},
         dryrun={"phase_seconds": dry["phase_seconds"],
                 "flops_equal": all(r["flops_equal"] for c in dry["cells"]
                                    for r in c["depths"]),
                 "peak_rel_err": {f"{c['arch']}/{c['shape']}/L{r['layers']}":
                                  r["peak_rel_err"] for c in dry["cells"]
                                  for r in c["depths"]},
                 "full_depth_step_ms": {f"{c['arch']}/{c['shape']}":
                                        c["extrapolated"]["step_ms"]
                                        for c in dry["cells"]},
                 "tp_rank_share": {c["arch"]: {
                     "flops_equal": all(r["flops_equal"]
                                        for r in c["depths"]),
                     "peak_rel_err": [r["peak_rel_err"]
                                      for r in c["depths"]],
                     "step_ms": [r["step_ms"] for r in c["depths"]],
                     "full_depth_step_ms": c["extrapolated"]["step_ms"]}
                     for c in dry["tp_cells"]},
                 "launches": dry["launches"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
