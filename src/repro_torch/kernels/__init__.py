"""Device half of the port: freeze, window bounds, the lookup engine,
the write path and the hand-written CUDA kernels.

freeze.py     — padded f32/i32 images (``IndexArrays``) on one device
bounds.py     — query-safe window bounds, radix and rank routers, tile
                sizing
ref.py        — the device oracle stage and the epilogue, plain torch
lookup.py     — ``fused_lookup`` (launches csrc/fused_lookup.cu) and
                ``fused_lookup_plain`` (the same function in torch ops);
                ``lookup_kernel`` / ``lookup_kernel_plain``, the legacy
                narrow-key kernel (csrc/lookup_kernel.cu), and
                ``lookup_kernel_brackets``, the tile brackets it stages
ops.py        — sort, tile schedule, launch, escape fixup, unsort for
                the fused stage, the legacy "pallas" / "xla" stages and
                the oracle; ``batched_lookup`` and ``QueryEngine``
                (lookups, delta swaps, bound / rank-row refreshes,
                ingest entry points); the reference's fused-XLA
                rank-router search and its host escape patch, in torch
                ops
shard_fanout.py — stacked shard images and the sharded index's fan-out
                (learned route, exchange, per-shard rank-router search
                over the stack, inverse permutation)
delta.py      — ``freeze_state`` (engine + host mirror) and
                ``delta_update`` (only the changed elements move)
gap_place.py  — ``ingest_place`` (launches csrc/ingest_place.cu) and
                ``ingest_place_plain``; ``fused_ingest_body``, the
                single-dispatch ingest graph in torch ops; ``gap_place``
                (launches csrc/gap_place.cu, Eq. 3),
                ``gap_place_plain`` and ``gap_place_brackets``, the
                chunk brackets it routes in
ops_gap.py    — device Eq. 3 (``gap_positions_device``, its tables
                ``prepare_gap_tables`` and the host oracle
                ``gap_positions_oracle``) and the write path's entry
                points ``ingest_place`` and ``fused_ingest``
place.py      — ``build_gapped_device``: the build's placement (predict,
                place, link, exact bounds) in torch ops on the index's
                device; no Pallas counterpart (the reference builds on
                the host)
_build.py     — nvcc + ctypes build of csrc/*.cu at first use, and the
                wrappers' per-call checks and launch

The package exports every name of the reference's
``repro.kernels.__all__``; ``ingest_place`` is ``ops_gap``'s entry
point (the kernel's wrapper is ``gap_place.ingest_place``).
"""

from .bounds import build_radix_router, build_rank_router
from .delta import HostMirror, delta_update, freeze_state
from .freeze import (IndexArrays, from_learned_index, keys_need_pair,
                     keys_pair_exact, pair_alias_free, split_key_pair)
from .ops import QueryEngine, batched_lookup
from .ops_gap import (fused_ingest, gap_positions_device,
                      gap_positions_oracle, ingest_place)
from .ref import chain_hit_index, lookup_ref, predict_ref, resolve_chains
from .shard_fanout import (FanoutUnavailable, ShardFanout,
                           stack_shard_images)

__all__ = [
    "FanoutUnavailable",
    "HostMirror",
    "IndexArrays",
    "QueryEngine",
    "ShardFanout",
    "batched_lookup",
    "build_radix_router",
    "build_rank_router",
    "chain_hit_index",
    "delta_update",
    "freeze_state",
    "from_learned_index",
    "fused_ingest",
    "gap_positions_device",
    "gap_positions_oracle",
    "ingest_place",
    "keys_need_pair",
    "keys_pair_exact",
    "lookup_ref",
    "pair_alias_free",
    "predict_ref",
    "resolve_chains",
    "split_key_pair",
    "stack_shard_images",
]
