"""Multi-pod dry run on one H100's terms: the counterpart of
``repro.launch.dryrun``.  Proves every (arch x shape x mesh) cell runs,
and says whether it fits the card and what bounds it, without a card.

The reference lowers and compiles each cell over 512 placeholder
devices, then reads XLA's ``memory_analysis``, ``cost_analysis`` and the
HLO's collectives.  The port has no compiler to ask.  It RUNS its own
step on ``meta`` tensors (shapes and dtypes, no data) as one rank of a
``fake``-backend process group of 256 ranks (pod16x16) or 512
(pod2x16x16), over ``launch.mesh.make_production_mesh(device="cpu")``,
and counts what that step does.  The group is symmetric, so rank
``world - 1`` stands for every rank: each count is per device.

The step is the one the port runs, in one of two designs (the
record's ``"design"``, ``step.design``):

* **"tensor-parallel"** (a model with ``tensor_parallel``, every
  family, and heads-sharded caches): the rank computes on its own
  shards, as GSPMD runs the reference's jitted step.  Params split over
  "model" stay split, FSDP leaves are gathered over "data" a layer at a
  time, and the collectives are the "model" all-reduces and gathers and
  the "data" all-gathers and reduce-scatters
  (``dist.partitioning.TensorParallel``);
* **"gather-at-use"** (a model whose ``tensor_parallel`` a caller has
  turned off, or ``kv_shard="seq"``): the params are gathered whole for
  the step (``full_tensor``).

* **train**: ``Trainer.train_step`` itself (the trainer picks the
  design), on a state built from ``abstract_params()``, the optimizer's
  ``abstract=True`` init (and ``residual_init(abstract=True)`` with
  ``grad_compress``) and placed by ``Trainer.shard_state``, with the
  rank's rows of ``input_specs(shape)`` under ``input_shardings``;
* **prefill / decode**: the rank's rows of the batch, then
  ``prefill_fn`` / ``decode_fn`` (``loss_fn`` with ``labels = tokens``
  where ``prefill_fn`` is None, as the reference does): under
  tensor parallelism on the rank's param shards and its cache shards
  under ``_cache_shardings`` (where the long-context rule splits a
  cache's sequence over the batch axes, zamba2-1.2b's long_500k, the
  rank attends over its own positions: the hook's ``kv_seq``); under
  gather-at-use on the params gathered whole and the cache shards
  gathered whole along every dim but the batch.

``build_step`` with ``mesh=None`` is the same step on one process (no
gather, every row), on ``meta`` or, with real data, on a device: the
program ``chip_smoke.py`` runs on the card to hold these counts to it.
With a mesh and a device, the rank's share of the step runs on that
device with real data; in the ``fake`` group its collectives move
nothing (an all-gather copies the local shard into every slot), which
is how ``chip_smoke.py`` runs a tensor-parallel rank's share on the
card.

What each field counts (``count_step``):

* ``flops_per_device``: ``FlopCounterMode``'s total over the step;
* ``bytes_per_device``: every eager aten op's operands once, the
  elements of its input and output tensors; view and metadata-only ops
  count 0.  That is what the eager port moves, and it bounds a fused
  program's traffic from above;
* ``collective_bytes_per_device``, ``collective_ops``, ``collectives``:
  the result bytes of every c10d op the step issues, by the reference's
  five kinds (``collective_bytes``);
* ``argument_size_in_bytes``: the at-rest bytes of the rank's shards of
  the params, optimizer state, residual, batch and caches;
* ``alias_size_in_bytes``: of these, what the step writes back in place
  (the trainer's state, the caches), as the reference's donated
  arguments; ``output_size_in_bytes``: that plus the step's fresh
  outputs (the metrics, the logits);
* ``peak_bytes``: ``MemTracker``'s peak over the step, the arguments
  included, with the temporaries that two ops' CUDA kernels allocate
  out of a dispatch mode's sight held over those ops
  (``_card_workspace``); ``temp_size_in_bytes``: the peak less the
  arguments;
* ``fits``: ``peak_bytes <= roofline.HBM_BYTES``.  A cell that does not
  fit is ``"ok"`` with ``fits`` false, not an error;
* ``count_s``: the wall seconds of the count (where the reference has
  ``lower_s`` / ``compile_s``).

``--scan-layers`` is accepted and recorded.  It changes nothing: the
eager port runs every layer either way (XLA's cost analysis counts a
scanned body once, which the reference's flag is about).

Importing this module starts no process group and sets no environment
variable.  The CLI and ``run_cell`` (when no group is up) start the
``fake`` group themselves and destroy it in a ``finally``; a mesh covers
the whole group, so ``--mesh both`` runs one group after the other.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both [--out results/dryrun]
  python -m repro_torch.launch.dryrun --table results/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES
from ..dist.partitioning import (
    PS,
    Sharding,
    TensorParallel,
    _spec_axes,
    activation_constrainer,
    input_shardings,
    local_shard,
    param_shardings,
    place,
)
from ..models import build_model
from ..optim import OPTIMIZERS
from ..optim.compress import residual_init
from ..tree import leaves, tree_map, unflatten
from . import roofline
from .mesh import make_production_mesh

__all__ = ["applicable", "build_step", "collective_bytes", "count_step",
           "fake_group", "run_cell", "main"]


# cells that are N/A by design (documented in DESIGN.md §4):
# long_500k needs sub-quadratic attention.
def applicable(cfg, shape) -> bool:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# c10d ops (eager, in place: the first argument is what they write) and
# functional collectives (the result is returned) -> the HLO kind
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
# no data moved: completion and bookkeeping
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "barrier",
                    "monitored_barrier_")
# ops that read and write no array (a view is found by its schema); a
# scalar read back to the host (the NaN guard's) moves no array either
_METADATA_OPS = ("empty", "empty_strided", "empty_like", "new_empty",
                 "new_empty_strided", "lift_fresh", "set_", "resize_",
                 "promote_types", "_local_scalar_dense")


def collective_bytes(collectives):
    """Sum the result bytes of every collective op the step issued.

    Returns ``(total_bytes, per_kind dict, op_count)`` as the
    reference's does.  Its input is the ``(op name, result bytes)``
    pairs that ``count_step``'s counting mode recorded (the port has no
    HLO): a c10d op's name (``c10d.allreduce_``,
    ``_c10d_functional.all_gather_into_tensor``, ...) maps onto the
    reference's five kinds; an op of no kind raises.
    """
    per_kind = {k: 0 for k in _COLLECTIVES}
    count = 0
    for name, nbytes in collectives:
        op = name.split(".")[1] if "." in name else name
        if op not in _KINDS:
            raise ValueError(f"collective {name} has no HLO kind")
        per_kind[_KINDS[op]] += int(nbytes)
        count += 1
    return sum(per_kind.values()), per_kind, count


def _tensors(tree):
    """Every tensor of a nested tree of containers (c10d lists too)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    """At-rest bytes of a tree's tensors: a DTensor's local shard."""
    return sum(local_shard(t).numel() * t.element_size() for t in _tensors(tree))


def _card_workspace(func, args) -> int:
    """Bytes that an op's CUDA kernel allocates inside the op, where no
    dispatch mode sees them, for an op on ``meta`` tensors (the count
    stands for the card).  Measured on an H100 op by op (the peak
    allocated during the op, less what was allocated before it and its
    outputs): ``logsumexp`` holds an array of its input's size (the
    shifted exponentials); ``_softmax_backward_data`` with a
    non-contiguous ``grad_output`` (the attention's, from the product
    after it) holds two arrays of its size (a contiguous copy of it,
    and a contiguous result copied into the strided one)."""
    aten = torch.ops.aten
    x = args[0] if args else None
    if not isinstance(x, torch.Tensor) or not x.is_meta:
        return 0
    if func is aten.logsumexp.default:
        return x.numel() * x.element_size()
    if func is aten._softmax_backward_data.default and \
            not x.is_contiguous():
        return 2 * x.numel() * x.element_size()
    return 0


class _Counter(TorchDispatchMode):
    """Adds up each aten op's operand bytes and records each
    collective's result bytes.  A DTensor op returns NotImplemented, so
    DTensor runs it as local ops, which are counted (as ``MemTracker``
    does)."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        super().__init__()
        self._dtensor = DTensor
        self.bytes = 0
        self.collectives = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is self._dtensor for t in types):
            return NotImplemented
        ws = _card_workspace(func, args)
        # held over the op, where MemTracker (below) sees it
        hold = (torch.empty(ws, dtype=torch.uint8, device="meta")
                if ws else None)
        out = func(*args, **(kwargs or {}))
        del hold
        ns, op = func.namespace, func._opname
        if ns in _COMM_NAMESPACES:
            if op not in _NOT_COLLECTIVES:
                written = args[0] if ns == "c10d" else out
                self.collectives.append((f"{ns}.{op}", _nbytes(written)))
        elif not (func.is_view or op in _METADATA_OPS):
            self.bytes += (_nbytes(list(args))
                           + _nbytes(list((kwargs or {}).values()))
                           + _nbytes(out))
        return out


def count_step(step, args) -> dict:
    """Run ``step(*args)`` once under the counting modes and return the
    record's count fields (see the module doc).  ``build_step``'s
    ``step.donate_argnums`` names the arguments the step writes back in
    place and ``step.fresh(out)`` the new part of its result (any other
    callable: none, and all of it).  The peak is that of the first
    argument's device."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    donate = getattr(step, "donate_argnums", ())
    fresh = getattr(step, "fresh", lambda out: out)
    flat = _tensors(list(args))
    dev = local_shard(flat[0]).device if flat else torch.device("meta")
    tracker = MemTracker()
    tracker.track_external(*[local_shard(t) for t in flat])
    counter = _Counter()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, tracker, counter:
        out = step(*args)
    count_s = time.perf_counter() - t0
    peak = int(tracker.get_tracker_snapshot("peak").get(dev, {}).get(
        "Total", 0))
    arg_bytes = _nbytes(list(args))
    alias = _nbytes([args[i] for i in donate])
    cbytes, per_kind, n_coll = collective_bytes(counter.collectives)
    return {
        "count_s": count_s,
        "flops_per_device": float(flops.get_total_flops()),
        "bytes_per_device": float(counter.bytes),
        "collective_bytes_per_device": int(cbytes),
        "collective_ops": n_coll,
        "collectives": per_kind,
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": alias + _nbytes(fresh(out)),
        "alias_size_in_bytes": alias,
        "temp_size_in_bytes": peak - arg_bytes,
        "peak_bytes": peak,
        "fits": peak <= roofline.HBM_BYTES,
    }


def _mesh_sizes(mesh) -> dict:
    return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))


def _data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _batch_dim(leaf, mesh, shape):
    """The reference's batch dim of a cache leaf: the first dim equal to
    the global batch, when the data axes divide it."""
    sizes = _mesh_sizes(mesh)
    data_size = int(np.prod([sizes[a] for a in _data_axes(mesh)]))
    if shape.global_batch % data_size or \
            shape.global_batch not in tuple(leaf.shape):
        return None
    return tuple(leaf.shape).index(shape.global_batch)


def _cache_len(cfg, shape) -> int:
    """KV capacity: +frontend tokens for multimodal prefill (vlm)."""
    extra = cfg.n_frontend_tokens if cfg.arch == "vlm" else 0
    return shape.seq_len + extra


def _cache_shardings(acache, mesh, cfg, shape, kv_shard: str = "heads"):
    """KV/state caches: batch -> data axes, heads -> model.

    long_500k (batch=1) shards the KV sequence over 'data' instead: the
    reference decides that by ``len(jax.devices())``, 512 in every
    cell of its dry run, and so does this.  ``kv_shard='seq'`` shards
    the cache's sequence dim over the model axis instead of heads.
    Returns a tree of ``dist.partitioning.Sharding`` records.
    """
    axes_avail = set(mesh.mesh_dim_names)
    sizes = _mesh_sizes(mesh)
    data_axes = _data_axes(mesh)
    data_size = int(np.prod([sizes[a] for a in data_axes]))
    model_size = sizes.get("model", 1)
    long_ctx = shape.global_batch < 512 // 16

    def one(leaf):
        nd = len(leaf.shape)
        spec = [None] * nd
        bdim = _batch_dim(leaf, mesh, shape)
        if bdim is not None:
            spec[bdim] = data_axes
        cache_len = _cache_len(cfg, shape)
        if kv_shard == "seq" and cache_len in leaf.shape \
                and "model" in axes_avail and cache_len % model_size == 0:
            tdim = tuple(leaf.shape).index(cache_len)
            spec[tdim] = "model"
        else:
            # heads dim: shard over model when divisible
            for d in range(nd):
                if spec[d] is None and d != bdim and leaf.shape[d] in (
                        cfg.n_kv, cfg.n_heads) and "model" in axes_avail \
                        and leaf.shape[d] % model_size == 0:
                    spec[d] = "model"
                    break
        if long_ctx and cache_len in leaf.shape:
            tdim = tuple(leaf.shape).index(cache_len)
            if spec[tdim] is None and cache_len % data_size == 0:
                spec[tdim] = data_axes
        return Sharding(mesh, PS(*spec))

    return tree_map(one, acache)


def _kv_seq(acache, cshard, mesh, shape):
    """The batch axes that split a cache dim other than its batch dim
    under ``cshard``: the long-context rule's KV sequence (the
    ``kv_seq`` of ``TensorParallel``)."""
    return tuple(a for a in _data_axes(mesh) if any(
        a in _spec_axes(e) for t, s in zip(leaves(acache), leaves(cshard))
        for d, e in enumerate(s.spec) if d != _batch_dim(t, mesh, shape)))


def _rows(t, sharding):
    """The rank's rows of a whole batch tensor under its sharding."""
    return place(t, sharding.mesh, sharding.placements).to_local()


def _drawn_batch(model, shape, device, seed):
    """``input_specs(shape)`` as meta tensors, or drawn on ``device``
    (token ids below ``vocab``, embeddings standard normal)."""
    if device.type == "meta":
        return model.input_specs(shape)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    return {k: v.to(device) for k, v in
            model.input_sample(shape, g, "cpu").items()}


def _trainer(model, constrain, device):
    from ..train.train_loop import TrainConfig, Trainer
    # the step writes no checkpoint: the manager's directory is removed
    # as soon as it is made
    tmp = tempfile.mkdtemp(prefix="repro_dryrun_")
    try:
        return Trainer(model, TrainConfig(ckpt_dir=tmp), None,
                       constrain=constrain, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_step(model, shape, mesh, seq_axis=None, kv_shard="heads", *,
               device="meta", seed: int = 0):
    """Returns ``(step_fn, args)``: ``step_fn(*args)`` runs one step of
    ``shape`` as one rank of ``mesh`` (see the module doc).
    ``step_fn.donate_argnums`` names the arguments it writes in place,
    ``step_fn.fresh(out)`` its new results and ``step_fn.design`` the
    design it runs ("tensor-parallel" or "gather-at-use"; None without a
    mesh).

    ``mesh=None``: the one-process step over every row of ``shape``.
    ``device``: ``meta`` (the abstract state) or a device, where the
    state is drawn from ``seed`` (random params, zero optimizer state
    and caches, random tokens; alike on every rank, each keeping its
    shard)."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = model.cfg
    dev = torch.device(device)
    abstract = dev.type == "meta"
    constrain = (None if mesh is None else
                 activation_constrainer(mesh, fsdp=cfg.fsdp,
                                        seq_axis=seq_axis))
    batch = _drawn_batch(model, shape, dev, seed)
    if mesh is not None:
        bshard = input_shardings(batch, mesh)
        batch = {k: _rows(v, bshard[k]) for k, v in batch.items()}

    if shape.kind == "train":
        tr = _trainer(model, constrain, dev)
        if abstract:
            aparams = model.abstract_params()
            opt_init, _ = OPTIMIZERS[cfg.optimizer]
            residual = (residual_init(aparams, abstract=True)
                        if tr.cfg.grad_compress else
                        tree_map(lambda p: torch.zeros(
                            (), dtype=torch.float32, device="meta"),
                            aparams))
            state = {"params": aparams,
                     "opt": opt_init(aparams, abstract=True),
                     "residual": residual}
            if mesh is not None:
                state = tr.shard_state(state)
        else:   # drawn alike on every rank, then each keeps its shard
            state = tr.init_state(seed)
        batch = {k: v.long() for k, v in batch.items()}   # device_batch's

        def train_step(state, batch):
            return tr.train_step(state, batch)

        train_step.donate_argnums = (0,)
        train_step.fresh = lambda out: out
        train_step.design = tr.design
        return train_step, (state, batch)

    cache_len = _cache_len(cfg, shape)
    if abstract:
        params = model.abstract_params()
        cache = model.cache_specs(shape.global_batch, cache_len)
    else:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed), dev)
        cache = model.init_caches(shape.global_batch, cache_len, device=dev)

    design = None
    if mesh is None:
        def whole(tree):
            return tree

        def use(tree):
            return tree
    elif model.tensor_parallel and kv_shard == "heads":
        design = "tensor-parallel"
        pshard = param_shardings(model.logical_axes(), mesh, fsdp=cfg.fsdp,
                                 abstract_tree=params)
        cshard = _cache_shardings(cache, mesh, cfg, shape, kv_shard)
        constrain = TensorParallel(mesh, tree_map(lambda s: s.spec, pshard),
                                   _kv_seq(cache, cshard, mesh, shape))
        params = tree_map(lambda t, s: place(t, mesh, s.placements),
                          params, pshard)
        cache = tree_map(lambda t, s: place(t, mesh, s.placements),
                         cache, cshard)

        def whole(tree):   # the rank's own shards
            return tree_map(local_shard, tree)

        use = whole
    else:
        design = "gather-at-use"
        pshard = param_shardings(model.logical_axes(), mesh, fsdp=cfg.fsdp,
                                 abstract_tree=params)
        params = tree_map(lambda t, s: place(t, mesh, s.placements),
                          params, pshard)
        cshard = _cache_shardings(cache, mesh, cfg, shape, kv_shard)
        # each cache leaf gathered whole along every dim but the batch
        use_pl = [tuple(
            p if isinstance(p, Shard) and p.dim == _batch_dim(t, mesh, shape)
            else Replicate() for p in s.placements)
            for t, s in zip(leaves(cache), leaves(cshard))]
        cache = tree_map(lambda t, s: place(t, mesh, s.placements),
                         cache, cshard)

        def whole(tree):
            return tree_map(lambda t: t.full_tensor(), tree)

        def use(tree):
            return unflatten(tree, [
                t.redistribute(mesh, pl).to_local()
                for t, pl in zip(leaves(tree), use_pl)])

    if shape.kind == "prefill":
        if model.prefill_fn is not None:
            def prefill_step(params, batch, cache):
                return model.prefill_fn(whole(params), batch, use(cache),
                                        constrain)
        else:  # enc-dec / recurrent: prefill == loss-less forward; reuse loss
            def prefill_step(params, batch, cache):
                batch = dict(batch)
                batch["labels"] = batch["tokens"]
                return model.loss_fn(whole(params), batch, constrain), cache
        prefill_step.donate_argnums = (2,)
        prefill_step.fresh = lambda out: out[0]
        prefill_step.design = design
        return prefill_step, (params, batch, cache)

    # decode: one new token against a cache_len KV cache, at its last
    # slot (every key attended)
    def serve_step(params, batch, cache, idx):
        return model.decode_fn(whole(params), batch, use(cache), idx,
                               constrain)

    serve_step.donate_argnums = (2,)
    serve_step.fresh = lambda out: out[0]
    serve_step.design = design
    return serve_step, (params, batch, cache, cache_len - 1)


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake``-backend default process group of ``world`` ranks, this
    process its last rank; destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             seq_axis=None, tag: str = "baseline", skip_existing: bool = False,
             scan_layers: bool = False, layers: int = 0,
             kv_shard: str = "heads", moe_impl: str = "gspmd",
             no_fsdp: bool = False):
    import torch.distributed as dist
    cfg = ARCHS[arch]
    # recorded only: the eager port runs every layer (module doc)
    cfg = dataclasses.replace(cfg, scan_layers=scan_layers)
    if layers:  # reduced-depth probe for per-layer cost extrapolation
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if no_fsdp:
        cfg = dataclasses.replace(cfg, fsdp=False)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (
        f"__{tag}" if tag != "baseline" else "")
    out_path = os.path.join(out_dir, cell_id + ".json")
    os.makedirs(out_dir, exist_ok=True)
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "n/a"):
            print(f"[dryrun] {cell_id}: cached ({rec['status']})")
            return rec

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
           "status": "n/a", "layers_used": layers or ARCHS[arch].n_layers,
           "scan_layers": scan_layers}
    if not applicable(cfg, shape):
        rec["reason"] = "long_500k requires sub-quadratic attention (DESIGN.md §4)"
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {cell_id}: N/A by design")
        return rec

    model = build_model(cfg)
    world = 512 if multi_pod else 256
    group = (fake_group(world) if not dist.is_initialized()
             else contextlib.nullcontext())
    try:
        with group:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            step, args = build_step(model, shape, mesh, seq_axis=seq_axis,
                                    kv_shard=kv_shard)
            counts = count_step(step, args)
            rec.update(
                status="ok",
                design=step.design,
                n_devices=int(mesh.size()),
                params=model.param_count(),
                active_params=model.active_param_count(),
                **counts,
            )
            del step, args
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {cell_id}: FAILED {type(e).__name__}: {e}")

    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] == "ok":
        print(f"[dryrun] {cell_id}: ok  flops/dev={rec['flops_per_device']:.3e}"
              f" bytes/dev={rec['bytes_per_device']:.3e}"
              f" coll/dev={rec['collective_bytes_per_device']:.3e}"
              f" peak={rec['peak_bytes']:.3e} fits={rec['fits']}"
              f" (count {rec['count_s']:.1f}s)")
    return rec


def table(records) -> str:
    """Markdown, one row per (arch, shape) with each mesh's value
    (pod16x16 / pod2x16x16): argument and peak GB, ``fits``, TFLOP,
    collective GB, the three roofline terms (``roofline.analyze_cell``
    at its constants), the dominant term and useful %."""
    cols = ("arg GB", "peak GB", "fits", "TFLOP", "coll GB", "compute s",
            "memory s", "collective s", "dominant", "useful %")

    def fields(r):
        if r.get("status") != "ok":
            return [r.get("status")] * len(cols)
        c = roofline.analyze_cell(r)
        return [f"{r['argument_size_in_bytes'] / 1e9:.2f}",
                f"{r['peak_bytes'] / 1e9:.1f}",
                "yes" if r["fits"] else "no",
                f"{r['flops_per_device'] / 1e12:.1f}",
                f"{r['collective_bytes_per_device'] / 1e9:.2f}",
                f"{c['t_compute_s']:.3g}", f"{c['t_memory_s']:.3g}",
                f"{c['t_collective_s']:.3g}", c["dominant"],
                f"{100 * c['useful_compute_ratio']:.2f}"]

    cells = {}
    for r in records:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    out = ["| arch | shape | " + " | ".join(cols) + " |",
           "|---|---|" + "---|" * len(cols)]
    for (arch, shape), by_mesh in sorted(cells.items()):
        per = [fields(by_mesh[m]) for m in ("pod16x16", "pod2x16x16")
               if m in by_mesh]
        vals = [" / ".join(dict.fromkeys(v)) if len(set(v)) == 1
                else " / ".join(v) for v in zip(*per)]
        out.append(f"| {arch} | {shape} | " + " | ".join(vals) + " |")
    return "\n".join(out) + "\n"


def load_records(d: str, tag: str = "baseline"):
    out = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            rec = json.load(f)
        if rec.get("tag") == tag:
            out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--seq-axis", default=None,
                    help="mesh axis to shard activations' seq dim over")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--scan-layers", action="store_true",
                    help="recorded only: the eager port runs every layer")
    ap.add_argument("--layers", type=int, default=0,
                    help="override layer count (reduced-depth cost probe)")
    ap.add_argument("--kv-shard", choices=["heads", "seq"], default="heads",
                    help="decode cache sharding: heads (baseline) or seq "
                         "(context-parallel)")
    ap.add_argument("--moe-impl", choices=["gspmd", "ep"], default="gspmd",
                    help="MoE dispatch: plain index-scatter (baseline) or "
                         "expert parallelism over 'model' (all_to_all)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="disable FSDP param sharding")
    ap.add_argument("--table", default=None, metavar="DIR",
                    help="print the cells table of DIR's records and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(load_records(args.table, args.tag)))
        return 0

    cells = []
    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failed = 0
    t0 = time.perf_counter()
    # one fake group a mesh: a mesh covers the whole group
    for mp in meshes:
        with fake_group(512 if mp else 256):
            for a in archs:
                for s in shapes:
                    rec = run_cell(a, s, mp, args.out, seq_axis=args.seq_axis,
                                   tag=args.tag,
                                   skip_existing=args.skip_existing,
                                   scan_layers=args.scan_layers,
                                   layers=args.layers, kv_shard=args.kv_shard,
                                   moe_impl=args.moe_impl,
                                   no_fsdp=args.no_fsdp)
                    cells.append(rec)
                    failed += rec["status"] == "error"
    if len(cells) > 1:
        print(table(cells))
    print(f"[dryrun] {len(cells)} cells, {failed} failures, "
          f"{time.perf_counter() - t0:.1f}s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
