"""Carry a reference index across into the port.

``index_from_state`` takes the leaves that ``repro.core.Index
.save_snapshot`` writes (``keys``, ``slot_key``, ``occupied``,
``payload``, ``offsets``, ``chain_keys``, ``chain_payloads``; meta
``method``, ``n_keys``, ``rho``, ``epoch``, ``gap_rho``,
``sample_rate``).  In place of the snapshot's pickled mechanism it
takes the piecewise linear model as arrays: ``seg_first_key``,
``slope``, ``icept``, ``err_lo``, ``err_hi`` (and optionally meta
``plm_n_keys``, the keys the model was fit on).  The arrays are copied:
the port's index never shares memory with the caller's (a live
reference index can go on being written).

``sharded_from_state`` carries a reference ``ShardedIndex`` across the
same way: the dict its ``save_snapshot`` writes as
``sharded_manifest.json`` (router boundaries, ``lo_key``, the build and
rebalance knobs, the mutation count) and one ``(state, meta)`` pair per
shard in the form ``index_from_state`` takes.

``model_params_from_reference`` carries a reference model's param
tree across (numpy leaves, nested dicts) into the port's tree of
tensors, leaf for leaf; ``train_state_from_reference`` does the same
for a reference trainer state (params, the AdamW or Adafactor slots,
the compression residual).

A snapshot on disk goes through ``Index.restore`` (``ShardedIndex
.restore`` for a sharded one) instead.  Its pickle
names the module of the mechanism's classes, so a stock ``pickle.loads``
of a reference snapshot would import ``repro.core.mechanisms``, and the
reference's of a port snapshot ``repro_torch.core.mechanisms``.  The
port therefore writes its mechanisms under the reference's module name
and reads that name as its own verbatim copy (``core.handle``'s
``_MechPickler`` / ``_MechUnpickler``), so snapshots cross-restore both
ways and each restored mechanism is of the restoring package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.gaps import GappedArray
from .core.handle import Index
from .core.links import CSRLinks
from .core.mechanisms import MECHANISMS, PiecewiseLinearModel
from .device import resolve_device

__all__ = ["index_from_state", "sharded_from_state",
           "model_params_from_reference", "train_state_from_reference",
           "PLM_LEAVES"]

PLM_LEAVES = ("seg_first_key", "slope", "icept", "err_lo", "err_hi")


def index_from_state(state: dict, meta: dict, device=None) -> Index:
    """Build the port's gapped ``Index`` from snapshot leaves + PLM
    arrays, with its device state on ``device`` (cuda by default)."""
    dev = resolve_device(device)
    method = meta["method"]
    if method not in ("pgm", "fiting"):
        raise ValueError(f"method {method!r}: only pgm and fiting predict "
                         "through their piecewise linear model alone")
    keys = np.array(state["keys"], np.float64)
    plm = PiecewiseLinearModel(
        **{f: np.array(state[f], np.float64) for f in PLM_LEAVES},
        n_keys=int(meta.get("plm_n_keys", keys.shape[0])))
    mech = MECHANISMS[method]()
    mech.plm = plm
    slot_key = np.array(state["slot_key"], np.float64)
    gapped = GappedArray(
        slot_key=slot_key,
        occupied=np.array(state["occupied"], bool),
        payload=np.array(state["payload"], np.int64),
        links=CSRLinks(int(slot_key.shape[0]),
                       np.array(state["offsets"], np.int64),
                       np.array(state["chain_keys"], np.float64),
                       np.array(state["chain_payloads"], np.int64)),
        mech=mech,
        n_keys=int(meta["n_keys"]),
        rho=float(meta["rho"]),
        version=int(meta["epoch"]))
    return Index(keys=keys, mech=mech, method=method, gapped=gapped,
                 sample_rate=float(meta["sample_rate"]),
                 gap_rho=float(meta["gap_rho"]), device=dev)


def sharded_from_state(manifest: dict, shard_states, device=None):
    """Build the port's ``ShardedIndex`` from a reference sharded
    manifest and one ``(state, meta)`` pair per shard (each built by
    ``index_from_state``, arrays copied), with every shard's device
    state on ``device`` (cuda by default).  The router refits on the
    manifest's boundaries, as ``ShardedIndex.restore`` does."""
    from .dist.sharded import ShardedIndex
    dev = resolve_device(device)
    shard_states = list(shard_states)
    if len(shard_states) != int(manifest["n_shards"]):
        raise ValueError(f"{len(shard_states)} shard states for a "
                         f"manifest of {manifest['n_shards']} shards")
    shards = [index_from_state(state, meta, device=dev)
              for state, meta in shard_states]
    return ShardedIndex._from_manifest(shards, manifest)


def model_params_from_reference(tree, device=None, dtype=None):
    """The port's param dict for a reference param tree given as numpy
    arrays (nested dicts, the reference's nesting): the same keys and
    shapes, each leaf a copy on ``device`` (cuda unless ``"cpu"``).

    ``dtype=None`` keeps each leaf's dtype, which is its spec dtype: a
    bf16 leaf (numpy's ``bfloat16`` extension dtype, as ``np.asarray``
    gives it for a bf16 JAX array) goes through f32, which is lossless.
    A torch ``dtype`` casts every floating leaf to it."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        elif bf16:
            t = t.to(torch.bfloat16)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def train_state_from_reference(state, device=None, dtype=None):
    """The port's trainer state for a reference ``Trainer`` state given
    as numpy arrays (``{"params", "opt", "residual"}``, nested dicts):
    every leaf a copy on ``device`` (cuda unless ``"cpu"``), in its own
    dtype (bf16 leaves through f32, which is lossless).  ``dtype``, a
    torch float dtype, casts the params alone (the optimizer keeps its
    f32 moments and bf16 momentum, the residual its f32); the 0-d
    ``step`` stays int32."""
    return {
        "params": model_params_from_reference(state["params"], device,
                                              dtype),
        "opt": model_params_from_reference(state["opt"], device),
        "residual": model_params_from_reference(state["residual"], device),
    }
