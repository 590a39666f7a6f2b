"""Atomic, async array checkpoints in the reference's on-disk layout,
without JAX.

Layout (``repro.train.checkpoint.CheckpointManager``'s): ``<dir>/
step_<k:08d>/`` with one fsynced ``<leaf>.npy`` per leaf and a
``manifest.json`` holding ``step``, ``leaves``, ``dtypes``, ``treedef``
and ``extra``.  A save writes ``step_<k>.tmp`` and renames it only
after every file is fsynced, so a torn write never shadows the newest
good checkpoint; ``keep`` bounds the published steps.  ``save_async``
runs the write in a daemon thread, at most one in flight.

The state is a tree (``repro_torch.tree``) of dicts, sequences and
NamedTuples over tensors or numpy arrays.  Its leaves are listed in the
order JAX flattens it (sorted keys at every level, not the sorted
joined names: xLSTM's ``b1``, ``b10``, ``b11`` sort differently the two
ways) and named as the reference's ``_leafname`` names them, the path's
keys joined by ``__`` (``params__layers__attn__wq``).  The reference
restores a checkpoint by unflattening the listed arrays against a
template in that order, so both packages restore each other's files.
A flat dict of arrays (the index snapshots) is the one-level case.

* bf16 leaves are written as the reference writes them: numpy stores an
  ``ml_dtypes.bfloat16`` array with the descriptor ``'<V2'`` and the
  manifest names ``"bfloat16"``; the port writes the tensor's bits
  under that header (through a 16-bit integer view: the card's machine
  has no ``ml_dtypes``) and reads a ``V2`` leaf back the same way.
* ``treedef`` is written as an empty string: the reference serializes
  JAX's tree structure there, which cannot be built without JAX, and
  restores trainer and index checkpoints against a template instead.
* ``restore(template=...)`` unflattens against the template (the leaf
  names must be the template's) and puts each leaf on the device of the
  template's leaf; without a template it returns the flat dict of
  listed names to numpy arrays (bf16 leaves as bf16 tensors).

Restore is mesh-agnostic, as the reference's: the files hold whole
host-format leaves, and the target placement is derived, not stored.
A state sharded over a ``torch.distributed`` mesh (DTensor leaves, one
process a rank) is saved by gathering every DTensor leaf on every rank
(a collective, so every rank calls ``save`` / ``save_async`` at the
same step) and writing on global rank 0 alone; the other ranks wait at
a barrier until the synchronous ``save`` has published.  On restore
every rank reads the whole leaves and keeps its own shard: of the
template's leaf where that is a DTensor (its mesh and placements), or
of ``shardings`` (a tree of ``dist.partitioning.Sharding`` records
shaped like the restored state), as ``elastic.elastic_restore`` does
onto a mesh of another shape.  The bytes on disk are the same either
way.  Every rank reads the directory rank 0 wrote, so under a mesh it
must lie on a filesystem every rank can read.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import leaf_paths, leaves, tree_map, unflatten

__all__ = ["CheckpointManager"]

_BF16_DESCR = "<V2"


def _leafname(path) -> str:
    return "__".join(str(k) for k in path) or "root"


def _is_dtensor(leaf) -> bool:
    if not torch.is_tensor(leaf):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _host(leaf, copy: bool = False):
    """A leaf on the host: a CPU tensor or a numpy array (a copy when
    ``copy``, else host data as it is).  A DTensor is gathered whole
    first (a collective)."""
    if _is_dtensor(leaf):
        return leaf.detach().full_tensor().to("cpu")
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=copy)
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _write_leaf(f, leaf) -> str:
    """Write one leaf as a ``.npy``; returns its manifest dtype."""
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        bits = leaf.contiguous().view(torch.int16).numpy()
        header = np.lib.format.header_data_from_array_1_0(bits)
        header["descr"] = _BF16_DESCR
        np.lib.format.write_array_header_1_0(f, header)
        f.write(memoryview(bits).cast("B"))
        return "bfloat16"
    arr = leaf.numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    np.save(f, arr)
    return str(arr.dtype)


def _sharded_writer(state) -> Optional[bool]:
    """None for a state without DTensor leaves; else whether this rank
    writes it (global rank 0)."""
    if not any(_is_dtensor(leaf) for leaf in leaves(state)):
        return None
    import torch.distributed as dist
    return dist.get_rank() == 0


def _placed(t, mesh, placements):
    """``t`` (a whole leaf) as this rank's shard on ``mesh``."""
    from ..dist.partitioning import place
    return place(t.to(mesh.device_type), mesh, placements)


def _read_leaf(path: str, dtype: Optional[str]):
    arr = np.load(path)
    if arr.dtype.kind == "V" and dtype is not None:
        if dtype != "bfloat16":
            raise ValueError(f"{path}: raw {arr.dtype} leaf of dtype {dtype}")
        return torch.from_numpy(
            arr.view(np.int16).copy()).view(torch.bfloat16)
    return arr


class CheckpointManager:
    """Save, list, restore and garbage-collect checkpoints of a tree of
    arrays under ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Any, extra: Optional[Dict] = None) -> str:
        """Publish ``state`` as ``step_<step>``; returns its directory.
        A sharded state is gathered on every rank and written by rank 0
        (see the module doc)."""
        final = os.path.join(self.directory, f"step_{step:08d}")
        writer = _sharded_writer(state)
        if writer is not None:
            import torch.distributed as dist
            host = unflatten(state, [_host(leaf) for leaf in leaves(state)])
            if writer:
                self.save(step, host, extra)
            dist.barrier()
            return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        names = []
        dtypes = []
        for path, leaf in leaf_paths(state):
            name = _leafname(path)
            names.append(name)
            with open(os.path.join(tmp, name + ".npy"), "wb") as f:
                dtypes.append(_write_leaf(f, _host(leaf)))
                f.flush()
                os.fsync(f.fileno())
        manifest = {
            "step": step,
            "leaves": names,
            "dtypes": dtypes,
            "treedef": "",
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def save_async(self, step: int, state: Any, extra: Optional[Dict] = None):
        """Backpressured async save: waits for any in-flight save, copies
        every leaf to the host now (the trainer updates its tensors in
        place), then writes in a daemon thread."""
        self.wait()
        writer = _sharded_writer(state)
        snapshot = unflatten(state, [_host(leaf, copy=True)
                                     for leaf in leaves(state)])
        if writer is False:
            return
        self._thread = threading.Thread(
            target=self.save, args=(step, snapshot, extra), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, shardings: Any = None,
                template: Any = None) -> Tuple[Any, Dict]:
        """``(state, extra)`` of ``step`` (the newest when None).  With a
        ``template``: a tree of its shape, each leaf a tensor of the
        file's dtype on the device of the template's leaf (this rank's
        shard where the template's leaf is a DTensor).  Without: the
        listed names mapped to their arrays.  ``shardings``: a tree of
        ``Sharding`` records shaped like the result; each leaf becomes
        this rank's shard of it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        names = manifest["leaves"]
        dtypes = manifest.get("dtypes", [None] * len(names))
        if template is None:
            state = {n: _read_leaf(os.path.join(d, n + ".npy"), dt)
                     for n, dt in zip(names, dtypes)}
            if shardings is not None:
                state = tree_map(lambda a, s: _placed(
                    a if torch.is_tensor(a) else torch.from_numpy(a),
                    s.mesh, s.placements), state, shardings)
            return state, manifest["extra"]
        tpaths = leaf_paths(template)
        want = [_leafname(p) for p, _ in tpaths]
        if want != names:
            raise ValueError(f"checkpoint {d} lists other leaves than the "
                             f"template: {sorted(set(names) ^ set(want))[:5]}")
        out = []
        for (_, tleaf), n, dt in zip(tpaths, names, dtypes):
            arr = _read_leaf(os.path.join(d, n + ".npy"), dt)
            t = arr if torch.is_tensor(arr) else torch.from_numpy(arr)
            if _is_dtensor(tleaf):
                out.append(_placed(t, tleaf.device_mesh, tleaf.placements))
                continue
            dev = tleaf.device if torch.is_tensor(tleaf) else "cpu"
            out.append(t.to(dev))
        state = unflatten(template, out)
        if shardings is not None:
            state = tree_map(lambda a, s: _placed(a, s.mesh, s.placements),
                             state, shardings)
        return state, manifest["extra"]

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))
