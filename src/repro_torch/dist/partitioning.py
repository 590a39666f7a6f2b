"""Rule-based logical-axis -> mesh-axis partitioning: the counterpart of
``repro.dist.partitioning`` over ``torch.distributed`` (the single
place sharding policy lives; see models/base.py for the logical
vocabulary).

Every parameter / activation carries a tuple of logical axis names;
``pspec_for_axes`` maps that tuple onto whatever mesh is alive by the
reference's three rules, applied left to right:

1. **Vocabulary**: "vocab"/"heads"/"kv"/"ffn"/"experts" want the "model"
   axis; "batch" wants ("pod", "data"); "embed" wants nothing (or "data"
   under FSDP); everything else (including None) is replicated.
2. **Claim once**: each mesh axis is assigned to at most one tensor dim
   (first claimant wins).
3. **Divisibility guard**: a dim is only sharded if its size divides by
   the product of the claimed mesh axis sizes; otherwise it is
   replicated.

The rules are pure Python.  ``PS`` stands in for JAX's
``PartitionSpec``, which is itself a tuple: one entry per tensor dim,
None, a mesh axis name or a tuple of names.  A mesh is a
``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names``, ``shape``)
or the reference tests' duck-typed stand-in (``axis_names``,
``devices.shape``); the rules read only the axis sizes, so no device is
needed.

``param_shardings`` / ``input_shardings`` wrap the specs into
``Sharding`` records (the ``NamedSharding`` counterpart): a mesh and a
spec, with ``placements``, one ``Shard(d)`` or ``Replicate()`` of
``torch.distributed.tensor`` per mesh dim.  A spec entry that names
several mesh axes, as ("pod", "data") for "batch", gives ``Shard(d)`` on
each of them, major axis first, as JAX lays the shards out.
``place`` puts a whole tensor onto its shard of a mesh's placements
(a DTensor) without communication.  ``activation_constrainer`` closes over
a mesh and returns the ``constrain(x, axes)`` hook threaded through
every model forward: a DTensor is redistributed to the spec of its
shape, a plain tensor passes unchanged, and ``constrain.mesh`` is the
mesh (the LM's expert-parallel MoE reads it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "pspec_for_axes",
    "param_pspecs",
    "param_shardings",
    "input_shardings",
    "activation_constrainer",
    "PS",
    "Sharding",
    "place",
    "batch_shard",
]

# logical axis -> preferred mesh axes, in priority order
_RULES = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "batch": ("pod", "data"),
}
_FSDP_RULES = {"embed": ("data",)}


class PS(tuple):
    """``PartitionSpec`` stand-in: ``PS(None, "model")`` is the tuple
    ``(None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PS" + tuple.__repr__(self)


def _mesh_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def _mesh_sizes(mesh) -> dict:
    """axis name -> size, for a ``DeviceMesh`` and for stand-ins
    exposing ``axis_names`` + ``devices.shape`` (tests)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))


def pspec_for_axes(
    axes: Tuple[Optional[str], ...],
    mesh,
    *,
    fsdp: bool = False,
    shape: Optional[Tuple[int, ...]] = None,
    seq_axis: Optional[str] = None,
) -> PS:
    """Map one logical-axes tuple to a ``PS`` under ``mesh``.

    ``shape`` (optional) enables the divisibility guard per dim.
    ``seq_axis`` names a mesh axis for sequence parallelism: a None
    logical entry directly after "batch" is sharded over it.
    """
    sizes = _mesh_sizes(mesh)
    claimed = set()
    out = []
    for d, name in enumerate(axes):
        want = _RULES.get(name, ())
        if fsdp and not want:
            want = _FSDP_RULES.get(name, ())
        if (name is None and seq_axis is not None and d > 0
                and axes[d - 1] == "batch"):
            want = (seq_axis,)
        picked = tuple(
            a for a in want if a in sizes and a not in claimed
        )
        if picked and shape is not None:
            total = 1
            for a in picked:
                total *= sizes[a]
            if total > 1 and shape[d] % total:
                picked = ()
        claimed.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return PS(*out)


def _map_axes_tree(fn, tree, *rest):
    """``fn(axes, *leaves of rest)`` over a nested dict whose leaves are
    logical-axes tuples (the params' tree shape)."""
    if isinstance(tree, dict):
        return {k: _map_axes_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def param_pspecs(laxes_tree, mesh, *, fsdp: bool = False,
                 abstract_tree=None):
    """Tree of ``PS`` mirroring a logical-axes tree.

    ``abstract_tree`` (meta tensors or anything with ``.shape``, same
    structure) turns on the divisibility guard.
    """
    if abstract_tree is None:
        return _map_axes_tree(
            lambda ax: pspec_for_axes(ax, mesh, fsdp=fsdp), laxes_tree)
    return _map_axes_tree(
        lambda ax, sds: pspec_for_axes(ax, mesh, fsdp=fsdp,
                                       shape=tuple(sds.shape)),
        laxes_tree, abstract_tree)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a ``PS`` (the ``NamedSharding`` counterpart)."""

    mesh: object
    spec: PS

    @property
    def placements(self) -> tuple:
        """One ``Shard(d)`` / ``Replicate()`` per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        names = _mesh_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                out[names.index(a)] = Shard(d)
        return tuple(out)


def param_shardings(laxes_tree, mesh, *, fsdp: bool = False,
                    abstract_tree=None):
    """Like ``param_pspecs`` but wrapped into ``Sharding`` records."""
    specs = param_pspecs(laxes_tree, mesh, fsdp=fsdp,
                         abstract_tree=abstract_tree)
    return _map_axes_tree(lambda ps: Sharding(mesh, ps), specs)


def input_shardings(abstract_inputs, mesh):
    """Batch-shard input specs: dim 0 over ("pod","data") when divisible,
    everything else replicated.  ``abstract_inputs``: a dict of meta
    tensors (``Model.input_specs``) or anything with ``.shape``."""
    def one(sds):
        axes = ("batch",) + (None,) * (len(sds.shape) - 1)
        return Sharding(mesh, pspec_for_axes(axes, mesh,
                                             shape=tuple(sds.shape)))

    return _map_axes_tree(one, abstract_inputs)


def place(t, mesh, placements):
    """The DTensor over ``mesh`` with ``placements`` (a ``Sharding``'s,
    or another DTensor's) whose global value is ``t``: each rank keeps
    its own shard of its own copy of ``t`` (no communication; every
    rank must hold the same ``t``)."""
    from torch.distributed.tensor import DTensor, Replicate
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, tuple(placements))


def activation_constrainer(mesh, *, fsdp: bool = False,
                           seq_axis: Optional[str] = None):
    """Returns ``constrain(x, logical_axes)``.

    The spec is derived per call from the activation's shape, so the
    divisibility guard composes with elastic meshes for free.  A DTensor
    is redistributed to it; a plain tensor (each rank's own activations)
    is returned unchanged.  ``constrain.mesh`` is ``mesh``.
    """
    def constrain(x, axes):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        ps = pspec_for_axes(tuple(axes), mesh, fsdp=fsdp,
                            shape=tuple(x.shape), seq_axis=seq_axis)
        return x.redistribute(mesh, Sharding(mesh, ps).placements)

    constrain.mesh = mesh
    return constrain


def batch_shard(mesh) -> Tuple[int, int]:
    """``(shard_id, n_shards)`` of this rank's rows of the batch: its
    coordinate over the mesh axes "batch" maps to, ("pod", "data"),
    major first (``data.ShardedLoader``'s ``shard_id`` / ``n_shards``).
    Ranks that differ only on the other axes hold the same rows."""
    names = _mesh_names(mesh)
    coord = mesh.get_coordinate()
    shard_id, n_shards = 0, 1
    for a in _RULES["batch"]:
        if a in names:
            d = names.index(a)
            shard_id = shard_id * mesh.shape[d] + coord[d]
            n_shards *= mesh.shape[d]
    return shard_id, n_shards
