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

Tensor parallelism (``TensorParallel``): the step that computes on each
rank's own shards, as GSPMD runs the reference's jitted step.  Params
sharded over "model" stay sharded during compute (Megatron's column- and
row-parallel products); a leaf sharded over "data" (FSDP's "embed") is
gathered over "data" where it is used, one layer at a time.  Every
model family runs it.  ``torch.autograd.Function``s carry the
collectives, each the adjoint of the other's direction:

* ``copy``: identity forward, the grad summed over "model" backward.
  Whatever is replicated over "model" and enters a product that each
  rank computes a part of (the norm's output before the column-parallel
  products, a replicated weight used inside such a product) passes
  through it, so its grad is the whole on every rank;
* ``reduce``: the sum over "model" forward, identity backward: the
  row-parallel product's partial output, summed *before* the residual
  add (after it, the replicated ``x`` would be summed once a rank);
* ``gather``: ``all_gather`` along a dim forward, ``reduce_scatter`` of
  the grad backward: an FSDP leaf over "data", or a "model"-sharded
  leaf (or activation) whose whole each rank uses a part of (the MoE
  router, the mLSTM's up-projection before its per-head cell).

Two more carry an activation between a split product and compute that
every rank runs alike on the whole (the xLSTM blocks whose heads the
divisibility guard keeps whole):

* ``whole``: ``all_gather`` along a dim forward, the rank's slice of
  the grad backward.  Every rank computes the same thing on the whole,
  so each holds the whole grad, and its shard's is a slice of it (a
  ``reduce_scatter`` would count it ``model.size`` times);
* ``split``: the rank's slice along a dim forward, ``all_gather`` of
  the grad backward: a replicated activation that enters a row-parallel
  product (each rank's rows of the weight take its slice).

An axis of size one splits nothing: every helper is then the identity
and the layers take their plain paths.
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
    "TensorParallel",
    "local_shard",
    "layer_specs",
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
    out = full.redistribute(mesh, tuple(placements))
    local = out._local_tensor
    if local.numel() < t.numel():
        # a chunk along dim 0 is a view that keeps all of ``t`` alive:
        # the shard gets storage of its own
        out = DTensor.from_local(local.clone(), mesh, out.placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


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


def local_shard(t):
    """A DTensor's local shard (a plain tensor sharing its storage); any
    other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# tensor parallelism: each rank computes on its own shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One mesh axis as a process group: its name, group, size and this
    rank's coordinate on it."""

    name: str
    group: object
    size: int
    rank: int


# The functional collectives: ``gloo``'s in-place ``reduce_scatter_tensor``
# copies its result out of a buffer after the op, which a dispatch mode
# would count as the step's own traffic (nccl's and the ``fake`` group's
# do not); the functional ops look alike on all three.


def _all_gather(x, group, size, dim):
    import torch
    c10d = torch.ops._c10d_functional
    out = c10d.wait_tensor(c10d.all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), size, group.group_name))
    return out.movedim(0, dim)


def _reduce_scatter(g, group, size, dim):
    import torch
    c10d = torch.ops._c10d_functional
    out = c10d.wait_tensor(c10d.reduce_scatter_tensor(
        g.movedim(dim, 0).contiguous(), "sum", size, group.group_name))
    return out.movedim(0, dim)


def _functions():
    """The five autograd Functions (built on first use: importing this
    module imports no torch)."""
    global _FUNCTIONS
    if _FUNCTIONS is not None:
        return _FUNCTIONS
    import torch
    import torch.distributed as dist

    class Copy(torch.autograd.Function):
        """Identity forward; the grad summed over the axis backward."""

        @staticmethod
        def forward(ctx, x, axis):
            ctx.axis = axis
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.axis.group)
            return g, None

    class Reduce(torch.autograd.Function):
        """The sum over the axis forward; identity backward."""

        @staticmethod
        def forward(ctx, x, axis):
            y = x.contiguous().clone()
            dist.all_reduce(y, group=axis.group)
            return y

        @staticmethod
        def backward(ctx, g):
            return g, None

    class Gather(torch.autograd.Function):
        """``all_gather`` along ``dim`` forward; the grad
        ``reduce_scatter``ed back onto the shard backward."""

        @staticmethod
        def forward(ctx, x, axis, dim):
            ctx.axis, ctx.dim = axis, dim
            return _all_gather(x, axis.group, axis.size, dim)

        @staticmethod
        def backward(ctx, g):
            a = ctx.axis
            return _reduce_scatter(g, a.group, a.size, ctx.dim), None, None

    class Whole(torch.autograd.Function):
        """``all_gather`` along ``dim`` forward; the rank's slice of the
        grad backward."""

        @staticmethod
        def forward(ctx, x, axis, dim):
            ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
            return _all_gather(x, axis.group, axis.size, dim)

        @staticmethod
        def backward(ctx, g):
            a = ctx.axis
            return (g.narrow(ctx.dim, a.rank * ctx.n, ctx.n).contiguous(),
                    None, None)

    class Split(torch.autograd.Function):
        """The rank's slice along ``dim`` forward; the grad
        ``all_gather``ed backward."""

        @staticmethod
        def forward(ctx, x, axis, dim):
            ctx.axis, ctx.dim = axis, dim
            n = x.shape[dim] // axis.size
            return x.narrow(dim, axis.rank * n, n).clone(
                memory_format=torch.contiguous_format)

        @staticmethod
        def backward(ctx, g):
            a = ctx.axis
            return _all_gather(g, a.group, a.size, ctx.dim), None, None

    _FUNCTIONS = (Copy, Reduce, Gather, Whole, Split)
    return _FUNCTIONS


_FUNCTIONS = None


def _mesh_axis(mesh, name: str) -> Optional[_Axis]:
    names = _mesh_names(mesh)
    if name not in names:
        return None
    return _Axis(name, mesh.get_group(name), mesh.shape[names.index(name)],
                 mesh.get_local_rank(name))


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class TensorParallel:
    """The ``constrain`` hook of a step that computes on each rank's own
    shards (see the module doc).  The model receives the params as
    local shards (``local_shard``) and ``specs``, the ``PS`` tree of
    ``param_pspecs`` for them, names the dims each is split on.

    As a hook it returns an activation unchanged (each rank holds its
    own activations); ``mesh`` is the mesh and ``tp`` the object itself
    (what a model's layers look for).  ``model`` and ``data`` are the
    two axes as ``_Axis`` records; ``batch`` the axes the batch rows are
    split over, ("pod", "data"), that have more than one rank.
    ``kv_seq`` names the axes, major first, that the sequence dim of the
    KV caches is split over (the long-context rule of the dry run's
    ``_cache_shardings``); attention then runs on the rank's positions
    and combines the softmax over them (``seq_offset``, ``seq_reduce``)."""

    def __init__(self, mesh, specs, kv_seq: Tuple[str, ...] = ()):
        self.mesh = mesh
        self.specs = specs
        self.tp = self
        self.model = _mesh_axis(mesh, "model")
        self.data = _mesh_axis(mesh, "data")
        self.axes = {n: _mesh_axis(mesh, n) for n in _mesh_names(mesh)}
        self.batch = tuple(self.axes[n] for n in _RULES["batch"]
                           if n in self.axes and self.axes[n].size > 1)
        self.kv_seq = tuple(self.axes[n] for n in kv_seq
                            if self.axes[n].size > 1)

    def __call__(self, x, axes):
        return x

    def splits(self, spec, dim: int, axis: str = "model") -> bool:
        """Whether ``spec`` splits ``dim`` over ``axis`` across more
        than one rank."""
        a = self.axes.get(axis)
        return (a is not None and a.size > 1
                and axis in _spec_axes(spec[dim]))

    def split_axes(self, spec, dim: int) -> Tuple[_Axis, ...]:
        """The axes of more than one rank that ``spec`` splits ``dim``
        over."""
        return tuple(self.axes[n] for n in _spec_axes(spec[dim])
                     if self.axes[n].size > 1)

    # -- the collectives ------------------------------------------------
    def copy(self, x):
        """Identity forward, grad summed over "model" backward."""
        if self.model is None or self.model.size == 1:
            return x
        return _functions()[0].apply(x, self.model)

    def reduce(self, x):
        """Sum over "model" forward, identity backward."""
        if self.model is None or self.model.size == 1:
            return x
        return _functions()[1].apply(x, self.model)

    def gather(self, x, axis: _Axis, dim: int):
        """``x`` whole along ``dim`` from its shards over ``axis``."""
        if axis.size == 1:
            return x
        return _functions()[2].apply(x, axis, dim)

    def whole(self, x, dim: int):
        """``x`` whole along ``dim`` from its shards over "model", for
        compute every rank runs alike on it (the grad: the rank's
        slice)."""
        if self.model is None or self.model.size == 1:
            return x
        return _functions()[3].apply(x, self.model, dim)

    def split(self, x, dim: int):
        """This rank's slice along ``dim`` of ``x``, replicated over
        "model" (the grad: all-gathered)."""
        if self.model is None or self.model.size == 1:
            return x
        return _functions()[4].apply(x, self.model, dim)

    def reduce_max(self, x):
        """The max over "model" (no grad)."""
        if self.model is None or self.model.size == 1:
            return x
        import torch.distributed as dist
        x = x.detach().contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.model.group)
        return x

    def seq_offset(self, local_size: int) -> Tuple[int, int]:
        """The global position of this rank's first KV cache entry and
        the cache's whole length, its sequence split over ``kv_seq``."""
        index, size = 0, 1
        for a in self.kv_seq:
            index, size = index * a.size + a.rank, size * a.size
        return index * local_size, size * local_size

    def seq_reduce(self, x, op: str):
        """``x`` reduced (``"max"`` or ``"sum"``) over ``kv_seq`` (no
        grad)."""
        import torch.distributed as dist
        x = x.detach().contiguous().clone()
        for a in self.kv_seq:
            dist.all_reduce(x, op=getattr(dist.ReduceOp, op.upper()),
                            group=a.group)
        return x

    def offset(self, spec, dim: int, local_size: int) -> int:
        """The global index of this rank's first entry along ``dim``
        (0 when ``dim`` is not split over "model")."""
        return (self.model.rank * local_size
                if self.splits(spec, dim) else 0)

    def gather_fsdp(self, tree, specs):
        """Every leaf of ``tree`` that ``specs`` splits over "data"
        gathered whole along that dim (FSDP's gather at use)."""
        if isinstance(tree, dict):
            return {k: self.gather_fsdp(v, specs[k]) for k, v in tree.items()}
        for d in range(len(specs)):
            if self.splits(specs, d, "data"):
                return self.gather(tree, self.data, d)
        return tree


def layer_specs(specs):
    """The ``PS`` tree of one layer of a stacked ``(L, ...)`` tree: each
    spec without its first ("layers") entry."""
    if isinstance(specs, dict):
        return {k: layer_specs(v) for k, v in specs.items()}
    return PS(*specs[1:])
