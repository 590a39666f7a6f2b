"""Mixture-of-Experts FFN: top-k router + capacity-based dispatch.

The counterpart of ``repro.models.moe``.  Two interchangeable
implementations (same math, same params):

* ``moe_gspmd`` — index-scatter dispatch in plain tensor ops;
* ``moe_ep_shardmap`` — explicit expert parallelism over a
  ``torch.distributed`` mesh: each rank of the "model" axis owns
  ``E / ep`` experts and a slice of the sequence, and dispatch and
  combine are one ``all_to_all_single`` pair over the "model" group, as
  the reference's ``shard_map`` does.  The LM takes it when its
  ``constrain`` hook carries a mesh and ``moe_impl="ep"``;
* ``moe_tp`` — either of the two on a rank's shards under tensor
  parallelism (the LM's ``TensorParallel`` hook).

Capacity: each expert accepts at most C = ceil(T*k/E * cf) tokens
(padded to 8); overflow tokens are dropped (contribute zero) like
Switch/GShard.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base import P, einsum

__all__ = ["moe_specs", "moe_gspmd", "moe_ep_shardmap", "moe_tp"]


def moe_specs(d_model: int, d_ff: int, n_experts: int):
    return {
        "router": P((d_model, n_experts), ("embed", "experts"),
                    dtype=torch.float32),
        "w_gate": P((n_experts, d_model, d_ff), ("experts", "embed", "ffn")),
        "w_up": P((n_experts, d_model, d_ff), ("experts", "embed", "ffn")),
        "w_down": P((n_experts, d_ff, d_model), ("experts", "ffn", "embed")),
    }


def _route(params, x2d, top_k: int):
    """Router: top-k expert ids + renormalized weights.  x2d: (T, D).

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk(sorted=True)`` does not promise an order among ties.
    A tie needs two equal softmax probabilities of one token, which
    f32 router logits of real activations do not give."""
    logits = x2d.float() @ params["router"].float()  # (T, E)
    weights, experts = torch.topk(torch.softmax(logits, dim=-1), top_k,
                                  dim=-1, sorted=True)
    weights = weights / torch.clamp(
        torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    return experts, weights.to(x2d.dtype), logits


def _one_hot(ids, n: int):
    """``F.one_hot(ids, n)`` as the card computes it, zeros and then a
    scatter, on every device: on ``meta`` tensors ``F.one_hot`` runs
    other ops, and on the CPU it first reads the ids back to check them,
    so the dry run's count of a step would not be the card's."""
    out = torch.zeros((*ids.shape, n), dtype=torch.long, device=ids.device)
    return out.scatter_(-1, ids.unsqueeze(-1), 1)


def _capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(np.ceil(n_tokens * top_k / n_experts * cf))
    return max(8, ((c + 7) // 8) * 8)  # the reference's padding to 8


def moe_gspmd(params, x, *, top_k: int, capacity_factor: float = 1.25,
              constrain=None):
    """Capacity MoE via scatter dispatch.  x: (B, S, D) -> (B, S, D).
    ``constrain`` is the reference's sharding hook (identity here)."""
    return _capacity_ffn(params["router"],
                         [params[k] for k in _EXPERT_KEYS], x, top_k=top_k,
                         capacity_factor=capacity_factor, constrain=constrain)


_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _capacity_ffn(router, experts, x, *, top_k, capacity_factor, lo=0,
                  constrain=None):
    """``moe_gspmd``'s body: every token of ``x`` routed by ``router``
    (D, E); ``experts`` the (w_gate, w_up, w_down) of experts ``lo ..
    lo + e_l - 1`` (all E of them, or this rank's under tensor
    parallelism: the other experts' tokens are left out of the buffers
    and the output, a partial sum)."""
    if constrain is None:
        constrain = lambda t, axes: t  # noqa: E731
    B, S, D = x.shape
    E = router.shape[1]
    T = B * S
    x2d = x.reshape(T, D)
    experts_ids, weights, _ = _route({"router": router}, x2d, top_k)

    C = _capacity(T, top_k, E, capacity_factor)
    # position of each (token, k) within its expert, by arrival order
    flat = _one_hot(experts_ids, E).reshape(T * top_k, E)  # (T*k, E)
    pos_in_e = torch.cumsum(flat, dim=0) * flat - 1
    pos = torch.amax(pos_in_e, dim=-1)                  # (T*k,)
    e_flat = experts_ids.reshape(T * top_k)
    keep = pos < C
    w_gate, w_up, w_down = experts
    e_l = w_gate.shape[0]
    if e_l < E:   # this rank's experts only
        keep = keep & (e_flat >= lo) & (e_flat < lo + e_l)
        e_flat = torch.clamp(e_flat - lo, 0, e_l - 1)

    # scatter tokens into (E, C, D) buffers; dropped tokens -> row C
    # (every kept (expert, slot) is written once, so the add is exact)
    buf = torch.zeros((e_l, C + 1, D), dtype=x.dtype, device=x.device)
    slot = torch.where(keep, pos, C)
    src = torch.repeat_interleave(x2d, top_k, dim=0)    # (T*k, D)
    buf.index_put_((e_flat, slot), src, accumulate=True)
    buf = constrain(buf, ("experts", None, "embed"))[:, :C, :]

    # expert FFN (swiglu)
    h = F.silu(einsum("ecd,edf->ecf", buf, w_gate))
    h = h * einsum("ecd,edf->ecf", buf, w_up)
    h = constrain(h, ("experts", None, "ffn"))
    out_buf = einsum("ecf,efd->ecd", h, w_down)
    out_buf = constrain(out_buf, ("experts", None, "embed"))

    # combine: gather each (token, k) result, weight, sum over k
    gathered = out_buf[e_flat, torch.clamp(slot, max=C - 1)]  # (T*k, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=x.device))
    gathered = gathered.reshape(T, top_k, D) * weights[..., None]
    return gathered.sum(dim=1).reshape(B, S, D)


def _exchange(t, group):
    import torch.distributed as dist
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """Block p of dim 0 to rank p of ``group``; the blocks received,
    stacked on dim 0 by source rank (the reference's
    ``all_to_all(t, axis, 0, 0, tiled=False)``).  The exchange is its
    own adjoint: the backward sends the grads back the same way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _GatherSeq(torch.autograd.Function):
    """The group's slices concatenated along dim 1 (rank order).  The
    backward keeps this rank's slice of the output grad, first summed
    over the group when ``sum_grads`` (each rank's grad a share of the
    whole: the adjoint of the gather); under tensor parallelism every
    rank holds the whole grad and keeps its slice as it is."""

    @staticmethod
    def forward(ctx, y, group, j, sum_grads):
        import torch.distributed as dist
        ctx.group, ctx.j, ctx.s, ctx.sum = group, j, y.shape[1], sum_grads
        y = y.contiguous()
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        if ctx.sum:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g[:, ctx.j * ctx.s:(ctx.j + 1) * ctx.s], None, None, None


def moe_ep_shardmap(params, x, *, top_k: int, mesh, model_axis: str = "model",
                    capacity_factor: float = 1.25):
    """Explicit expert parallelism over ``mesh``'s ``model_axis``.

    ``x`` (b_l, S, D) is this rank's rows of the batch, the batch as the
    other mesh axes shard it (every rank of a "model" group holds the
    same rows); the output is in that layout too.  Over a mesh whose
    other axes have size 1 that is the whole batch, and the result is
    ``moe_gspmd``'s where no token is dropped (the capacity counts each
    rank's tokens, as in the reference).

    Rank j of the "model" group (size ep) takes sequence slice j
    (S / ep tokens a row), routes it, scatters it into ``(E, C, D)``
    buffers (C from its own token count), sends expert block p to rank p
    (one ``all_to_all_single``), runs its ``E / ep`` experts over the
    rows of every source rank, sends the results back (the second
    exchange) and combines; the group's slices are then gathered along
    the sequence.  The exchanges and the gather are differentiable: the
    gather's backward sums the group's output grads, so each rank's
    grads are its share of the group's and a sum over the ranks gives
    the whole (the trainer's convention, ``train.train_loop``).
    """
    names = tuple(mesh.mesh_dim_names)
    ep = mesh.shape[names.index(model_axis)]
    j = mesh.get_local_rank(model_axis)
    E = params["router"].shape[1]
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} ranks")
    mine = slice(j * (E // ep), (j + 1) * (E // ep))
    return _ep(params["router"], [params[k][mine] for k in _EXPERT_KEYS], x,
               top_k=top_k, capacity_factor=capacity_factor,
               group=mesh.get_group(model_axis), ep=ep, j=j, sum_grads=True)


def _ep(router, experts, x, *, top_k, capacity_factor, group, ep, j,
        sum_grads):
    """``moe_ep_shardmap``'s exchange: ``router`` (D, E) whole,
    ``experts`` this rank's ``E / ep`` experts' (w_gate, w_up, w_down);
    ``sum_grads`` as ``_GatherSeq``'s."""
    E = router.shape[1]
    e_local = E // ep
    b_l, S, D = x.shape
    if S % ep:
        raise ValueError(f"sequence {S} does not split over {ep} ranks")
    s_l = S // ep
    t_l = b_l * s_l
    x2d = x[:, j * s_l:(j + 1) * s_l].reshape(t_l, D)
    experts_ids, weights, _ = _route({"router": router}, x2d, top_k)
    C = _capacity(t_l, top_k, E, capacity_factor)

    flat = _one_hot(experts_ids, E).reshape(t_l * top_k, E)
    pos = torch.amax(torch.cumsum(flat, dim=0) * flat - 1, dim=-1)
    e_flat = experts_ids.reshape(t_l * top_k)
    keep = pos < C
    slot = torch.where(keep, pos, C)

    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_put_((e_flat, slot),
                   torch.repeat_interleave(x2d, top_k, dim=0),
                   accumulate=True)
    buf = buf[:, :C, :].reshape(ep, e_local, C, D)
    # dispatch: each expert block to the rank that owns the expert
    buf = _AllToAll.apply(buf, group)
    # buf now (ep, e_local, C, D): rows from every source rank
    w_gate, w_up, w_down = experts
    h = F.silu(einsum("pecd,edf->pecf", buf, w_gate))
    h = h * einsum("pecd,edf->pecf", buf, w_up)
    out = einsum("pecf,efd->pecd", h, w_down)
    # combine: results back to the ranks that own the tokens
    out = _AllToAll.apply(out, group).reshape(E, C, D)
    out = torch.cat([out, out.new_zeros((E, 1, D))], dim=1)
    gathered = out[e_flat, slot]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=x.device))
    gathered = gathered.reshape(t_l, top_k, D) * weights[..., None]
    y = gathered.sum(dim=1).reshape(b_l, s_l, D)
    return _GatherSeq.apply(y, group, j, sum_grads)


def moe_tp(params, x, spec, tp, *, top_k: int, capacity_factor: float = 1.25,
           ep: bool = False):
    """The MoE FFN on this rank's shards under tensor parallelism
    (``dist.partitioning.TensorParallel``; ``spec`` the layer's MoE
    ``PS`` tree).  ``x`` is replicated over "model", as the reference's
    tokens are where they reach the MoE.

    The experts (or, where the guard keeps them whole, their "ffn"
    columns) are split over "model"; a dim split nowhere runs the plain
    ``moe_gspmd``.  The router is needed whole: gathered over "model"
    when its expert columns are split.  ``ep`` (``moe_impl="ep"``, the
    experts split, the sequence a multiple of the "model" axis):
    ``moe_ep_shardmap``'s exchange over the "model" group on the rank's
    sequence slice.  Otherwise (a decode step's one token among them)
    every rank routes every token (the same capacity as one process),
    runs its own experts on the tokens sent to them and combines a
    partial output, reduced over "model"."""
    split_e = tp.splits(spec["w_gate"], 0)
    split_f = tp.splits(spec["w_gate"], 2)
    if not (split_e or split_f):
        return moe_gspmd(params, x, top_k=top_k,
                         capacity_factor=capacity_factor)
    router = params["router"]
    router = (tp.gather(router, tp.model, 1) if tp.splits(spec["router"], 1)
              else tp.copy(router))
    x = tp.copy(x)
    if ep and split_e and x.shape[1] % tp.model.size == 0:
        return _ep(router, [params[k] for k in _EXPERT_KEYS], x, top_k=top_k,
                   capacity_factor=capacity_factor, group=tp.model.group,
                   ep=tp.model.size, j=tp.model.rank, sum_grads=False)
    # this rank's experts (all of them when only their "ffn" columns
    # are split)
    lo = tp.model.rank * params["w_gate"].shape[0] if split_e else 0
    return tp.reduce(_capacity_ffn(
        router, [params[k] for k in _EXPERT_KEYS], x, top_k=top_k,
        capacity_factor=capacity_factor, lo=lo))
