"""Mixture-of-Experts FFN: top-k router + capacity-based dispatch.

The counterpart of ``repro.models.moe``'s ``moe_specs``, ``_route``,
``_capacity`` and ``moe_gspmd`` (index-scatter dispatch in plain
tensor ops).  The reference's ``moe_ep_shardmap`` (expert parallelism
over a mesh) waits for the partitioning item, ROADMAP A13d; the LM
takes it only when its ``constrain`` hook carries a mesh.

Capacity: each expert accepts at most C = ceil(T*k/E * cf) tokens
(padded to 8); overflow tokens are dropped (contribute zero) like
Switch/GShard.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base import P, einsum


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


def _capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(np.ceil(n_tokens * top_k / n_experts * cf))
    return max(8, ((c + 7) // 8) * 8)  # the reference's padding to 8


def moe_gspmd(params, x, *, top_k: int, capacity_factor: float = 1.25,
              constrain=None):
    """Capacity MoE via scatter dispatch.  x: (B, S, D) -> (B, S, D).
    ``constrain`` is the reference's sharding hook (identity here)."""
    if constrain is None:
        constrain = lambda t, axes: t  # noqa: E731
    B, S, D = x.shape
    E = params["router"].shape[1]
    T = B * S
    x2d = x.reshape(T, D)
    experts, weights, _ = _route(params, x2d, top_k)  # (T, k)

    C = _capacity(T, top_k, E, capacity_factor)
    # position of each (token, k) within its expert, by arrival order
    flat = F.one_hot(experts, E).reshape(T * top_k, E)  # (T*k, E)
    pos_in_e = torch.cumsum(flat, dim=0) * flat - 1
    pos = torch.amax(pos_in_e, dim=-1)                  # (T*k,)
    e_flat = experts.reshape(T * top_k)
    keep = pos < C

    # scatter tokens into (E, C, D) buffers; dropped tokens -> row C
    # (every kept (expert, slot) is written once, so the add is exact)
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    slot = torch.where(keep, pos, C)
    src = torch.repeat_interleave(x2d, top_k, dim=0)    # (T*k, D)
    buf.index_put_((e_flat, slot), src, accumulate=True)
    buf = constrain(buf, ("experts", None, "embed"))[:, :C, :]

    # expert FFN (swiglu)
    h = F.silu(einsum("ecd,edf->ecf", buf, params["w_gate"]))
    h = h * einsum("ecd,edf->ecf", buf, params["w_up"])
    h = constrain(h, ("experts", None, "ffn"))
    out_buf = einsum("ecf,efd->ecd", h, params["w_down"])
    out_buf = constrain(out_buf, ("experts", None, "embed"))

    # combine: gather each (token, k) result, weight, sum over k
    gathered = out_buf[e_flat, torch.clamp(slot, max=C - 1)]  # (T*k, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=x.device))
    gathered = gathered.reshape(T, top_k, D) * weights[..., None]
    return gathered.sum(dim=1).reshape(B, S, D)
