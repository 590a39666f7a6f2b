"""Functional model substrate: parameter specs and the shared layers.

The counterpart of ``repro.models.base``.  Params are plain nested
dicts of torch tensors with the reference's nesting, leaf names and
shapes, so a reference param tree carries across leaf for leaf
(``convert.model_params_from_reference``).  Every parameter is declared
as a :class:`P` spec carrying shape, logical axes, dtype and init
scale; ``repro_torch.dist.partitioning`` maps the logical axes to mesh
placements (``logical_axes``), and ``abstract_params`` gives each
param's shape and dtype as a ``meta`` tensor (no allocation), the
counterpart of the reference's ``ShapeDtypeStruct`` tree.

The layers are plain functions over those dicts, written op for op
after the reference, with the places where the numerics of torch and
JAX part named where they are handled:

* **dtype promotion** — JAX promotes bf16 x f32 to f32 inside
  ``einsum``; ``torch.einsum`` and ``matmul`` raise on mixed dtypes, so
  ``mm`` and ``einsum`` below cast both operands to
  ``torch.promote_types`` first (the reference's bf16 caches meet an
  f32 ``q`` when the params are f32);
* **the cache write** — ``jax.lax.dynamic_update_slice`` clamps its
  start so that the update fits; the port clamps to
  ``min(cache_index, T - S)``;
* **the token gather** — ``jnp.take`` clamps out-of-range ids where
  torch indexing raises; the serving engine's tokens are always below
  ``vocab`` (prompt tokens are reduced modulo ``vocab``, sampled ones
  are argmax / draws over the real vocabulary), so no clamp is needed.

The backward pass is ``torch.autograd``'s over these functions.  Two
helpers serve it: ``layer_list`` splits stacked ``(L, ...)`` params
into per-layer views with one ``unbind`` (its backward stacks the
layers' grads once, where ``L`` separate ``t[i]`` selects would each
scatter into a zero tensor of the whole stack), and ``remat`` applies
the reference's ``REMAT_POLICIES`` (``lm.py``) to a layer body:

* ``"none"``: the body as is (autograd saves what it needs);
* ``"full"`` (``nothing_saveable``): ``torch.utils.checkpoint`` around
  the body, non-reentrant: only the body's inputs are kept and the
  body runs again in the backward;
* ``"dots"`` (``dots_with_no_batch_dims_saveable``): selective
  checkpointing that saves the outputs of the products with no batch
  dimension — ``aten.mm`` and the batch-1 ``aten.bmm`` a
  ``torch.einsum`` without batch dims becomes (the weight products) —
  and recomputes the rest (the attention products, norms, gates).
  The batch dims are read from the ``bmm``'s size, so an attention
  product whose batch and KV heads are both 1 is saved too.

Either way the recomputation gives the same values, so the grads do not
change.  A body runs as is when grad is disabled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

__all__ = ["P", "Params", "init_params", "map_specs", "abstract_params",
           "logical_axes", "padded_vocab",
           "rms_norm", "rms_norm_split", "rope", "attention_specs",
           "gqa_attention",
           "mlp_specs", "mlp", "softmax_xent", "vocab_parallel_xent",
           "causal_additive_mask",
           "mm", "einsum", "layer_slice", "layer_list", "remat",
           "REMAT_POLICIES"]


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter spec: shape + logical axes (+dtype, init scale)."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    scale: float = 1.0  # stddev multiplier over 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def map_specs(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, spec)`` over every ``P`` of a nested dict, keys in
    sorted order (the order JAX flattens a dict in)."""
    if isinstance(tree, P):
        return fn(path, tree)
    return {k: map_specs(fn, tree[k], path + (k,)) for k in sorted(tree)}


def abstract_params(spec_tree) -> Params:
    """``meta`` tensors of each spec's shape and dtype (no allocation)."""
    return map_specs(lambda _path, p: torch.empty(
        p.shape, dtype=p.dtype, device="meta"), spec_tree)


def logical_axes(spec_tree):
    """Tree of logical-axis tuples, same structure as the params."""
    return map_specs(lambda _path, p: p.axes, spec_tree)


def init_params(spec_tree, generator: torch.Generator,
                device=None) -> Params:
    """Random params by the reference's rule: ``std = scale /
    sqrt(fan_in)`` with ``fan_in`` the second-to-last dim (the last for
    1-d), zeros for 0-d.  The normals are drawn in f32 from
    ``generator`` on its own device, then cast to the spec dtype and
    moved to ``device`` (the generator's device when None).  They do
    not match JAX's random numbers; parity tests carry the reference's
    params across instead."""
    gdev = generator.device
    dev = gdev if device is None else torch.device(device)

    def one(_path, p: P):
        if len(p.shape) == 0:
            return torch.zeros(p.shape, dtype=p.dtype, device=dev)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(fan_in, 1))
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=gdev) * std
        return w.to(device=dev, dtype=p.dtype)

    return map_specs(one, spec_tree)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` param (or cache) tree:
    dicts and NamedTuples (``ssm.SSMCache``) are walked field by field
    (``[i]`` on a NamedTuple would pick its i-th field); a tensor is
    indexed."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(layer_slice(v, i) for v in tree))
    return tree[i]


def layer_list(tree, n: int) -> list:
    """The ``n`` layers of a stacked ``(L, ...)`` param tree (dicts of
    tensors) as a list of per-layer trees: one ``unbind`` a tensor."""
    if isinstance(tree, dict):
        per = {k: layer_list(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    parts = torch.unbind(tree, 0)
    if len(parts) != n:
        raise ValueError(f"stacked dim {len(parts)} != {n} layers")
    return list(parts)


REMAT_POLICIES = ("none", "full", "dots")


def _saves_dot(op, args) -> bool:
    aten = torch.ops.aten
    return (op is aten.mm.default
            or (op is aten.bmm.default and args[0].shape[0] == 1))


def _dots_context():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if _saves_dot(op, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def remat(fn, policy: str):
    """``fn`` under the remat ``policy`` (see the module doc)."""
    if policy not in REMAT_POLICIES:
        raise KeyError(policy)
    if policy == "none":
        return fn

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        from torch.utils.checkpoint import checkpoint
        if policy == "full":
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# dtype promotion (JAX promotes mixed float operands; torch raises)
# ---------------------------------------------------------------------------


def mm(a, b):
    """``a @ b`` with JAX's promotion of mixed float dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, *ops):
    """``jnp.einsum`` with JAX's promotion of mixed float dtypes."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *[t.to(dt) for t in ops])


# ---------------------------------------------------------------------------
# layers (pure functions over param dicts)
# ---------------------------------------------------------------------------


VOCAB_PAD = 256


def padded_vocab(vocab: int) -> int:
    """Vocab rounded up to a multiple of ``VOCAB_PAD``; the padded
    logit columns are masked to -1e30 in ``lm.logits_fn``."""
    return -(-vocab // VOCAB_PAD) * VOCAB_PAD


def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm in f32, scaled by ``1 + weight`` (zero-init weights are
    the identity), cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rms_norm_split(x, weight, tp, n: int, eps: float = 1e-6):
    """``rms_norm`` over a last dim of ``n`` entries split over "model":
    ``x`` (..., n_l) and ``weight`` (n_l,) are the rank's.  The sum of
    squares is summed over "model", and so is its grad (each rank's
    entries are scaled by it)."""
    dtype = x.dtype
    x = x.float()
    ss = tp.copy(tp.reduce(torch.sum(x * x, dim=-1, keepdim=True)))
    x = x * torch.rsqrt(ss / n + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding.  x: (..., S, H, Dh), positions: (..., S).  The
    frequencies are f32, ``theta ** (-arange(half) / half)``, as in the
    reference; the rotation runs in f32 (bf16 x f32 promotes, as in
    JAX) and is cast back to ``x``'s dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq  # (..., S, half)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_specs(d_model, n_heads, n_kv, head_dim, qkv_bias=False):
    s = {
        "wq": P((d_model, n_heads, head_dim), ("embed", "heads", None)),
        "wk": P((d_model, n_kv, head_dim), ("embed", "kv", None)),
        "wv": P((d_model, n_kv, head_dim), ("embed", "kv", None)),
        "wo": P((n_heads, head_dim, d_model), ("heads", None, "embed")),
    }
    if qkv_bias:
        s["bq"] = P((n_heads, head_dim), ("heads", None))
        s["bk"] = P((n_kv, head_dim), ("kv", None))
        s["bv"] = P((n_kv, head_dim), ("kv", None))
    return s


def gqa_attention(
    params,
    x,                      # (B, S, D)
    positions,              # (B, S)
    *,
    causal: bool = True,
    rope_theta: float = 10_000.0,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Optional[int] = None,  # #valid cache entries
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    attn_mask: Optional[torch.Tensor] = None,  # additive (B, S, T)
    tp=None,
    kv_split: bool = False,
    seq_tp=None,
):
    """Grouped-query attention with optional KV cache / cross-attention.

    Returns ``(out (B, S, D), new_kv or None)``.  Cache layout
    ``(B, KV, T, Dh)``.  The new keys and values are written INTO the
    cache tensors, which are returned as ``new_kv`` (the reference
    returns an updated copy; every caller here replaces its cache by
    the returned one, so the values are the same).  This is plain torch:
    the reference computes attention in XLA, outside any Pallas kernel.

    ``tp`` (a ``dist.partitioning.TensorParallel``): the params are this
    rank's heads of "model" (``wq`` / ``wo`` / ``bq``), the output its
    partial sum, reduced over "model".  With ``kv_split`` the KV
    projections (and the cache) are this rank's KV heads too; without,
    the divisibility guard left them whole: with a cache they run whole
    (the cache is whole on every rank) and each query head takes its
    own KV head from them; without one, only the KV heads this rank's
    query heads use are projected.

    ``seq_tp`` (a ``TensorParallel`` whose ``kv_seq`` splits the cache's
    sequence over ranks, heads split or not): the rank writes the new
    entries that fall in its positions and attends over those; the
    softmax's max and sum and the values' product are reduced over
    ``kv_seq`` (what GSPMD runs for the reference's attention on such a
    cache).
    """
    B, S, D = x.shape
    picked = False
    seq = kv_cache is not None and seq_tp is not None and bool(
        seq_tp.kv_seq)
    if tp is not None:
        x = tp.copy(x)
        if not kv_split:   # whole weights inside the split product
            params = {k: tp.copy(v) if k in ("wk", "wv", "bk", "bv") else v
                      for k, v in params.items()}
            n_q = params["wq"].shape[1]
            heads = (tp.model.rank * n_q, n_q,
                     n_q * tp.model.size // params["wk"].shape[1])
            picked = kv_cache is None and kv_override is None
            if picked:   # project only the KV heads these heads use
                params["wk"], params["wv"] = _kv_of_heads(
                    params["wk"], params["wv"], *heads)
                if "bk" in params:
                    params["bk"], params["bv"] = _kv_of_heads(
                        params["bk"], params["bv"], *heads, dim=0)
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    if kv_override is not None:
        k, v = kv_override
        new_kv = None
    else:
        k = einsum("bsd,dhk->bshk", x, params["wk"])
        v = einsum("bsd,dhk->bshk", x, params["wv"])
        if "bk" in params:
            k = k + params["bk"]
            v = v + params["bv"]
        k = rope(k, positions, rope_theta)
        k = k.transpose(1, 2)  # (B, KV, S, Dh)
        v = v.transpose(1, 2)
        if kv_cache is not None:
            ck, cv = kv_cache
            n = ck.shape[2]
            off, T_all = seq_tp.seq_offset(n) if seq else (0, n)
            # dynamic_update_slice clamps its start so the update fits;
            # a rank writes the part that falls in its positions
            start = max(0, min(int(cache_index), T_all - S))
            lo, hi = max(start, off), min(start + S, off + n)
            if lo < hi:   # copy_ casts to the cache dtype
                ck[:, :, lo - off:hi - off] = k[:, :, lo - start:hi - start]
                cv[:, :, lo - off:hi - off] = v[:, :, lo - start:hi - start]
            k, v = ck, cv
        new_kv = (k, v)
    q = rope(q, positions, rope_theta)

    n_heads = q.shape[2]
    if tp is not None and not kv_split and not picked:
        k, v = _kv_of_heads(k, v, *heads)
    n_kv = k.shape[1]
    group = n_heads // n_kv
    T = k.shape[2]
    # the softmax scale is folded into q before the scores, as in the
    # reference (its f32 product rounded back to q's dtype); kept in
    # this explicit form: scaled_dot_product_attention would change the
    # numerics
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh = (q.float() * scale).to(q.dtype)
    qh = qh.reshape(B, S, n_kv, group, -1)
    scores = einsum("bsngk,bntk->bngst", qh, k).float()

    if attn_mask is not None:
        scores = scores + attn_mask[:, None, None, :, :]
    else:
        # mask[b, s_query, t_key]; positions are ABSOLUTE (shared w/ RoPE)
        key_pos = torch.arange(T, device=x.device)
        if seq:
            key_pos = key_pos + off
        if kv_cache is not None:
            valid = key_pos[None, None, :] < (int(cache_index) + S)
            if causal:
                mask = valid & (key_pos[None, None, :]
                                <= positions[:, :, None])
            else:
                mask = valid.expand(B, S, T)
        elif causal:
            mask = positions[:, None, :] <= positions[:, :, None]
        else:
            mask = None
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    # f32 probabilities, cast back to x's dtype before the second product
    if seq:
        e = torch.exp(scores - seq_tp.seq_reduce(
            scores.amax(-1, keepdim=True), "max"))
        probs = (e / seq_tp.seq_reduce(e.sum(-1, keepdim=True), "sum")
                 ).to(x.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = einsum("bngst,bntk->bsngk", probs, v)
    if seq:
        out = seq_tp.seq_reduce(out, "sum")
    out = out.reshape(B, S, n_heads, -1)
    out = einsum("bshk,hkd->bsd", out, params["wo"])
    if tp is not None:
        out = tp.reduce(out)
    return out, new_kv


def _kv_of_heads(k, v, lo: int, n: int, group: int, dim: int = 1):
    """The KV heads (dim ``dim`` of ``k`` / ``v``, all of them: the
    projections' weights or their outputs) that query heads ``lo .. lo
    + n - 1`` attend with (head i uses KV head ``i // group``), laid out
    for the grouping of ``gqa_attention``: whole groups as a slice, a
    part of one group as its one KV head, else one KV head a query
    head."""
    if n % group == 0 and lo % group == 0:
        a, b = lo // group, (lo + n) // group
    elif group % n == 0 and lo % n == 0:
        a, b = lo // group, lo // group + 1
    else:
        idx = torch.arange(lo, lo + n, device=k.device) // group
        return k.index_select(dim, idx), v.index_select(dim, idx)
    return k.narrow(dim, a, b - a), v.narrow(dim, a, b - a)


def mlp_specs(d_model, d_ff, gated=True):
    if gated:
        return {
            "w_gate": P((d_model, d_ff), ("embed", "ffn")),
            "w_up": P((d_model, d_ff), ("embed", "ffn")),
            "w_down": P((d_ff, d_model), ("ffn", "embed")),
        }
    return {
        "w_up": P((d_model, d_ff), ("embed", "ffn")),
        "w_down": P((d_ff, d_model), ("ffn", "embed")),
    }


def mlp(params, x, tp=None):
    """SwiGLU when gated, else GELU — ``jax.nn.gelu``'s default is the
    tanh approximation, so ``approximate="tanh"``.  ``tp``: the params
    are this rank's "ffn" columns / rows (column- then row-parallel);
    the output's partial sum is reduced over "model"."""
    if tp is not None:
        x = tp.copy(x)
    if "w_gate" in params:
        h = F.silu(mm(x, params["w_gate"])) * mm(x, params["w_up"])
    else:
        h = F.gelu(mm(x, params["w_up"]), approximate="tanh")
    out = mm(h, params["w_down"])
    return out if tp is None else tp.reduce(out)


def softmax_xent(logits, labels, mask=None):
    """Mean CE over valid tokens; logits (..., V) f32-upcast."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def vocab_parallel_xent(logits, labels, mask, tp, lo: int):
    """``softmax_xent`` over logits split on the vocab over "model":
    ``logits`` (..., V_l) are this rank's columns ``lo .. lo + V_l - 1``.
    The max, the sum of exponentials and the label's logit are each
    reduced over "model" (Megatron's vocab-parallel cross-entropy); the
    result is the whole loss on every rank."""
    logits = logits.float()
    m = tp.reduce_max(torch.amax(logits.detach(), dim=-1))
    s = tp.reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    logz = torch.log(s) + m
    local = labels.long() - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.take_along_dim(
        logits, local.clamp(0, logits.shape[-1] - 1)[..., None],
        dim=-1)[..., 0]
    gold = tp.reduce(torch.where(inside, gold, torch.zeros_like(gold)))
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def causal_additive_mask(positions, T: Optional[int] = None,
                         cache_index=None, S: Optional[int] = None):
    """Additive f32 mask, built once per forward (hoisted out of the
    layers): 0 where a query may attend, -1e30 elsewhere."""
    if T is None:
        mask = positions[:, None, :] <= positions[:, :, None]
    else:
        key_pos = torch.arange(T, device=positions.device)
        valid = key_pos[None, None, :] < (int(cache_index) + S)
        mask = valid & (key_pos[None, None, :] <= positions[:, :, None])
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)
    return torch.where(mask, zero, torch.full_like(zero, -1e30))
