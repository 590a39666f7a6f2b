"""Decoder-only LM: dense GQA or MoE FFN, the layer stack, KV-cache serving.

The counterpart of ``repro.models.lm``.  Covers granite-moe-1b-a400m,
kimi-k2-1t-a32b, yi-9b, internlm2-1.8b, minicpm-2b and qwen1.5-32b,
and serves as the text backbone of internvl2-2b (``vlm.py``).

The layer params stay stacked ``(L, ...)`` as in the reference, and a
Python loop runs them (the reference's ``lax.scan`` computes the same
layers in the same order).  ``forward`` is the training path: each
layer body runs under ``cfg.remat`` (``base.remat``, the reference's
``REMAT_POLICIES`` at ``lm.py:32``) over ``base.layer_list``'s
per-layer views, and ``loss_fn`` is differentiable by autograd.
``constrain(tensor, logical_axes)`` is the reference's sharding hook
(``dist.partitioning.activation_constrainer``; the identity on a plain
tensor).  With ``moe_impl="ep"`` and a constrainer that carries a mesh,
the MoE layers run ``moe.moe_ep_shardmap`` over its "model" axis, as
the reference's do.

Under a ``dist.partitioning.TensorParallel`` hook (``constrain.tp``)
the params are each rank's shards and every function computes on them,
as GSPMD runs the reference's step (``lm.py:84,98,109,142``): the
embedding is a masked lookup of the rank's vocab rows summed over
"model"; a layer gathers its FSDP leaves over "data" (inside the remat
body, so the recompute gathers again and the whole layer is freed after
it), runs attention on its heads and the MLP on its "ffn" columns, each
reduced over "model" before the residual add; the logits are the
rank's vocab columns and the loss the vocab-parallel cross-entropy.
Where the divisibility guard left a dim whole, its product runs whole
on every rank (``base.gqa_attention``'s ``kv_split``).  Prefill and
decode write each rank's KV heads into its cache shard (the whole cache
where the guard keeps the KV heads whole) and return the rank's vocab
columns of the logits.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from ..device import resolve_device
from ..dist.partitioning import layer_specs as _layer_spec_tree
from . import moe as _moe
from .base import (
    P,
    attention_specs,
    causal_additive_mask,
    einsum,
    gqa_attention,
    layer_list,
    layer_slice,
    map_specs,
    mlp,
    mlp_specs,
    padded_vocab,
    remat,
    rms_norm,
    softmax_xent,
    vocab_parallel_xent,
)


def _identity(t, axes):
    return t


def _stack_specs(layer_specs: Dict[str, Any], n_layers: int):
    """Prefix every per-layer spec with a stacked ('layers') axis."""
    return map_specs(
        lambda _path, p: P((n_layers, *p.shape), ("layers", *p.axes),
                           p.dtype, p.scale),
        layer_specs)


def layer_specs(cfg):
    head_dim = cfg.head_dim or cfg.d_model // cfg.n_heads
    s = {
        "ln_attn": P((cfg.d_model,), ("embed",)),
        "ln_mlp": P((cfg.d_model,), ("embed",)),
        "attn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv, head_dim,
                                cfg.qkv_bias),
    }
    if cfg.moe is not None:
        s["moe"] = _moe.moe_specs(cfg.d_model, cfg.moe.d_ff_expert,
                                  cfg.moe.n_experts)
    else:
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff)
    return s


def param_specs(cfg):
    vp = padded_vocab(cfg.vocab)
    specs = {
        "embed": P((vp, cfg.d_model), ("vocab", "embed"), scale=1.0),
        "ln_f": P((cfg.d_model,), ("embed",)),
        "layers": _stack_specs(layer_specs(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((cfg.d_model, vp), ("embed", "vocab"))
    return specs


def _layer_fwd(cfg, constrain, lp, x, positions, kv_cache=None,
               cache_index=None, attn_mask=None):
    """One transformer layer.  Returns (x, new_kv)."""
    h, new_kv = gqa_attention(
        lp["attn"], rms_norm(x, lp["ln_attn"]), positions,
        causal=True, rope_theta=cfg.rope_theta,
        kv_cache=kv_cache, cache_index=cache_index, attn_mask=attn_mask,
    )
    x = constrain(x + h, ("batch", None, "embed"))
    h2 = rms_norm(x, lp["ln_mlp"])
    if cfg.moe is not None:
        mesh = getattr(constrain, "mesh", None)
        if cfg.moe_impl == "ep" and mesh is not None:
            h2 = _moe.moe_ep_shardmap(
                lp["moe"], h2, top_k=cfg.moe.top_k, mesh=mesh,
                capacity_factor=cfg.moe.capacity_factor)
        else:
            h2 = _moe.moe_gspmd(lp["moe"], h2, top_k=cfg.moe.top_k,
                                capacity_factor=cfg.moe.capacity_factor,
                                constrain=constrain)
    else:
        h2 = mlp(lp["mlp"], h2)
    return constrain(x + h2, ("batch", None, "embed")), new_kv


def tp_attention(p, x, positions, tp=None, spec=None, **kw):
    """``gqa_attention`` of the params ``p``; under ``tp`` on the rank's
    heads where ``spec`` (their ``PS`` tree) splits them, whole on every
    rank where the divisibility guard kept them whole; a cache whose
    sequence ``tp.kv_seq`` splits is attended on the rank's positions."""
    if tp is None:
        return gqa_attention(p, x, positions, **kw)
    return gqa_attention(p, x, positions,
                         tp=tp if tp.splits(spec["wq"], 1) else None,
                         kv_split=tp.splits(spec["wk"], 1), seq_tp=tp, **kw)


def tp_mlp(p, x, tp=None, spec=None):
    """``mlp``; under ``tp`` on the rank's "ffn" columns where ``spec``
    splits them."""
    if tp is None:
        return mlp(p, x)
    return mlp(p, x, tp=tp if tp.splits(spec["w_up"], 1) else None)


def _layer_fwd_tp(cfg, tp, spec, lp, x, positions, kv_cache=None,
                  cache_index=None, attn_mask=None):
    """``_layer_fwd`` on this rank's shards (``lp``; ``spec`` their
    ``PS`` tree, see the module doc).  Returns (x, new_kv)."""
    lp = tp.gather_fsdp(lp, spec)
    h, new_kv = tp_attention(
        lp["attn"], rms_norm(x, lp["ln_attn"]), positions, tp, spec["attn"],
        causal=True, rope_theta=cfg.rope_theta,
        kv_cache=kv_cache, cache_index=cache_index, attn_mask=attn_mask)
    x = x + h
    h2 = rms_norm(x, lp["ln_mlp"])
    if cfg.moe is not None:
        h2 = _moe.moe_tp(lp["moe"], h2, spec["moe"], tp, top_k=cfg.moe.top_k,
                         capacity_factor=cfg.moe.capacity_factor,
                         ep=cfg.moe_impl == "ep")
    else:
        h2 = tp_mlp(lp["mlp"], h2, tp, spec["mlp"])
    return x + h2, new_kv


def _embed(params, tokens, tp):
    """The token embeddings: a lookup, or under ``tp`` the masked lookup
    of this rank's vocab rows summed over "model"."""
    if tp is None:
        return params["embed"][tokens]
    spec = tp.specs["embed"]
    emb = tp.gather_fsdp(params["embed"], spec)
    if not tp.splits(spec, 0):
        return emb[tokens]
    n = emb.shape[0]
    local = tokens - tp.model.rank * n
    inside = (local >= 0) & (local < n)
    x = emb[local.clamp(0, n - 1)]
    return tp.reduce(torch.where(inside[..., None], x,
                                 torch.zeros((), dtype=x.dtype,
                                             device=x.device)))


def _head(params, cfg, tp):
    """``(head (D, V_l), lo)``: the output projection this rank holds
    and the global id of its first vocab column."""
    if tp is None:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return head, 0
    if cfg.tie_embeddings:
        spec = tp.specs["embed"]
        head = tp.gather_fsdp(params["embed"], spec).T
        return head, tp.offset(spec, 0, head.shape[1])
    spec = tp.specs["lm_head"]
    head = tp.gather_fsdp(params["lm_head"], spec)
    return head, tp.offset(spec, 1, head.shape[1])


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None, :].expand(B, S)


def forward(params, tokens, cfg, constrain=None, *, embedded=None):
    """Training/prefill-style forward (no cache).  Returns hidden (B,S,D)."""
    constrain = constrain or _identity
    tp = getattr(constrain, "tp", None)
    x = _embed(params, tokens, tp) if embedded is None else embedded
    x = constrain(x, ("batch", None, "embed"))
    B, S = x.shape[0], x.shape[1]
    positions = _positions(B, S, x.device)
    attn_mask = causal_additive_mask(positions)  # hoisted out of layers

    if tp is None:
        def body(lp, h):
            return _layer_fwd(cfg, constrain, lp, h, positions,
                              attn_mask=attn_mask)[0]
    else:
        spec = _layer_spec_tree(tp.specs["layers"])

        def body(lp, h):
            return _layer_fwd_tp(cfg, tp, spec, lp, h, positions,
                                 attn_mask=attn_mask)[0]

    body = remat(body, cfg.remat)
    for lp in layer_list(params["layers"], cfg.n_layers):
        x = body(lp, x)
    return rms_norm(x, leaf(params, "ln_f", tp))


def leaf(params, name: str, tp):
    """``params[name]``; under ``tp`` with its FSDP dims gathered."""
    if tp is None:
        return params[name]
    return tp.gather_fsdp(params[name], tp.specs[name])


def logits_fn(params, hidden, cfg, constrain=None):
    """The logits; under ``constrain.tp`` this rank's vocab columns."""
    constrain = constrain or _identity
    tp = getattr(constrain, "tp", None)
    head, lo = _head(params, cfg, tp)
    vl = head.shape[-1]
    vp = padded_vocab(cfg.vocab)
    if tp is not None and vl != vp:   # split columns: a partial product
        hidden = tp.copy(hidden)
    logits = einsum("bsd,dv->bsv", hidden, head)
    if vp != cfg.vocab:  # mask padded vocab columns out of the softmax
        cols = torch.arange(lo, lo + vl, device=logits.device)
        pad_mask = torch.where(cols < cfg.vocab, 0.0, -1e30)
        logits = logits + pad_mask.to(logits.dtype)
    return constrain(logits, ("batch", None, "vocab"))


def loss_fn(params, batch, cfg, constrain=None):
    """Next-token CE (the value).  batch: {tokens (B,S), labels (B,S),
    mask}."""
    hidden = forward(params, batch["tokens"], cfg, constrain)
    return xent(logits_fn(params, hidden, cfg, constrain), batch, cfg,
                constrain)


def xent(logits, batch, cfg, constrain=None):
    """The CE of ``logits_fn``'s logits against ``batch``'s labels and
    mask: under ``constrain.tp`` with the rank's vocab columns, the
    vocab-parallel cross-entropy."""
    tp = getattr(constrain, "tp", None)
    vl = logits.shape[-1]
    if tp is not None and vl != padded_vocab(cfg.vocab):   # split columns
        return vocab_parallel_xent(logits, batch["labels"],
                                   batch.get("mask"), tp, tp.model.rank * vl)
    return softmax_xent(logits, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# serving: prefill builds the cache, decode appends one token
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    """Per-layer cache tuple of ``{"k", "v"}``, each ``(B, KV, T, Dh)``
    zeros on ``device`` (cuda unless ``"cpu"``)."""
    dev = resolve_device(device)
    head_dim = cfg.head_dim or cfg.d_model // cfg.n_heads
    shape = (batch, cfg.n_kv, max_len, head_dim)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=dev),
                  "v": torch.zeros(shape, dtype=dtype, device=dev)}
                 for _ in range(cfg.n_layers))


def kv_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """``init_kv_cache``'s layout as ``meta`` tensors (no allocation)."""
    return init_kv_cache(cfg, batch, max_len, dtype, device="meta")


def _cached_stack(params, cfg, constrain, x, positions, cache, cache_index):
    """The layer stack threading the per-layer KV caches (tuple of
    dicts), each layer writing its keys and values into its cache."""
    tp = getattr(constrain, "tp", None)
    if tp is None:
        layer = functools.partial(_layer_fwd, cfg, constrain)
    else:
        layer = functools.partial(_layer_fwd_tp, cfg, tp,
                                  _layer_spec_tree(tp.specs["layers"]))
    out = []
    for i in range(cfg.n_layers):
        c = cache[i]
        x, (nk, nv) = layer(layer_slice(params["layers"], i), x, positions,
                            kv_cache=(c["k"], c["v"]),
                            cache_index=cache_index)
        out.append({"k": nk, "v": nv})
    return x, tuple(out)


def prefill(params, tokens, cache, cfg, constrain=None, *, embedded=None):
    """Prefill: runs the full prompt, fills cache.  Returns (logits_last,
    cache).  tokens: (B, S)."""
    constrain = constrain or _identity
    tp = getattr(constrain, "tp", None)
    x = _embed(params, tokens, tp) if embedded is None else embedded
    x = constrain(x, ("batch", None, "embed"))
    B, S = x.shape[0], x.shape[1]
    positions = _positions(B, S, x.device)
    x, cache = _cached_stack(params, cfg, constrain, x, positions, cache, 0)
    hidden = rms_norm(x[:, -1:], leaf(params, "ln_f", tp))
    return logits_fn(params, hidden, cfg, constrain)[:, 0], cache


def decode_step(params, tokens, cache, cache_index, cfg, constrain=None):
    """One decode step.  tokens: (B, 1); cache_index: int (#valid).
    Returns (logits (B, V), cache)."""
    constrain = constrain or _identity
    tp = getattr(constrain, "tp", None)
    x = constrain(_embed(params, tokens, tp), ("batch", None, "embed"))
    B = x.shape[0]
    positions = torch.full((B, 1), int(cache_index), dtype=torch.long,
                           device=x.device)
    x, cache = _cached_stack(params, cfg, constrain, x, positions, cache,
                             cache_index)
    hidden = rms_norm(x, leaf(params, "ln_f", tp))
    return logits_fn(params, hidden, cfg, constrain)[:, 0], cache
