"""Zamba2-style hybrid: Mamba-2 backbone + one *shared* GQA attention
block applied every ``attn_every`` layers (arXiv:2411.15242).

The counterpart of ``repro.models.zamba``.  The shared block attends
over ``[hidden ; original embedding]`` concatenated (width 2·d_model)
and projects back to d_model; at decode it keeps one KV cache per
application.  Without caches (training) each Mamba layer body runs
under ``cfg.remat`` (``base.remat``), as the reference's at
``zamba.py:98-115``; the shared block does not, as there.

With caches, each Mamba layer's new conv window and SSM state are
written INTO the stacked ``(L, ...)`` cache tensors, and the shared
block's keys and values into its ``(A, ...)`` KV caches, where the
reference stacks a new copy of every layer each step; the values are
the reference's.  One case changes a cache tensor: the reference's new
conv window has the promoted dtype of the cache and the activations
(``ssm._causal_conv``), so f32 params over a bf16 cache turn the
stacked conv cache f32 after the first step; the port promotes the
stacked tensor once, then writes into it.

Under a ``dist.partitioning.TensorParallel`` hook (``constrain.tp``)
the params are each rank's shards: the vocab-parallel embedding, logits
and cross-entropy of ``lm.py``; each Mamba-2 layer on the rank's SSM
heads where "model" divides them (``ssm.py``'s module doc; its decode
state is the rank's heads, the conv cache whole); the shared block's
attention on the rank's heads and its MLP on the rank's "ffn" columns,
each reduced over "model", with the replicated ``w_proj`` whole on the
reduced (whole) attention output.  The shared block's params serve every
application, so autograd adds their grads across uses.  FSDP leaves are
gathered over "data" at use, a layer (or an application) at a time.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..dist.partitioning import layer_specs as _layer_spec_tree
from .base import (
    P,
    attention_specs,
    layer_list,
    layer_slice,
    mlp_specs,
    mm,
    padded_vocab,
    remat,
    rms_norm,
)
from .lm import (_embed, _identity, _stack_specs, leaf, logits_fn,
                 tp_attention, tp_mlp, xent)
from .ssm import SSMCache, mamba2_forward, mamba2_specs


def _ssm_geometry(cfg):
    n_heads = cfg.n_heads
    head_dim = (2 * cfg.d_model) // n_heads  # expand=2
    return n_heads, head_dim, cfg.ssm_state


def param_specs(cfg):
    n_heads, head_dim, d_state = _ssm_geometry(cfg)
    mamba = {
        "ln": P((cfg.d_model,), ("embed",)),
        "ssm": mamba2_specs(cfg.d_model, n_heads, head_dim, d_state),
    }
    shared = {
        "ln_attn": P((2 * cfg.d_model,), ("embed",)),
        "attn": attention_specs(2 * cfg.d_model, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim_),
        "w_proj": P((2 * cfg.d_model, cfg.d_model), (None, "embed")),
        "ln_mlp": P((cfg.d_model,), ("embed",)),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
    }
    vp = padded_vocab(cfg.vocab)
    return {
        "embed": P((vp, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("embed",)),
        "mamba_layers": _stack_specs(mamba, cfg.n_layers),
        "shared_attn": shared,
        "lm_head": P((cfg.d_model, vp), ("embed", "vocab")),
    }


def _shared_block(params, x, x0, positions, cfg, constrain,
                  kv_cache=None, cache_index=None):
    """Shared attention over [x ; x0] -> project back to d_model."""
    tp = getattr(constrain, "tp", None)
    sp, spec = params["shared_attn"], None
    if tp is not None:
        spec = tp.specs["shared_attn"]
        sp = tp.gather_fsdp(sp, spec)
    cat = torch.cat([x, x0], dim=-1)
    a, new_kv = tp_attention(sp["attn"], rms_norm(cat, sp["ln_attn"]),
                             positions, tp, spec and spec["attn"],
                             causal=True, rope_theta=cfg.rope_theta,
                             kv_cache=kv_cache, cache_index=cache_index)
    x = constrain(x + mm(a, sp["w_proj"]), ("batch", None, "embed"))
    h = tp_mlp(sp["mlp"], rms_norm(x, sp["ln_mlp"]), tp, spec and spec["mlp"])
    return constrain(x + h, ("batch", None, "embed")), new_kv


def _groups(cfg):
    """Layer indices after which the shared block runs."""
    return [i for i in range(cfg.n_layers) if (i + 1) % cfg.attn_every == 0]


def forward(params, tokens, cfg, constrain=None, *, caches=None,
            cache_index=None):
    """Training forward (caches=None, the chunked SSD) or cached decode
    (the sequential recurrence).

    caches: {"ssm": SSMCache stacked (L, ...), "k"/"v": shared attn KV
    (A, B, KV, T, Dh)}, written in place (see the module doc).
    Returns (hidden, caches or None).
    """
    constrain = constrain or _identity
    tp = getattr(constrain, "tp", None)
    x = _embed(params, tokens, tp)
    x = constrain(x, ("batch", None, "embed"))
    x0 = x
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if cache_index is not None:
        positions = int(cache_index) + positions
    n_heads, head_dim, d_state = _ssm_geometry(cfg)
    attn_after = set(_groups(cfg))
    conv = state = None
    if caches is not None:
        conv, state = caches["ssm"].conv, caches["ssm"].state

    heads_tp = spec = None
    if tp is not None:
        spec = _layer_spec_tree(tp.specs["mamba_layers"])
        if tp.splits(spec["ssm"]["A_log"], 0):
            heads_tp = tp

    def mamba_body(lp, h, cache=None):
        if tp is not None:
            lp = tp.gather_fsdp(lp, spec)
        o, nc = mamba2_forward(
            lp["ssm"], rms_norm(h, lp["ln"]), n_heads=n_heads,
            head_dim=head_dim, d_state=d_state, cache=cache, tp=heads_tp)
        return constrain(h + o, ("batch", None, "embed")), nc

    if caches is None:   # training: remat over per-layer views
        body = remat(mamba_body, cfg.remat)
        layers = layer_list(params["mamba_layers"], cfg.n_layers)
    app = 0
    for i in range(cfg.n_layers):
        if caches is None:
            x, nc = body(layers[i], x)
        else:
            x, nc = mamba_body(layer_slice(params["mamba_layers"], i), x,
                               layer_slice(SSMCache(conv, state), i))
        if nc is not None:
            if nc.conv.dtype != conv.dtype:  # see the module doc
                conv = conv.to(nc.conv.dtype)
            conv[i].copy_(nc.conv)
            state[i].copy_(nc.state)
        if i in attn_after:
            kvc = (None if caches is None
                   else (caches["k"][app], caches["v"][app]))
            x, _kv = _shared_block(
                params, x, x0, positions, cfg, constrain,
                kv_cache=kvc, cache_index=cache_index)
            app += 1
    hidden = rms_norm(x, leaf(params, "ln_f", tp))
    if caches is None:
        return hidden, None
    return hidden, {"ssm": SSMCache(conv=conv, state=state),
                    "k": caches["k"], "v": caches["v"]}


def loss_fn(params, batch, cfg, constrain=None):
    """Next-token CE, differentiable by autograd."""
    hidden, _ = forward(params, batch["tokens"], cfg, constrain)
    return xent(logits_fn(params, hidden, cfg, constrain), batch, cfg,
                constrain)


def decode_step(params, tokens, caches, cache_index, cfg, constrain=None):
    """One decode step.  tokens: (B, 1); cache_index: int (the shared
    block's #valid KV entries).  Returns (logits (B, V), caches)."""
    hidden, caches = forward(params, tokens, cfg, constrain, caches=caches,
                             cache_index=cache_index)
    logits = logits_fn(params, hidden, cfg, constrain)[:, 0]
    return logits, caches


def cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """``init_caches``'s layout as ``meta`` tensors (no allocation)."""
    return init_caches(cfg, batch, max_len, dtype, device="meta")


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None):
    """Zero caches on ``device`` (cuda unless ``"cpu"``): the stacked
    SSM caches ``(L, B, 3, conv_ch)`` / ``(L, B, H, N, P)`` and the
    shared block's KV ``(A, B, KV, max_len, Dh)``."""
    dev = resolve_device(device)
    n_heads, head_dim, d_state = _ssm_geometry(cfg)
    conv_ch = n_heads * head_dim + 2 * d_state
    L = cfg.n_layers
    A = len(_groups(cfg))
    kv = (A, batch, cfg.n_kv, max_len, cfg.head_dim_)

    def z(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return {
        "ssm": SSMCache(conv=z((L, batch, 3, conv_ch)),
                        state=z((L, batch, n_heads, d_state, head_dim))),
        "k": z(kv),
        "v": z(kv),
    }
