"""Whisper-style encoder-decoder (audio frontend stubbed, as in the
reference).

The counterpart of ``repro.models.encdec``.  Encoder: bidirectional
self-attention over precomputed frame embeddings (the conv stem is a
stub: the batch supplies (B, F, D) frames).  Decoder: causal
self-attention + cross-attention to the encoder output.  Serving: the
decoder step with a self-KV cache and a precomputed cross-KV.  The
encoder and decoder layer bodies of ``loss_fn`` run under ``cfg.remat``
(``base.remat``), as the reference's at ``encdec.py:67,121``.

Under a ``dist.partitioning.TensorParallel`` hook (``constrain.tp``)
the params are each rank's shards, as in ``lm.py``: the token embedding
is the vocab-parallel lookup, every attention (the encoder's, the
decoder's self- and cross-attention) runs on the rank's heads and the
MLPs on its "ffn" columns, each reduced over "model" before the
residual add; the logits are the rank's vocab columns and the loss the
vocab-parallel cross-entropy.  Where the divisibility guard keeps the
heads whole (whisper-base's 8 on a "model" axis of 16) the attention
runs whole on every rank.  The cross-attention's keys and values are
projected outside ``gqa_attention``: where its query heads are split,
the encoder output enters every rank's heads, so it passes ``copy``
once (its grad summed over "model"), and whole ``wk`` / ``wv`` (KV
heads the guard kept whole) pass ``copy`` too.  In decode the cross
caches ``ck`` / ``cv`` are the rank's KV heads where the self-KV caches
are.
"""

from __future__ import annotations

import torch

from ..dist.partitioning import layer_specs as _layer_spec_tree
from .base import (
    P,
    attention_specs,
    einsum,
    layer_list,
    layer_slice,
    mlp_specs,
    padded_vocab,
    remat,
    rms_norm,
)
from .lm import (_embed, _identity, _positions, _stack_specs, leaf,
                 logits_fn, tp_attention, tp_mlp, xent)


def _enc_layer_specs(cfg):
    return {
        "ln_attn": P((cfg.d_model,), ("embed",)),
        "ln_mlp": P((cfg.d_model,), ("embed",)),
        "attn": attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim_),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, gated=False),
    }


def _dec_layer_specs(cfg):
    s = _enc_layer_specs(cfg)
    s["ln_cross"] = P((cfg.d_model,), ("embed",))
    s["cross"] = attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                 cfg.head_dim_)
    return s


def param_specs(cfg):
    vp = padded_vocab(cfg.vocab)
    return {
        "embed": P((vp, cfg.d_model), ("vocab", "embed")),
        "pos_enc": P((cfg.n_frontend_tokens, cfg.d_model), (None, "embed")),
        "ln_enc": P((cfg.d_model,), ("embed",)),
        "ln_f": P((cfg.d_model,), ("embed",)),
        "enc_layers": _stack_specs(_enc_layer_specs(cfg), cfg.n_enc_layers),
        "dec_layers": _stack_specs(_dec_layer_specs(cfg), cfg.n_layers),
        "lm_head": P((cfg.d_model, vp), ("embed", "vocab")),
    }


def _tp(constrain, name):
    """``(tp, spec)``: the hook's ``TensorParallel`` (None without one)
    and the per-layer ``PS`` tree of the stack ``name``."""
    tp = getattr(constrain, "tp", None)
    if tp is None:
        return None, None
    return tp, _layer_spec_tree(tp.specs[name])


def encode(params, frames, cfg, constrain):
    """frames: (B, F, D) stub frame embeddings -> encoder states."""
    tp, spec = _tp(constrain, "enc_layers")
    x = frames + leaf(params, "pos_enc", tp)[None, : frames.shape[1]]
    x = constrain(x, ("batch", None, "embed"))
    B, F = x.shape[0], x.shape[1]
    positions = _positions(B, F, x.device)

    def body(lp, h):
        if tp is not None:
            lp = tp.gather_fsdp(lp, spec)
        a, _ = tp_attention(lp["attn"], rms_norm(h, lp["ln_attn"]),
                            positions, tp, spec and spec["attn"],
                            causal=False, rope_theta=cfg.rope_theta)
        h = constrain(h + a, ("batch", None, "embed"))
        return h + tp_mlp(lp["mlp"], rms_norm(h, lp["ln_mlp"]), tp,
                          spec and spec["mlp"])

    body = remat(body, cfg.remat)
    for lp in layer_list(params["enc_layers"], cfg.n_enc_layers):
        x = body(lp, x)
    return rms_norm(x, leaf(params, "ln_enc", tp))


def _cross_split(tp, spec) -> bool:
    """Whether the cross-attention's query heads are split."""
    return tp is not None and tp.splits(spec["cross"]["wq"], 1)


def _cross_kv(lp, enc_out, tp=None, spec=None):
    """The cross-attention's keys and values from the encoder output;
    under split query heads the rank's KV heads, or all of them from
    whole weights (``copy``: each rank's heads use a part)."""
    wk, wv = lp["cross"]["wk"], lp["cross"]["wv"]
    if _cross_split(tp, spec) and not tp.splits(spec["cross"]["wk"], 1):
        wk, wv = tp.copy(wk), tp.copy(wv)
    k = einsum("bfd,dhk->bhfk", enc_out, wk)
    v = einsum("bfd,dhk->bhfk", enc_out, wv)
    return k, v


def _dec_layer(cfg, constrain, lp, x, positions, enc_out=None,
               kv_cache=None, cache_index=None, cross_kv=None, spec=None):
    """One decoder layer; under ``constrain.tp`` on the rank's shards
    ``lp`` (``spec`` their per-layer ``PS`` tree)."""
    tp = getattr(constrain, "tp", None)
    if tp is not None:
        lp = tp.gather_fsdp(lp, spec)
    a, new_kv = tp_attention(lp["attn"], rms_norm(x, lp["ln_attn"]),
                             positions, tp, spec and spec["attn"],
                             causal=True, rope_theta=cfg.rope_theta,
                             kv_cache=kv_cache, cache_index=cache_index)
    x = constrain(x + a, ("batch", None, "embed"))
    if cross_kv is None:
        cross_kv = _cross_kv(lp, enc_out, tp, spec)
    c, _ = tp_attention(lp["cross"], rms_norm(x, lp["ln_cross"]), positions,
                        tp, spec and spec["cross"], causal=False,
                        rope_theta=cfg.rope_theta, kv_override=cross_kv)
    x = constrain(x + c, ("batch", None, "embed"))
    h = tp_mlp(lp["mlp"], rms_norm(x, lp["ln_mlp"]), tp, spec and spec["mlp"])
    return constrain(x + h, ("batch", None, "embed")), new_kv


def loss_fn(params, batch, cfg, constrain=None):
    """batch: frames (B,F,D), tokens (B,S), labels (B,S) [, mask]."""
    constrain = constrain or _identity
    tp, spec = _tp(constrain, "dec_layers")
    enc_out = encode(params, batch["frames"], cfg, constrain)
    if _cross_split(tp, spec):   # every rank's heads read it
        enc_out = tp.copy(enc_out)
    x = _embed(params, batch["tokens"], tp)
    x = constrain(x, ("batch", None, "embed"))
    B, S = x.shape[0], x.shape[1]
    positions = _positions(B, S, x.device)

    def body(lp, h):
        return _dec_layer(cfg, constrain, lp, h, positions,
                          enc_out=enc_out, spec=spec)[0]

    body = remat(body, cfg.remat)
    for lp in layer_list(params["dec_layers"], cfg.n_layers):
        x = body(lp, x)
    hidden = rms_norm(x, leaf(params, "ln_f", tp))
    logits = logits_fn(params, hidden, cfg, constrain)
    return xent(logits, batch, cfg, constrain)


def decode_step(params, tokens, caches, cache_index, cfg, constrain=None):
    """One decoder step.  caches: {"k","v" (L,B,KV,T,Dh), "ck","cv"
    (L,B,KV,F,Dh) precomputed cross-KV}; each layer writes its keys and
    values into its slice of ``caches["k"]`` / ``caches["v"]``.  Under
    ``constrain.tp`` the params and caches are the rank's shards and
    the logits its vocab columns."""
    constrain = constrain or _identity
    tp, spec = _tp(constrain, "dec_layers")
    x = _embed(params, tokens, tp)
    x = constrain(x, ("batch", None, "embed"))
    B = x.shape[0]
    positions = torch.full((B, 1), int(cache_index), dtype=torch.long,
                           device=x.device)
    for i in range(cfg.n_layers):
        x, _ = _dec_layer(cfg, constrain,
                          layer_slice(params["dec_layers"], i), x, positions,
                          kv_cache=(caches["k"][i], caches["v"][i]),
                          cache_index=cache_index,
                          cross_kv=(caches["ck"][i], caches["cv"][i]),
                          spec=spec)
    hidden = rms_norm(x, leaf(params, "ln_f", tp))
    logits = logits_fn(params, hidden, cfg, constrain)[:, 0]
    return logits, dict(caches)
