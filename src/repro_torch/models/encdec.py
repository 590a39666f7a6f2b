"""Whisper-style encoder-decoder (audio frontend stubbed, as in the
reference).

The counterpart of ``repro.models.encdec``.  Encoder: bidirectional
self-attention over precomputed frame embeddings (the conv stem is a
stub: the batch supplies (B, F, D) frames).  Decoder: causal
self-attention + cross-attention to the encoder output.  Serving: the
decoder step with a self-KV cache and a precomputed cross-KV.  The
encoder and decoder layer bodies of ``loss_fn`` run under ``cfg.remat``
(``base.remat``), as the reference's at ``encdec.py:67,121``.
"""

from __future__ import annotations

import torch

from .base import (
    P,
    attention_specs,
    einsum,
    gqa_attention,
    layer_list,
    layer_slice,
    mlp,
    mlp_specs,
    padded_vocab,
    remat,
    rms_norm,
    softmax_xent,
)
from .lm import _identity, _positions, _stack_specs, logits_fn


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


def encode(params, frames, cfg, constrain):
    """frames: (B, F, D) stub frame embeddings -> encoder states."""
    x = frames + params["pos_enc"][None, : frames.shape[1]]
    x = constrain(x, ("batch", None, "embed"))
    B, F = x.shape[0], x.shape[1]
    positions = _positions(B, F, x.device)

    def body(lp, h):
        a, _ = gqa_attention(lp["attn"], rms_norm(h, lp["ln_attn"]),
                             positions, causal=False,
                             rope_theta=cfg.rope_theta)
        h = constrain(h + a, ("batch", None, "embed"))
        return h + mlp(lp["mlp"], rms_norm(h, lp["ln_mlp"]))

    body = remat(body, cfg.remat)
    for lp in layer_list(params["enc_layers"], cfg.n_enc_layers):
        x = body(lp, x)
    return rms_norm(x, params["ln_enc"])


def _cross_kv(lp, enc_out):
    k = einsum("bfd,dhk->bhfk", enc_out, lp["cross"]["wk"])
    v = einsum("bfd,dhk->bhfk", enc_out, lp["cross"]["wv"])
    return k, v


def _dec_layer(cfg, constrain, lp, x, positions, enc_out=None,
               kv_cache=None, cache_index=None, cross_kv=None):
    a, new_kv = gqa_attention(lp["attn"], rms_norm(x, lp["ln_attn"]),
                              positions, causal=True,
                              rope_theta=cfg.rope_theta,
                              kv_cache=kv_cache, cache_index=cache_index)
    x = constrain(x + a, ("batch", None, "embed"))
    if cross_kv is None:
        cross_kv = _cross_kv(lp, enc_out)
    c, _ = gqa_attention(lp["cross"], rms_norm(x, lp["ln_cross"]), positions,
                         causal=False, rope_theta=cfg.rope_theta,
                         kv_override=cross_kv)
    x = constrain(x + c, ("batch", None, "embed"))
    h = mlp(lp["mlp"], rms_norm(x, lp["ln_mlp"]))
    return constrain(x + h, ("batch", None, "embed")), new_kv


def loss_fn(params, batch, cfg, constrain=None):
    """batch: frames (B,F,D), tokens (B,S), labels (B,S) [, mask]."""
    constrain = constrain or _identity
    enc_out = encode(params, batch["frames"], cfg, constrain)
    x = params["embed"][batch["tokens"]]
    x = constrain(x, ("batch", None, "embed"))
    B, S = x.shape[0], x.shape[1]
    positions = _positions(B, S, x.device)

    def body(lp, h):
        return _dec_layer(cfg, constrain, lp, h, positions,
                          enc_out=enc_out)[0]

    body = remat(body, cfg.remat)
    for lp in layer_list(params["dec_layers"], cfg.n_layers):
        x = body(lp, x)
    hidden = rms_norm(x, params["ln_f"])
    logits = logits_fn(params, hidden, cfg, constrain)
    return softmax_xent(logits, batch["labels"], batch.get("mask"))


def decode_step(params, tokens, caches, cache_index, cfg, constrain=None):
    """One decoder step.  caches: {"k","v" (L,B,KV,T,Dh), "ck","cv"
    (L,B,KV,F,Dh) precomputed cross-KV}; each layer writes its keys and
    values into its slice of ``caches["k"]`` / ``caches["v"]``."""
    constrain = constrain or _identity
    x = params["embed"][tokens]
    x = constrain(x, ("batch", None, "embed"))
    B = x.shape[0]
    positions = torch.full((B, 1), int(cache_index), dtype=torch.long,
                           device=x.device)
    for i in range(cfg.n_layers):
        x, _ = _dec_layer(cfg, constrain,
                          layer_slice(params["dec_layers"], i), x, positions,
                          kv_cache=(caches["k"][i], caches["v"][i]),
                          cache_index=cache_index,
                          cross_kv=(caches["ck"][i], caches["cv"][i]))
    hidden = rms_norm(x, params["ln_f"])
    logits = logits_fn(params, hidden, cfg, constrain)[:, 0]
    return logits, dict(caches)
