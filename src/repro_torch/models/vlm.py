"""InternVL2-2B: stub InternViT frontend + InternLM2-2B text backbone.

The counterpart of ``repro.models.vlm``.  The vision tower is a STUB as
in the reference: the batch carries precomputed patch embeddings
(B, n_patches, d_frontend); only the MLP projector (2-layer, as in
InternVL) and the LM backbone are real.  Patch tokens are prepended to
the text sequence; the loss is computed on the text positions only.
Decoding after the prefill is the LM's ``decode_step``.

Under a ``dist.partitioning.TensorParallel`` hook (``constrain.tp``)
the text embedding is the LM's vocab-parallel lookup, the backbone and
the logits are the LM's on the rank's shards and the loss the
vocab-parallel cross-entropy.  The projector's leaves are replicated
(their "embed" dims split only under FSDP, gathered over "data" at use),
so it runs whole on every rank's rows; the backbone's ``copy`` before
every split product makes the grads reaching it whole, and they are
summed over the batch axes only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import lm as _lm
from .base import P, mm, rms_norm


def param_specs(cfg):
    specs = _lm.param_specs(cfg)
    specs["projector"] = {
        "ln": P((cfg.d_frontend,), (None,)),
        "w1": P((cfg.d_frontend, cfg.d_model), (None, "embed")),
        "w2": P((cfg.d_model, cfg.d_model), ("embed", "embed")),
    }
    return specs


def _project(params, patches, tp=None):
    p = params["projector"]
    if tp is not None:
        p = tp.gather_fsdp(p, tp.specs["projector"])
    h = rms_norm(patches, p["ln"])
    return mm(F.gelu(mm(h, p["w1"]), approximate="tanh"), p["w2"])


def _embed(params, batch, tp=None):
    """Projected patches (cast to bf16, as the reference does) followed
    by the text embeddings; ``torch.cat`` promotes as
    ``jnp.concatenate`` does."""
    vis = _project(params, batch["patches"], tp).to(torch.bfloat16)
    txt = _lm._embed(params, batch["tokens"], tp)
    return vis, torch.cat([vis, txt], dim=1)


def loss_fn(params, batch, cfg, constrain=None):
    """batch: patches (B,P,Dv), tokens (B,S), labels (B,S)."""
    tp = getattr(constrain, "tp", None)
    vis, x = _embed(params, batch, tp)
    hidden = _lm.forward(params, None, cfg, constrain, embedded=x)
    n_p = vis.shape[1]
    logits = _lm.logits_fn(params, hidden[:, n_p:], cfg, constrain)
    return _lm.xent(logits, batch, cfg, constrain)


def prefill(params, batch, cache, cfg, constrain=None):
    """Multimodal prefill: patches + prompt tokens fill the cache."""
    _vis, x = _embed(params, batch, getattr(constrain, "tp", None))
    return _lm.prefill(params, None, cache, cfg, constrain, embedded=x)


decode_step = _lm.decode_step          # text-only decode after prefill
init_kv_cache = _lm.init_kv_cache
kv_cache_specs = _lm.kv_cache_specs
