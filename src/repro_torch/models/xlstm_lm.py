"""xLSTM-125M language model: residual blocks, mLSTM:sLSTM = 7:1 (the
sLSTM is block 7 of every 8, the rest mLSTM); ``d_ff`` = 0 (the blocks
carry their own projections).

The counterpart of ``repro.models.xlstm_lm``.  The caches are a dict
keyed ``b{i}``; a decode step puts each block's new cache into the
dict it was given (updated in place, where the reference returns a new
dict) and returns it.

Under a ``dist.partitioning.TensorParallel`` hook (``constrain.tp``)
the params are each rank's shards: the vocab-parallel embedding, logits
and cross-entropy of ``lm.py``, and each block on its shards
(``xlstm.py``'s module doc), its FSDP leaves gathered over "data" at
use; the caches are the rank's heads where "model" divides them.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .base import P, padded_vocab, rms_norm
from .lm import _embed, _identity, leaf, logits_fn, xent
from .xlstm import (
    MLSTMCache,
    SLSTMCache,
    mlstm_forward,
    mlstm_specs,
    slstm_forward,
    slstm_specs,
)

SLSTM_EVERY = 8  # one sLSTM block per 8 (≈7:1 per the paper's 125M recipe)


def block_kinds(cfg):
    return ["slstm" if (i % SLSTM_EVERY) == SLSTM_EVERY - 1 else "mlstm"
            for i in range(cfg.n_layers)]


def param_specs(cfg):
    blocks = {}
    for i, kind in enumerate(block_kinds(cfg)):
        cell = (mlstm_specs(cfg.d_model, cfg.n_heads) if kind == "mlstm"
                else slstm_specs(cfg.d_model, cfg.n_heads))
        blocks[f"b{i}"] = {"ln": P((cfg.d_model,), ("embed",)), "cell": cell}
    vp = padded_vocab(cfg.vocab)
    return {
        "embed": P((vp, cfg.d_model), ("vocab", "embed")),
        "ln_f": P((cfg.d_model,), ("embed",)),
        "blocks": blocks,
        "lm_head": P((cfg.d_model, vp), ("embed", "vocab")),
    }


def forward(params, tokens, cfg, constrain=None, *, caches=None):
    """Returns (hidden, caches or None); see the module doc."""
    constrain = constrain or _identity
    tp = getattr(constrain, "tp", None)
    x = _embed(params, tokens, tp)
    x = constrain(x, ("batch", None, "embed"))
    for i, kind in enumerate(block_kinds(cfg)):
        bp, kw = params["blocks"][f"b{i}"], {}
        if tp is not None:
            spec = tp.specs["blocks"][f"b{i}"]
            bp = tp.gather_fsdp(bp, spec)
            kw = {"tp": tp, "spec": spec["cell"]}
        h = rms_norm(x, bp["ln"])
        cache = None if caches is None else caches[f"b{i}"]
        cell = mlstm_forward if kind == "mlstm" else slstm_forward
        o, nc = cell(bp["cell"], h, n_heads=cfg.n_heads, cache=cache, **kw)
        x = constrain(x + o, ("batch", None, "embed"))
        if nc is not None:
            caches[f"b{i}"] = nc
    return rms_norm(x, leaf(params, "ln_f", tp)), caches


def loss_fn(params, batch, cfg, constrain=None):
    """Next-token CE, differentiable by autograd (no remat: the
    reference's xLSTM has none)."""
    hidden, _ = forward(params, batch["tokens"], cfg, constrain)
    return xent(logits_fn(params, hidden, cfg, constrain), batch, cfg,
                constrain)


def decode_step(params, tokens, caches, cache_index, cfg, constrain=None):
    """One decode step; ``cache_index`` is unused (the recurrent state
    carries the position).  Returns (logits (B, V), caches)."""
    del cache_index
    hidden, caches = forward(params, tokens, cfg, constrain, caches=caches)
    logits = logits_fn(params, hidden, cfg, constrain)[:, 0]
    return logits, caches


def cache_specs(cfg, batch: int, max_len: int = 0, dtype=None):
    """Recurrent caches as ``meta`` tensors (max_len unused)."""
    return init_caches(cfg, batch, max_len, dtype, device="meta")


def init_caches(cfg, batch: int, max_len: int = 0, dtype=None, device=None):
    """Recurrent caches, O(1) in sequence length (``max_len`` and
    ``dtype`` unused: f32 always, as in the reference), zeros but the
    sLSTM normaliser ``n`` = 1, on ``device`` (cuda unless ``"cpu"``)."""
    dev = resolve_device(device)
    d_inner = cfg.d_model * 2
    n_m = d_inner // cfg.n_heads  # mLSTM head dim (post up-projection)
    n_s = cfg.d_model // cfg.n_heads

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    caches = {}
    for i, kind in enumerate(block_kinds(cfg)):
        if kind == "mlstm":
            caches[f"b{i}"] = MLSTMCache(c=z(batch, cfg.n_heads, n_m, n_m),
                                         n=z(batch, cfg.n_heads, n_m),
                                         m=z(batch, cfg.n_heads))
        else:
            s = (batch, cfg.n_heads, n_s)
            caches[f"b{i}"] = SLSTMCache(c=z(*s), n=z(*s) + 1.0, h=z(*s),
                                         m=z(*s))
    return caches
