"""Adafactor-style optimizer: factored second moment + bf16 momentum.

The counterpart of ``repro.optim.adafactor``, line for line.  For
>=2-D params the second moment is stored as row/col means (O(n+m)
instead of O(nm)); momentum is bf16.  This is what makes the
kimi-k2-1t-a32b training state fit the 2-pod mesh:
  fp32 Adam  : 16 B/param -> 16 TB        (impossible)
  this       : 2 (bf16 param) + 2 (bf16 m) + ~0 (factored v) ≈ 4 B/param.

As ``adamw_update``, the update runs in place under ``torch.no_grad()``:
each param and slot is overwritten with the reference's value.
``abstract=True`` init returns ``meta`` tensors for the dry run.
"""

from __future__ import annotations

import torch

from ..tree import leaf_paths, leaves, unflatten
from .adamw import global_norm

__all__ = ["adafactor_init", "adafactor_update"]


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params, abstract: bool = False):
    def mk(p):
        def a(shape, dtype):
            return torch.zeros(tuple(shape), dtype=dtype,
                               device="meta" if abstract else p.device)

        shape = tuple(p.shape)
        if _factored(shape):
            return {
                "vr": a(shape[:-1], torch.float32),   # row second moment
                "vc": a(shape[:-2] + shape[-1:], torch.float32),
                "m": a(shape, torch.bfloat16),
            }
        return {"v": a(shape, torch.float32), "m": a(shape, torch.bfloat16)}

    flat = leaves(params)
    # each param leaf becomes a slot dict (the reference's tree.map)
    return {
        "slots": unflatten(params, [mk(p) for p in flat]),
        "step": torch.zeros((), dtype=torch.int32,
                            device="meta" if abstract else flat[0].device),
    }


def _mean(t, dim, pdim, keepdim=False):
    return torch.mean(t, dim=dim, keepdim=keepdim)


@torch.no_grad()
def adafactor_update(grads, state, params, *, lr, b1=0.9, decay=0.99,
                     eps=1e-30, weight_decay=0.0, clip_norm=1.0, gnorm=None,
                     mean=None):
    """Returns ``(params, state, gnorm)``, updated in place; ``gnorm``
    as in ``adamw_update``.  ``mean(t, dim, pdim, keepdim=False)``
    takes the factored moments' means: over ``dim`` of ``t``, which is
    the param's dim ``pdim``; ``torch.mean`` when None (a sharded step
    passes one that also averages over the ranks ``pdim`` is split
    over)."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    mean = mean or _mean

    def upd(g, slot, p):
        g = g.float() * scale
        g2 = g * g + eps
        if "vr" in slot:
            vr, vc = slot["vr"], slot["vc"]
            vr.mul_(decay).add_((1 - decay) * mean(g2, -1, -1))
            vc.mul_(decay).add_((1 - decay) * mean(g2, -2, -2))
            denom = torch.sqrt(
                vr[..., :, None] * vc[..., None, :]
                / torch.clamp(mean(vr, -1, -2, keepdim=True)[..., None],
                              min=eps))
            u = g / torch.clamp(denom, min=eps)
        else:
            v = slot["v"]
            v.mul_(decay).add_((1 - decay) * g2)
            u = g / (torch.sqrt(v) + 1e-8)
        m = b1 * slot["m"].float() + (1 - b1) * u
        slot["m"].copy_(m.to(torch.bfloat16))
        delta = m + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    for (path, p), g in zip(leaf_paths(params), leaves(grads)):
        slot = state["slots"]
        for k in path:   # the param's slot dict, found by its path
            slot = slot[k]
        upd(g, slot, p)
    return params, {"slots": state["slots"], "step": step}, gnorm
