"""AdamW with decoupled weight decay + global-norm clipping.

The counterpart of ``repro.optim.adamw``, line for line: ``m`` and
``v`` are f32 trees shaped like the params, ``step`` an int32 0-d
tensor; each param is updated in f32 and cast back to its own dtype
(no master copy).  ``torch.optim.AdamW`` is not this function: it
decays ``p`` before the step and adds ``eps`` outside the
bias-corrected root.

The update runs in place under ``torch.no_grad()`` (at full size the
trainer cannot hold a second copy of the params and moments): ``p``,
``m`` and ``v`` are overwritten leaf by leaf with the reference's
values, and the returned trees hold the same tensors.  ``m`` and ``v``
are updated by ``mul_`` then ``add_``, the reference's two roundings.
``abstract=True`` init returns ``meta`` tensors (shapes and dtypes, no
allocation) for the dry run, as the reference's ``ShapeDtypeStruct``s.
"""

from __future__ import annotations

import torch

from ..tree import leaves, tree_map

__all__ = ["adamw_init", "adamw_update", "global_norm"]


def adamw_init(params, abstract: bool = False):
    dev = torch.device("meta") if abstract else leaves(params)[0].device

    def mk(p):
        return torch.zeros(p.shape, dtype=torch.float32,
                           device=dev if abstract else p.device)

    return {
        "m": tree_map(mk, params),
        "v": tree_map(mk, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree):
    return torch.sqrt(sum(
        torch.sum(torch.square(x.float())) for x in leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0, gnorm=None):
    """Returns ``(params, state, gnorm)``; ``params``, ``state["m"]`` and
    ``state["v"]`` are updated in place (see the module doc).  ``gnorm``:
    the clip's global norm when the caller has it (a step that updates
    its leaves a few at a time passes the norm of all its grads);
    ``global_norm(grads)`` when None."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step

    def upd(g, m, v, p):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), leaves(params)):
        upd(g, m, v, p)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
