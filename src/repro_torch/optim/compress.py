"""Error-feedback int8 gradient compression for cross-pod data parallelism.

The counterpart of ``repro.optim.compress``, op for op (bit for bit:
``torch.round`` rounds half to even, as ``jnp.round`` does).  At 1000+
nodes the DP all-reduce over the pod axis rides the slowest links;
int8 quantization with per-tensor scale cuts those bytes 4x (vs f32)
while error feedback keeps the optimizer trajectory unbiased:

    e_new = g + e_carry - dequant(quant(g + e_carry))

``ef_compress_update`` is applied to grads *before* the optimizer; the
residual state lives alongside the optimizer state and is shaped like
the params.
"""

from __future__ import annotations

import torch

from ..tree import leaves, tree_map, unflatten

__all__ = ["compress_decompress", "ef_compress_update", "residual_init"]


def compress_decompress(x, amax=None):
    """Symmetric per-tensor int8 quantize->dequantize (round-to-nearest).
    ``amax``: applied to the local max of ``|x|`` (a sharded tensor's
    max over its ranks); None: the max as it is."""
    xf = x.float()
    m = torch.max(torch.abs(xf))
    if amax is not None:
        m = amax(m)
    scale = torch.clamp(m, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.float() * scale, q, scale


@torch.no_grad()
def ef_compress_update(grads, residual, amax=None):
    """Returns (compressed grads to reduce, new residual); ``amax`` as
    ``compress_decompress``'s."""
    def one(g, e):
        corrected = g.float() + e
        deq, _, _ = compress_decompress(corrected, amax)
        return deq, corrected - deq

    outs = [one(g, e) for g, e in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def residual_init(params, abstract: bool = False):
    """f32 zeros shaped like the params; ``meta`` tensors (the dry
    run's) with ``abstract=True``."""
    return tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32,
        device="meta" if abstract else p.device), params)
