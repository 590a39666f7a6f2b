"""Mamba-2 (SSD) block: the chunked state-space duality form and the
single-step decode recurrence.

The counterpart of ``repro.models.ssm``, op for op.  Within a chunk the
SSD is a masked product; across chunks a short loop carries the
``(B, H, N, P)`` state (the reference's ``lax.scan``).  Decode is the
O(1) recurrence over the cached (conv window, SSM state).  Scalar A per
head, SiLU-gated output, RMSNorm on the gate branch, a short causal
conv over x / B / C.

The inner maths run in f32 while the weights may be bf16: mixed
products go through ``base.mm`` / ``base.einsum`` (JAX promotes, torch
raises).  A three-operand ``einsum`` is contracted pairwise by torch,
in another order than XLA's: only f32 rounding moves.  This is plain
torch; the reference computes the block in XLA, outside any Pallas
kernel.

Under tensor parallelism (``tp``, a ``dist.partitioning.TensorParallel``,
given where the SSM heads are split over "model": ``A_log``, ``dt_bias``
and ``D`` are the rank's heads) each rank computes its heads: the
columns of the replicated ("heads_x") ``w_in`` that give its heads'
``z``, ``x`` and ``dt`` and the whole ``B`` and ``C`` (one group, which
every head reads), the short conv over its ``x`` channels and ``B``,
``C`` (its channels of the replicated ``conv_w``), the SSD on its heads
(in decode its own slice of the head-split state), the gated norm with
the sum of squares over ``d_inner`` summed over "model", and its rows
of ``w_out``; the partial output is reduced over "model".  The decode
conv cache is whole on every rank, so the new window's ``x`` channels
are all-gathered over "model" into it.  The replicated input and
weights that each rank uses a part of pass ``copy``, so their grads are
summed over "model".
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .base import P, einsum, mm, rms_norm, rms_norm_split

__all__ = ["SSMCache", "mamba2_specs", "ssd_chunked", "mamba2_forward",
           "init_ssm_cache"]


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_width_channels)
    state: torch.Tensor  # (B, H, N, P)


def mamba2_specs(d_model: int, n_heads: int, head_dim: int, d_state: int,
                 d_conv: int = 4, expand: int = 2):
    d_inner = n_heads * head_dim
    conv_ch = d_inner + 2 * d_state * 1  # x + B + C (single group)
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": P((d_model, 2 * d_inner + 2 * d_state + n_heads),
                  ("embed", "heads_x")),
        "conv_w": P((d_conv, conv_ch), (None, "heads_x")),
        "A_log": P((n_heads,), ("heads",), dtype=torch.float32),
        "dt_bias": P((n_heads,), ("heads",), dtype=torch.float32),
        "D": P((n_heads,), ("heads",), dtype=torch.float32),
        "norm_w": P((d_inner,), ("heads_x",)),
        "w_out": P((d_inner, d_model), ("heads_x", "embed")),
    }


def _split_proj(params, x, n_heads, head_dim, d_state):
    d_inner = n_heads * head_dim
    proj = mm(x, params["w_in"])
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * d_state,
                                    n_heads], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_state: Optional[torch.Tensor] = None):
    """Depthwise short causal conv over time.  xbc: (B, S, C_ch).  The
    new state is the last ``d_conv - 1`` rows of ``[pad; xbc]``, in the
    promoted dtype of the two (as ``jnp.concatenate`` gives it)."""
    d_conv = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], d_conv - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state
    dt = torch.promote_types(pad.dtype, xbc.dtype)
    xp = torch.cat([pad.to(dt), xbc.to(dt)], dim=1)
    S = xbc.shape[1]
    # left to right from the first tap, as the reference's ``sum``
    out = xp[:, 0:S, :] * conv_w[0][None, None, :]
    for i in range(1, d_conv):
        out = out + xp[:, i:i + S, :] * conv_w[i][None, None, :]
    new_state = xp[:, -(d_conv - 1):, :] if d_conv > 1 else pad
    return F.silu(out), new_state


def _proj_conv_tp(params, x, conv_state, tp, head_dim, d_inner, d_state):
    """The projection and the conv of this rank's heads (see the module
    doc): ``(xbc, new conv window, z, dt)``, ``xbc`` its ``x`` channels
    then ``B`` and ``C``, the window whole over the channels."""
    n = params["A_log"].shape[0]
    w = n * head_dim   # its heads' channels
    lo = tp.model.rank * w
    x = tp.copy(x)
    w_in = tp.copy(params["w_in"])
    dt0 = 2 * d_inner + 2 * d_state + tp.model.rank * n
    proj = mm(x, torch.cat([w_in.narrow(1, lo, w),
                            w_in.narrow(1, d_inner + lo, w),
                            w_in.narrow(1, 2 * d_inner, 2 * d_state),
                            w_in.narrow(1, dt0, n)], dim=1))
    z, xbc, dt = torch.split(proj, [w, w + 2 * d_state, n], dim=-1)
    conv_w = tp.copy(params["conv_w"])
    conv_w = torch.cat([conv_w.narrow(1, lo, w),
                        conv_w.narrow(1, d_inner, 2 * d_state)], dim=1)
    if conv_state is not None:   # the whole window's channels of mine
        conv_state = torch.cat([conv_state.narrow(-1, lo, w),
                                conv_state.narrow(-1, d_inner, 2 * d_state)],
                               dim=-1)
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_state)
    if conv_state is not None:   # every rank's x channels, then B and C
        new_conv = torch.cat([tp.whole(new_conv.narrow(-1, 0, w), -1),
                              new_conv.narrow(-1, w, 2 * d_state)], dim=-1)
    return xbc, new_conv, z, dt


def ssd_chunked(xh, b, c, dt_a, chunk: int):
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs, b/c: (B, S, N), dt_a: (B, S, H) in (0,1] decay
    per step (a_t = exp(-dt*A)); dt premultiplied into xh by the caller.
    Returns ((B, S, H, P) outputs, the (B, H, N, P) state at the end).
    """
    B, S, H, Pd = xh.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    G = S // chunk
    xh = xh.reshape(B, G, chunk, H, Pd).float()
    b = b.reshape(B, G, chunk, N)
    c = c.reshape(B, G, chunk, N)
    la = torch.log(dt_a.reshape(B, G, chunk, H).float())
    cum = torch.cumsum(la, dim=2)                     # log prod_{r<=t} a_r

    # intra-chunk: y_t = sum_{s<=t} (prod_{s<r<=t} a_r) (c_t.b_s) x_s
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,G,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    # masked BEFORE the exp: above the diagonal seg is the (positive)
    # log decay from s back to t, whose exp overflows to inf once a
    # chunk decays by more than e^88; the reference's where(tri,
    # exp(seg), 0) gives the same values but a 0 * inf = NaN gradient
    # there (ROADMAP queue C)
    L = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                              torch.full((), -math.inf, dtype=seg.dtype,
                                         device=seg.device)))
    gbc = einsum("bgtn,bgsn->bgts", c, b).float()
    y_intra = einsum("bgts,bgtsh,bgshp->bgthp", gbc, L, xh)

    # chunk summaries: state_g = sum_t (prod_{r>t} a_r) b_t x_t^T
    rem = cum[:, :, -1:, :] - cum                     # log prod_{r>t} a_r
    w = torch.exp(rem)                                # (B,G,t,H)
    chunk_state = einsum("bgtn,bgth,bgthp->bghnp", b, w, xh)
    chunk_decay = torch.exp(cum[:, :, -1, :])         # (B,G,H)

    # inter-chunk scan over G carrying the (B,H,N,P) state; h_prev[g] is
    # the state at the start of chunk g
    h = torch.zeros((B, H, N, Pd), dtype=torch.float32, device=xh.device)
    h_prev = []
    for g in range(G):
        h_prev.append(h)
        h = h * chunk_decay[:, g, :, None, None] + chunk_state[:, g]
    h_prev = torch.stack(h_prev, dim=1)               # (B,G,H,N,P)

    # inter contribution: y_t += (prod_{r<=t} a_r) c_t . h_start
    y_inter = einsum("bgtn,bgth,bghnp->bgthp", c, torch.exp(cum), h_prev)
    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    return y, h


def mamba2_forward(params, x, *, n_heads, head_dim, d_state, chunk=128,
                   cache: Optional[SSMCache] = None, tp=None):
    """Full block.  x: (B, S, D).  With ``cache`` performs decode (S small,
    sequential recurrence); returns (out, new_cache or None).  The new
    state is cast back to the cache's dtype (a bf16 round trip a step in
    a bf16 cache, as in the reference); the new conv window keeps the
    promoted dtype ``_causal_conv`` gives it.  ``tp``: the rank's SSM
    heads (see the module doc)."""
    B, S, D = x.shape
    d_inner = n_heads * head_dim
    conv_state = cache.conv if cache is not None else None
    if tp is None:
        z, xbc, dt = _split_proj(params, x, n_heads, head_dim, d_state)
        xbc, new_conv = _causal_conv(xbc, params["conv_w"], conv_state)
    else:
        xbc, new_conv, z, dt = _proj_conv_tp(params, x, conv_state, tp,
                                             head_dim, d_inner, d_state)
        n_heads = params["A_log"].shape[0]
        if cache is not None and cache.state.shape[1] != n_heads:
            raise ValueError(f"an SSM state of {cache.state.shape[1]} heads "
                             f"for a rank of {n_heads}")
    xi, b, c = torch.split(xbc, [n_heads * head_dim, d_state, d_state],
                           dim=-1)
    xh = xi.reshape(B, S, n_heads, head_dim)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where the two are equal in f32
    dt = F.softplus(dt.float() + params["dt_bias"])    # (B,S,H)
    a = torch.exp(-dt * torch.exp(params["A_log"]))    # per-step decay
    xh_dt = xh.float() * dt[..., None]

    if cache is None:
        ch = min(chunk, S)
        if S % ch != 0:  # pad sequence to a chunk multiple
            padlen = ch - S % ch

            def pad(t, value=0.0):
                return F.pad(t, [0, 0] * (t.ndim - 2) + [0, padlen],
                             value=value)
            y, _ = ssd_chunked(pad(xh_dt), pad(b), pad(c), pad(a, 1.0),
                               chunk=ch)
            y = y[:, :S]
        else:
            y, _ = ssd_chunked(xh_dt, b, c, a, chunk=ch)
        new_state = None  # training path does not emit state
    else:
        # sequential decode recurrence (S typically 1)
        h = cache.state.float()
        bf, cf = b.float(), c.float()
        ys = []
        for t in range(S):
            xt, bt, ct, at = xh_dt[:, t], bf[:, t], cf[:, t], a[:, t]
            # einsum("bn,bhp->bhnp") is an outer product: one rounding
            h = (h * at[:, :, None, None]
                 + bt[:, None, :, None] * xt[:, :, None, :])
            ys.append(torch.einsum("bn,bhnp->bhp", ct, h))
        y = torch.stack(ys, dim=1)                     # (B,S,H,P)
        new_state = h

    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, n_heads * head_dim).to(x.dtype)
    if tp is None:
        y = rms_norm(y * F.silu(z), params["norm_w"])
        out = mm(y, params["w_out"])
    else:   # the rank's rows of d_inner; the partial product reduced
        rows = (tp.model.rank * y.shape[-1], y.shape[-1])
        y = rms_norm_split(y * F.silu(z),
                           tp.copy(params["norm_w"]).narrow(0, *rows), tp,
                           d_inner)
        out = tp.reduce(mm(y, tp.copy(params["w_out"]).narrow(0, *rows)))
    if cache is None:
        return out, None
    return out, SSMCache(conv=new_conv,
                         state=new_state.to(cache.state.dtype))


def init_ssm_cache(batch: int, n_heads: int, head_dim: int, d_state: int,
                   d_conv: int = 4, dtype=torch.bfloat16,
                   device=None) -> SSMCache:
    """Zero caches on ``device`` (cuda unless ``"cpu"``)."""
    dev = resolve_device(device)
    conv_ch = n_heads * head_dim + 2 * d_state
    return SSMCache(
        conv=torch.zeros((batch, d_conv - 1, conv_ch), dtype=dtype,
                         device=dev),
        state=torch.zeros((batch, n_heads, d_state, head_dim), dtype=dtype,
                          device=dev),
    )
