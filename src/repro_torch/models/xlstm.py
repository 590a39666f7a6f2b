"""xLSTM blocks (sLSTM + mLSTM), arXiv:2405.04517.

The counterpart of ``repro.models.xlstm``, op for op:

* mLSTM: matrix-memory cell with an exponential input gate and a
  stabiliser, in the same chunked form as the SSD (the decay is the
  cumulative forget gate) for a sequence, and the O(1) recurrence for
  decode;
* sLSTM: scalar-memory cell with *recurrent* weights, sequential over
  time in both branches (the paper: not parallelisable).

mLSTM blocks pre-up-project (factor 2) with SiLU gating; sLSTM blocks
post-project with a gated FFN (factor 4/3, GeLU with the tanh
approximation, ``jax.nn.gelu``'s default).  The inner maths run in
f32 (q, k, v and the gates are cast before the cells' einsums); the
projections of bf16 weights go through ``base.mm``.  A
three-operand ``einsum`` is contracted pairwise by torch, in another
order than XLA's: only f32 rounding moves.  ``jax.nn.log_sigmoid`` is
``F.logsigmoid``.  This is plain torch; the reference computes the
blocks in XLA, outside any Pallas kernel.

Under tensor parallelism (``tp``, a ``dist.partitioning.TensorParallel``,
with ``spec`` the block's ``PS`` tree) each block computes on the
rank's shards:

* mLSTM: ``w_up`` is split on its columns of ``[x, gate]`` and
  ``w_down`` on its rows of ``d_inner``; ``w_qkv``, ``w_if`` and
  ``norm_w`` are replicated.  The split up-projection is made whole over
  "model" (a rank's columns do not line up with the split into ``x``
  and ``gate``).  Where "model" divides the heads, each rank runs the
  cell on its heads (its columns of ``w_qkv`` and ``w_if``, its slice of
  the decode caches), normalises its ``d_inner`` rows with the sum of
  squares summed over "model" and multiplies by its rows of ``w_down``;
  the whole ``up`` each rank reads a part of is ``gather``ed (its grad
  summed, then sliced).  Where the guard keeps the heads whole
  (xlstm-125m's 4 on 16) the cell runs whole on every rank: ``up`` is
  made ``whole`` (the grad: the rank's slice) and the rank's rows of the
  gated output are ``split`` off for its rows of ``w_down``.  The
  partial output is reduced over "model";
* sLSTM: ``r_in`` is split on its heads, and each head's recurrence
  reads only its own columns of the replicated ``w_in``, so where
  "model" divides the heads each rank projects and runs its heads (its
  slice of the caches) and the output is made ``whole``; the GeGLU FFN
  is column- then row-parallel on "ffn" where "model" divides it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .base import P, mm, rms_norm, rms_norm_split

__all__ = ["MLSTMCache", "SLSTMCache", "mlstm_specs", "mlstm_forward",
           "slstm_specs", "slstm_forward", "init_mlstm_cache",
           "init_slstm_cache"]


class MLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, N, N) matrix memory (keys N = values N = head dim)
    n: torch.Tensor  # (B, H, N) normalizer
    m: torch.Tensor  # (B, H) stabilizer


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, N) cell
    n: torch.Tensor  # (B, H, N) normalizer
    h: torch.Tensor  # (B, H, N) hidden (recurrent input)
    m: torch.Tensor  # (B, H, N) stabilizer


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_specs(d_model: int, n_heads: int, expand: int = 2):
    d_inner = d_model * expand
    return {
        "w_up": P((d_model, 2 * d_inner), ("embed", "ffn")),  # [x, gate]
        "w_qkv": P((d_inner, 3 * d_inner), (None, "heads_x")),
        "w_if": P((d_inner, 2 * n_heads), (None, None), dtype=torch.float32),
        "norm_w": P((d_inner,), (None,)),
        "w_down": P((d_inner, d_model), ("ffn", "embed")),
    }


def _mlstm_cell_chunked(q, k, v, i_gate, f_gate, chunk: int):
    """Chunked stabilized mLSTM.  q/k/v: (B,S,H,N); gates (B,S,H) raw.

    Log-space cumulative forget gates; the within-chunk quadratic form
    and a sequential loop across chunks (the skeleton of
    ``ssm.ssd_chunked``), jointly stabilised by ``m_tot``.
    """
    B, S, H, N = q.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    G = S // chunk
    sq = math.sqrt(N)
    q, k, v = (t.reshape(B, G, chunk, *t.shape[2:]).float()
               for t in (q, k, v))
    logf = F.logsigmoid(f_gate).reshape(B, G, chunk, H)
    logi = i_gate.reshape(B, G, chunk, H).float()
    cumf = torch.cumsum(logf, dim=2)

    # within-chunk unnormalized weights: D_ts = exp(cumf_t - cumf_s + i_s)
    seg = (cumf[:, :, :, None, :] - cumf[:, :, None, :, :]
           + logi[:, :, None, :, :])
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, None, :, :, None]
    seg = torch.where(tri, seg, torch.full((), -math.inf, dtype=seg.dtype,
                                           device=seg.device))
    # stabilizer per (b,g,t,h): max over s and the carried chunk state
    m_intra = torch.amax(seg, dim=3)                  # (B,G,t,H)

    scores = torch.einsum("bgthn,bgshn->bgtsh", q, k) / sq

    # chunk summaries for the inter-chunk recurrence
    rem = cumf[:, :, -1:, :] - cumf + logi            # weight of step t in carry
    e_rem = torch.exp(rem)
    chunk_c = torch.einsum("bgthn,bgth,bgthm->bghnm", k, e_rem, v)
    chunk_n = torch.einsum("bgthn,bgth->bghn", k, e_rem)
    chunk_f = torch.exp(cumf[:, :, -1, :])            # (B,G,H)

    c = torch.zeros((B, H, N, N), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, N), dtype=torch.float32, device=q.device)
    c_prev, n_prev = [], []
    for g in range(G):
        c_prev.append(c)
        n_prev.append(n)
        c = c * chunk_f[:, g, :, None, None] + chunk_c[:, g]
        n = n * chunk_f[:, g, :, None] + chunk_n[:, g]
    c_prev = torch.stack(c_prev, dim=1)               # (B,G,H,N,N)
    n_prev = torch.stack(n_prev, dim=1)               # (B,G,H,N)

    # combine intra + inter with joint stabilization
    m_tot = torch.maximum(m_intra, cumf)              # inter weight is exp(cumf)
    w_intra = torch.exp(seg - m_tot[:, :, :, None, :])
    num_intra = torch.einsum("bgtsh,bgtsh,bgshn->bgthn", scores, w_intra, v)
    den_intra = torch.einsum("bgtsh,bgtsh->bgth", w_intra, scores)

    w_inter = torch.exp(cumf - m_tot)                 # (B,G,t,H)
    num_inter = torch.einsum("bgthn,bgth,bghnm->bgthm", q, w_inter,
                             c_prev) / sq
    den_inter = torch.einsum("bgthn,bgth,bghn->bgth", q, w_inter,
                             n_prev) / sq

    num = num_intra + num_inter
    den = den_intra + den_inter
    den = torch.maximum(torch.abs(den), torch.exp(-m_tot))  # max(|n|, e^-m)
    return (num / den[..., None]).reshape(B, S, H, N)


def _mlstm_up(params, x, tp, spec, per_head: bool):
    """``x @ w_up``, whole on every rank (see the module doc)."""
    if tp is None or not tp.splits(spec["w_up"], 1):
        up = mm(x, params["w_up"])
        return tp.copy(up) if per_head else up
    up = mm(tp.copy(x), params["w_up"])
    return tp.gather(up, tp.model, -1) if per_head else tp.whole(up, -1)


def mlstm_forward(params, x, *, n_heads, cache: Optional[MLSTMCache] = None,
                  chunk: int = 64, tp=None, spec=None):
    """x: (B, S, D).  Without ``cache`` the chunked form (S padded to a
    chunk multiple); with it the recurrence.  Returns (out, new cache or
    None), the new cache cast to the cache's dtypes.  ``tp`` / ``spec``:
    the rank's shards (see the module doc)."""
    B, S, D = x.shape
    per_head = (tp is not None and tp.model.size > 1
                and n_heads % tp.model.size == 0)
    up = _mlstm_up(params, x, tp, spec, per_head)
    xi, gate = torch.chunk(up, 2, dim=-1)
    d_inner = xi.shape[-1]
    N = d_inner // n_heads
    w_qkv, w_if = params["w_qkv"], params["w_if"]
    if per_head:   # this rank's heads: its columns of q, k, v and i, f
        n_heads //= tp.model.size
        lo, w = tp.model.rank * n_heads * N, n_heads * N
        w_qkv, w_if = tp.copy(w_qkv), tp.copy(w_if)
        w_qkv = torch.cat([w_qkv.narrow(1, j * d_inner + lo, w)
                           for j in range(3)], dim=1)
        w_if = w_if.narrow(1, 2 * tp.model.rank * n_heads, 2 * n_heads)
        if cache is not None and cache.m.shape[1] != n_heads:
            raise ValueError(f"an mLSTM cache of {cache.m.shape[1]} heads "
                             f"for a rank of {n_heads}")
    qkv = mm(xi, w_qkv)
    q, k, v = (t.reshape(B, S, n_heads, N)
               for t in torch.chunk(qkv, 3, dim=-1))
    gates = mm(xi, w_if).float()
    # i and f interleave per head: (..., H, 2), index 0 and index 1
    gates = gates.reshape(B, S, n_heads, 2)
    i_gate, f_gate = gates[..., 0], gates[..., 1]

    if cache is None:
        ch = min(chunk, S)
        if S % ch:
            padlen = ch - S % ch

            def p3(t):
                return F.pad(t, [0, 0, 0, 0, 0, padlen])

            def p2(t):
                return F.pad(t, [0, 0, 0, padlen])
            h = _mlstm_cell_chunked(p3(q), p3(k), p3(v), p2(i_gate),
                                    p2(f_gate), ch)[:, :S]
        else:
            h = _mlstm_cell_chunked(q, k, v, i_gate, f_gate, ch)
        new_cache = None
    else:
        sq = math.sqrt(N)
        c, n, m = cache.c.float(), cache.n.float(), cache.m.float()
        qf, kf, vf = q.float(), k.float(), v.float()
        hs = []
        for t in range(S):
            qt, kt, vt = qf[:, t], kf[:, t], vf[:, t]
            it, ft = i_gate[:, t], f_gate[:, t]
            logf = F.logsigmoid(ft)
            m_new = torch.maximum(logf + m, it)
            fi = torch.exp(logf + m - m_new)
            ii = torch.exp(it - m_new)
            # einsum("bhn,bhm->bhnm") is an outer product: one rounding
            c = (c * fi[:, :, None, None]
                 + ii[:, :, None, None] * (kt[..., :, None]
                                           * vt[..., None, :]) / sq)
            n = n * fi[:, :, None] + ii[:, :, None] * kt / sq
            num = torch.einsum("bhn,bhnm->bhm", qt, c)
            den = torch.maximum(
                torch.abs(torch.einsum("bhn,bhn->bh", qt, n)),
                torch.exp(-m_new))
            m = m_new
            hs.append(num / den[..., None])
        h = torch.stack(hs, dim=1)
        new_cache = MLSTMCache(c=c.to(cache.c.dtype), n=n.to(cache.n.dtype),
                               m=m.to(cache.m.dtype))

    h = h.reshape(B, S, n_heads * N).to(x.dtype)
    w_down = params["w_down"]
    down_split = tp is not None and tp.splits(spec["w_down"], 0)
    if per_head:   # the rank's rows of d_inner
        rows = (lo, w)
        h = rms_norm_split(h, tp.copy(params["norm_w"]).narrow(0, *rows),
                           tp, d_inner) * F.silu(gate.narrow(-1, *rows))
        if not down_split:
            w_down = tp.copy(w_down).narrow(0, *rows)
        return tp.reduce(mm(h, w_down)), new_cache
    h = rms_norm(h, params["norm_w"]) * F.silu(gate)
    if down_split:
        return tp.reduce(mm(tp.split(h, -1), w_down)), new_cache
    return mm(h, w_down), new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(d_model: int, n_heads: int):
    N = d_model // n_heads
    return {
        "w_in": P((d_model, 4 * d_model), ("embed", "heads_x")),  # z i f o
        "r_in": P((n_heads, N, 4 * N), ("heads", None, None)),    # recurrent
        "norm_w": P((d_model,), (None,)),
        # gated FFN (factor 4/3, GeGLU) per the paper's sLSTM block
        "w_ff_gate": P((d_model, 4 * d_model // 3), ("embed", "ffn")),
        "w_ff_up": P((d_model, 4 * d_model // 3), ("embed", "ffn")),
        "w_ff_down": P((4 * d_model // 3, d_model), ("ffn", "embed")),
    }


def slstm_forward(params, x, *, n_heads, cache: Optional[SLSTMCache] = None,
                  tp=None, spec=None):
    """Sequential sLSTM with recurrent weights + post FFN.  x: (B,S,D).
    Without ``cache`` the state starts at c = h = m = 0, n = 1.  ``tp`` /
    ``spec``: the rank's shards (see the module doc)."""
    B, S, D = x.shape
    N = D // n_heads
    per_head = tp is not None and tp.splits(spec["r_in"], 0)
    w_in = params["w_in"]
    if per_head:   # this rank's heads' columns of the input projection
        n_heads = params["r_in"].shape[0]
        x_in = tp.copy(x)
        w_in = tp.copy(w_in).narrow(1, tp.model.rank * n_heads * 4 * N,
                                    n_heads * 4 * N)
        if cache is not None and cache.c.shape[1] != n_heads:
            raise ValueError(f"an sLSTM cache of {cache.c.shape[1]} heads "
                             f"for a rank of {n_heads}")
    else:
        x_in = x
    zifo = mm(x_in, w_in).reshape(B, S, n_heads, 4 * N)

    if cache is None:
        def z():
            return torch.zeros((B, n_heads, N), dtype=torch.float32,
                               device=x.device)
        c, h, m = z(), z(), z()
        n = torch.ones((B, n_heads, N), dtype=torch.float32, device=x.device)
    else:
        c, n, h, m = (cache.c.float(), cache.n.float(), cache.h.float(),
                      cache.m.float())

    r_w = params["r_in"].float()
    hs = []
    for t in range(S):
        zifo_t = zifo[:, t].float()                   # (B, H, 4N)
        rec = torch.einsum("bhn,hnm->bhm", h, r_w)
        z_r, i_r, f_r, o_r = torch.chunk(zifo_t + rec, 4, dim=-1)
        zt = torch.tanh(z_r)
        o = torch.sigmoid(o_r)
        logf = F.logsigmoid(f_r)
        m_new = torch.maximum(logf + m, i_r)
        i = torch.exp(i_r - m_new)
        f = torch.exp(logf + m - m_new)
        c = f * c + i * zt
        n = f * n + i
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out_h = torch.stack(hs, dim=1).reshape(B, S, n_heads * N).to(x.dtype)
    if per_head:
        out_h = tp.whole(out_h, -1)
    out_h = rms_norm(out_h, params["norm_w"])
    ffn_split = tp is not None and tp.splits(spec["w_ff_gate"], 1)
    if ffn_split:
        out_h = tp.copy(out_h)
    ff = (F.gelu(mm(out_h, params["w_ff_gate"]), approximate="tanh")
          * mm(out_h, params["w_ff_up"]))
    out = mm(ff, params["w_ff_down"])
    if ffn_split:
        out = tp.reduce(out)
    new_cache = None
    if cache is not None:
        new_cache = SLSTMCache(c=c.to(cache.c.dtype), n=n.to(cache.n.dtype),
                               h=h.to(cache.h.dtype), m=m.to(cache.m.dtype))
    return out, new_cache


def init_mlstm_cache(batch, n_heads, head_dim, dtype=torch.float32,
                     device=None):
    dev = resolve_device(device)
    return MLSTMCache(
        c=torch.zeros((batch, n_heads, head_dim, head_dim), dtype=dtype,
                      device=dev),
        n=torch.zeros((batch, n_heads, head_dim), dtype=dtype, device=dev),
        m=torch.zeros((batch, n_heads), dtype=dtype, device=dev),
    )


def init_slstm_cache(batch, n_heads, head_dim, dtype=torch.float32,
                     device=None):
    dev = resolve_device(device)

    def z():
        return torch.zeros((batch, n_heads, head_dim), dtype=dtype,
                           device=dev)
    return SLSTMCache(c=z(), n=torch.ones_like(z()), h=z(), m=z())
