"""The port's xLSTM cells and xLSTM LM against the reference's on the
CPU: the same numpy inputs, the reference's params carried across with
``convert.model_params_from_reference``.  Tolerances as stated at the
top of ``tests/test_torch_ssm.py``: functions in f32 within ``atol``
1e-5, whole models in f32 within 1e-4 with equal argmax and the caches
leaf by leaf, bf16 held to the f32 run within twice the reference's
error.

``reduced(xlstm-125m)`` has 2 layers, both mLSTM (the sLSTM is block 7
of every 8), so the sLSTM is tested directly, both branches, and the
whole model runs at ``n_layers=8``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models import xlstm as rxl
from repro.models import xlstm_lm as rxlm
from repro.models.base import init_params as ref_init
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import build_model
from repro_torch.models import xlstm as pxl
from repro_torch.models import xlstm_lm as pxlm
from test_torch_ssm import (F32_FN_ATOL, F32_MODEL_ATOL, KEY, _close, _np,
                            _port_params, _t, same_caches, whole_model_case)


def _params(rng, spec):
    """f32 params of unit-scale activations: 1/sqrt(fan_in) normals."""
    out = {}
    for k, s in spec.items():
        fan = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        out[k] = (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(
            np.float32)
    return out


def _tt(p):
    return {k: _t(v) for k, v in p.items()}


def _mlstm_cache(rng, B, H, N, ref):
    c = (rng.standard_normal((B, H, N, N)) * 0.3).astype(np.float32)
    n = (rng.standard_normal((B, H, N)) * 0.3).astype(np.float32)
    m = rng.standard_normal((B, H)).astype(np.float32)
    return (rxl.MLSTMCache(c, n, m) if ref
            else pxl.MLSTMCache(_t(c), _t(n), _t(m)))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(8, 8), (24, 8)])
def test_mlstm_cell_chunked(S, chunk):
    rng = np.random.default_rng(1)
    B, H, N = 2, 3, 8
    q, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)
    want = jax.jit(rxl._mlstm_cell_chunked, static_argnums=5)(
        q, k, v, ig, fg, chunk)
    got = pxl._mlstm_cell_chunked(_t(q), _t(k), _t(v), _t(ig), _t(fg), chunk)
    _close(got, want, F32_FN_ATOL)


@pytest.mark.parametrize("S,chunk", [(16, 4), (13, 4), (5, 64)])
def test_mlstm_forward_chunked(S, chunk):
    """The chunked branch: S a chunk multiple, not one (padded), and
    shorter than the chunk."""
    rng = np.random.default_rng(2)
    p = _params(rng, rxl.mlstm_specs(32, 4))
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    want, _ = jax.jit(functools.partial(rxl.mlstm_forward, n_heads=4,
                                        chunk=chunk))(p, x)
    got, none = pxl.mlstm_forward(_tt(p), _t(x), n_heads=4, chunk=chunk)
    assert none is None
    _close(got, want, F32_FN_ATOL)


@pytest.mark.parametrize("S", [1, 3])
def test_mlstm_forward_decode(S):
    """The recurrence from a non-zero cache: output and new cache."""
    rng = np.random.default_rng(3)
    p = _params(rng, rxl.mlstm_specs(32, 4))
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    want, wc = jax.jit(functools.partial(rxl.mlstm_forward, n_heads=4))(
        p, x, cache=_mlstm_cache(np.random.default_rng(9), 2, 4, 16, True))
    got, gc = pxl.mlstm_forward(
        _tt(p), _t(x), n_heads=4,
        cache=_mlstm_cache(np.random.default_rng(9), 2, 4, 16, False))
    _close(got, want, F32_FN_ATOL)
    assert isinstance(gc, pxl.MLSTMCache)
    same_caches(gc, wc, F32_FN_ATOL)


def test_mlstm_gates_interleave_per_head():
    """``w_if``'s columns are (i, f) per head, interleaved: column 1 is
    head 0's forget gate.  Driven to -inf (batch row 0) it empties head
    0's memory, whose new value is then the step's own ``k v^T /
    sqrt(N)`` (i = 0, so ``m`` = 0 and the input weight 1), while head
    1's keeps a share of its old memory."""
    rng = np.random.default_rng(4)
    p = _params(rng, rxl.mlstm_specs(32, 4))
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    xi = (x @ p["w_up"])[0, 0, :64]
    p["w_if"][:] = 0.0
    p["w_if"][:, 1] = -1e4 * np.sign(xi)
    old = _mlstm_cache(np.random.default_rng(9), 2, 4, 16, False)
    old = pxl.MLSTMCache(old.c, old.n, torch.zeros_like(old.m))
    _, gc = pxl.mlstm_forward(_tt(p), _t(x), n_heads=4, cache=old)
    qkv = xi @ p["w_qkv"]
    k0, v0 = qkv[64:80], qkv[128:144]
    np.testing.assert_allclose(gc.c[0, 0].numpy(),
                               np.outer(k0, v0) / 4.0, rtol=1e-5, atol=1e-6)
    assert float((gc.c[0, 1] - old.c[0, 1]).abs().max()) > 1e-3
    assert float(torch.corrcoef(torch.stack(
        [gc.c[0, 1].ravel(), old.c[0, 1].ravel()]))[0, 1]) > 0.5


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_cache(rng, B, H, N, ref):
    c, h, m = (rng.standard_normal((B, H, N)).astype(np.float32)
               for _ in range(3))
    n = rng.uniform(0.5, 2.0, (B, H, N)).astype(np.float32)
    return (rxl.SLSTMCache(c, n, h, m) if ref
            else pxl.SLSTMCache(_t(c), _t(n), _t(h), _t(m)))


@pytest.mark.parametrize("S,cached", [(7, False), (1, True), (3, True)])
def test_slstm_forward(S, cached):
    """Both branches: from the initial state (n = 1) over a sequence,
    and from a non-zero cache."""
    rng = np.random.default_rng(5)
    p = _params(rng, rxl.slstm_specs(32, 4))
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    rc = _slstm_cache(np.random.default_rng(6), 2, 4, 8, True) if cached \
        else None
    pc = _slstm_cache(np.random.default_rng(6), 2, 4, 8, False) if cached \
        else None
    want, wc = jax.jit(functools.partial(rxl.slstm_forward, n_heads=4))(
        p, x, cache=rc)
    got, gc = pxl.slstm_forward(_tt(p), _t(x), n_heads=4, cache=pc)
    _close(got, want, F32_FN_ATOL)
    if cached:
        assert isinstance(gc, pxl.SLSTMCache)
        same_caches(gc, wc, F32_FN_ATOL)
    else:
        assert gc is None and wc is None


# ---------------------------------------------------------------------------
# chunked against sequential, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_mlstm_chunked_matches_sequential(dtype):
    """The case of ``tests/test_models_smoke.py::
    test_mlstm_chunked_matches_sequential`` run on the port (its params
    and input carried across): bf16 at the reference's tolerance, f32
    at the model tolerance."""
    p = ref_init(rxl.mlstm_specs(32, 4), KEY)
    x = jax.random.normal(KEY, (2, 16, 32), jnp.float32).astype(jnp.bfloat16)
    tdt = getattr(torch, dtype)
    pp = _port_params(p, None if dtype == "bfloat16" else torch.float32)
    px = _t(_np(x)).to(tdt)
    y_par, _ = pxl.mlstm_forward(pp, px, n_heads=4, chunk=4)
    cache = pxl.init_mlstm_cache(2, 4, 16, device="cpu")
    y_seq, _ = pxl.mlstm_forward(pp, px, n_heads=4, cache=cache)
    tol = 1e-1 if dtype == "bfloat16" else F32_MODEL_ATOL
    np.testing.assert_allclose(y_par.float().numpy(), y_seq.float().numpy(),
                               atol=tol, rtol=tol if tol > 1e-3 else 0)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------


def test_block_kinds_and_caches_match_reference():
    for n_layers in (2, 8, 12):
        cfg = dataclasses.replace(ARCHS["xlstm-125m"], n_layers=n_layers)
        rcfg = dataclasses.replace(REF_ARCHS["xlstm-125m"], n_layers=n_layers)
        assert pxlm.block_kinds(cfg) == rxlm.block_kinds(rcfg)
    assert pxlm.block_kinds(ARCHS["xlstm-125m"]).index("slstm") == 7
    cfg = dataclasses.replace(reduced(ARCHS["xlstm-125m"]), n_layers=8)
    rcfg = dataclasses.replace(ref_reduced(REF_ARCHS["xlstm-125m"]),
                               n_layers=8)
    got = build_model(cfg).init_caches(3, 64, device="cpu")
    want = ref_build(rcfg).init_caches(3, 64)
    same_caches(got, want, 0.0)
    assert float(got["b7"].n.min()) == 1.0
    assert pxlm.SLSTM_EVERY == rxlm.SLSTM_EVERY == 8


def test_reduced_xlstm_matches_reference():
    """``reduced`` as it is (two mLSTM blocks): loss and two decode
    steps, f32 within 1e-4 and bf16, the caches leaf by leaf."""
    got, _want = whole_model_case("xlstm-125m")
    assert sorted(got) == ["b0", "b1"]


def test_reduced_xlstm_with_its_slstm_block_matches_reference():
    """Eight blocks, so block 7 is the sLSTM: loss and two decode steps,
    f32 and bf16, the caches leaf by leaf.  At this depth the random-init
    stack is sensitive: the reference's own logits move by more than
    1e-4 when its f32 params move by one ulp, and the port's errors grow
    block by block the same way.  So the f32 bound is the larger of
    1e-4 and twice that measured spread
    (``whole_model_case(chaotic=True)``)."""
    got, _want = whole_model_case("xlstm-125m", n_layers=8, chaotic=True)
    assert isinstance(got["b7"], pxl.SLSTMCache)
    assert isinstance(got["b0"], pxl.MLSTMCache)
