"""The port's Mamba-2 block and Zamba2 hybrid against the reference's on
the CPU: the same numpy inputs, the reference's params carried across
with ``convert.model_params_from_reference``.

Tolerances, stated once (those of ``tests/test_torch_models.py``):

* functions in f32: ``atol`` 1e-5 (inputs of unit scale; the two
  packages contract the three-operand einsums in different orders);
* whole ``reduced`` models in f32 (params and caches f32): loss, logits
  and every cache leaf after each step within ``atol`` 1e-4, equal
  argmax;
* whole models in bf16: each package held to the f32 run of the same
  weights, the port within twice the reference's error (the rule at
  the top of ``tests/test_torch_models.py``).

Also the port's own chunked-vs-sequential consistency (the case of
``tests/test_models_smoke.py::test_ssd_chunked_matches_sequential``),
and ``base.layer_slice`` over NamedTuples.
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
from repro.models import ssm as rssm
from repro.models import zamba as rzamba
from repro.models.base import init_params as ref_init
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import model_params_from_reference
from repro_torch.models import base as pbase
from repro_torch.models import build_model
from repro_torch.models import ssm as pssm
from repro_torch.models import zamba as pzamba

F32_FN_ATOL = 1e-5
F32_MODEL_ATOL = 1e-4
BF16_STEP = 2.0 ** -8
BF16_STEPS = 8
BF16_SPACING = 2.0 ** -7   # the largest bf16 spacing relative to a value
KEY = jax.random.PRNGKey(0)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, _np(want), rtol=0, atol=atol)


def _port_params(ref_params, dtype=None):
    return model_params_from_reference(jax.tree.map(np.asarray, ref_params),
                                       device="cpu", dtype=dtype)


def tree_items(tree, path=()):
    """(path, leaf) of a cache tree: dicts by sorted key, NamedTuples by
    field name, other tuples by position; the same walk for both
    packages' caches."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from tree_items(getattr(tree, f), path + (f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def same_caches(got, want, atol, scale_rel=0.0):
    """Leaf by leaf: the same paths, shapes and dtypes, values within
    ``atol`` plus ``scale_rel`` times the leaf's largest magnitude; a
    bf16 leaf (the state cast back each step) also within one bf16
    spacing of the value (``BF16_SPACING``): f32 values a few roundings
    apart may round to neighbouring bf16 numbers."""
    g, w = dict(tree_items(got)), dict(tree_items(want))
    assert list(g) == list(w)
    for path in g:
        assert tuple(g[path].shape) == tuple(w[path].shape), path
        name = str(g[path].dtype).split(".")[-1]
        assert name == jnp.dtype(w[path].dtype).name, path
        want_np = _np(w[path])
        np.testing.assert_allclose(
            g[path].float().numpy(), want_np,
            atol=atol + scale_rel * float(np.abs(want_np).max()),
            rtol=BF16_SPACING if name == "bfloat16" else 0, err_msg=path)


def cast_caches(tree, ref):
    """Every floating leaf to f32 (numpy-side template for both)."""
    if ref:
        return jax.tree.map(lambda a: a.astype(jnp.float32), tree)
    if isinstance(tree, dict):
        return {k: cast_caches(v, False) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(cast_caches(v, False) for v in tree))
    return tree.float()


# ---------------------------------------------------------------------------
# layer_slice
# ---------------------------------------------------------------------------


def test_layer_slice_walks_namedtuples_and_keeps_dicts():
    conv = torch.arange(3 * 2 * 5, dtype=torch.float32).reshape(3, 2, 5)
    state = torch.arange(3 * 4, dtype=torch.float32).reshape(3, 4)
    got = pbase.layer_slice(pssm.SSMCache(conv=conv, state=state), 1)
    assert isinstance(got, pssm.SSMCache)
    assert torch.equal(got.conv, conv[1]) and torch.equal(got.state, state[1])
    # a dict of stacked params (and a NamedTuple inside one) as before
    tree = {"a": conv, "b": {"c": state},
            "ssm": pssm.SSMCache(conv=conv, state=state)}
    got = pbase.layer_slice(tree, 2)
    assert sorted(got) == ["a", "b", "ssm"]
    assert torch.equal(got["a"], conv[2])
    assert torch.equal(got["b"]["c"], state[2])
    assert torch.equal(got["ssm"].state, state[2])
    # a bare tensor is indexed
    assert torch.equal(pbase.layer_slice(state, 0), state[0])


# ---------------------------------------------------------------------------
# functions, f32
# ---------------------------------------------------------------------------


def _mamba_params(rng, d, h, p, n, d_conv=4):
    """f32 params of unit-scale activations: projections 1/sqrt(fan_in),
    the A / dt / D vectors at the reference's init scale."""
    spec = rssm.mamba2_specs(d, h, p, n, d_conv)
    out = {}
    for k, s in spec.items():
        fan = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        out[k] = (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.5).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) if with_state \
        else None
    want_y, want_s = rssm._causal_conv(xbc, w, st)
    got_y, got_s = pssm._causal_conv(_t(xbc), _t(w),
                                     None if st is None else _t(st))
    _close(got_y, want_y, F32_FN_ATOL)
    _close(got_s, want_s, F32_FN_ATOL)
    assert got_s.shape == (2, 3, 24)


@pytest.mark.parametrize("S,chunk", [(16, 16), (24, 8)])
def test_ssd_chunked(S, chunk):
    rng = np.random.default_rng(2)
    B, H, Pd, N = 2, 3, 8, 5
    xh = rng.standard_normal((B, S, H, Pd)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    a = rng.uniform(0.3, 1.0, (B, S, H)).astype(np.float32)
    want_y, want_h = jax.jit(rssm.ssd_chunked, static_argnums=4)(
        xh, b, c, a, chunk)
    got_y, got_h = pssm.ssd_chunked(_t(xh), _t(b), _t(c), _t(a), chunk)
    _close(got_y, want_y, F32_FN_ATOL)
    _close(got_h, want_h, F32_FN_ATOL)


@pytest.mark.parametrize("S,chunk", [(24, 8), (21, 8), (5, 128)])
def test_mamba2_forward_chunked(S, chunk):
    """The chunked branch, S a chunk multiple, not one (padded, the
    decay padded with 1.0), and shorter than the chunk."""
    rng = np.random.default_rng(3)
    p = _mamba_params(rng, 32, 4, 16, 8)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    want, _ = jax.jit(functools.partial(
        rssm.mamba2_forward, n_heads=4, head_dim=16, d_state=8,
        chunk=chunk))(p, x)
    got, none = pssm.mamba2_forward({k: _t(v) for k, v in p.items()}, _t(x),
                                    n_heads=4, head_dim=16, d_state=8,
                                    chunk=chunk)
    assert none is None
    _close(got, want, F32_FN_ATOL)


@pytest.mark.parametrize("S", [1, 3])
def test_mamba2_forward_decode(S):
    """The sequential branch from a non-zero cache: output, new conv
    window and new state."""
    rng = np.random.default_rng(4)
    p = _mamba_params(rng, 32, 4, 16, 8)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 4 * 16 + 16)).astype(np.float32)
    state = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    want, wc = jax.jit(functools.partial(
        rssm.mamba2_forward, n_heads=4, head_dim=16, d_state=8))(
        p, x, cache=rssm.SSMCache(conv, state))
    got, gc = pssm.mamba2_forward({k: _t(v) for k, v in p.items()}, _t(x),
                                  n_heads=4, head_dim=16, d_state=8,
                                  cache=pssm.SSMCache(_t(conv), _t(state)))
    _close(got, want, F32_FN_ATOL)
    assert isinstance(gc, pssm.SSMCache)
    _close(gc.conv, wc.conv, F32_FN_ATOL)
    _close(gc.state, wc.state, F32_FN_ATOL)


def test_decode_state_round_trips_through_the_cache_dtype():
    """A bf16 cache: the new state is cast back to bf16 (as the
    reference does), the conv window keeps the activations' f32."""
    rng = np.random.default_rng(5)
    p = _mamba_params(rng, 32, 4, 16, 8)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    rc = rssm.init_ssm_cache(2, 4, 16, 8, dtype=jnp.bfloat16)
    pc = pssm.init_ssm_cache(2, 4, 16, 8, dtype=torch.bfloat16, device="cpu")
    _, wc = rssm.mamba2_forward(p, x, n_heads=4, head_dim=16, d_state=8,
                                cache=rc)
    _, gc = pssm.mamba2_forward({k: _t(v) for k, v in p.items()}, _t(x),
                                n_heads=4, head_dim=16, d_state=8, cache=pc)
    same_caches(gc, wc, F32_FN_ATOL)
    assert gc.state.dtype == torch.bfloat16 and gc.conv.dtype == torch.float32


# ---------------------------------------------------------------------------
# chunked against sequential, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_ssd_chunked_matches_sequential(dtype):
    """The reference's consistency case run on the port (its params and
    input carried across): bf16 at the reference's tolerance, f32 at the
    model tolerance."""
    p = ref_init(rssm.mamba2_specs(32, 4, 16, 8), KEY)
    x = jax.random.normal(KEY, (2, 24, 32), jnp.float32).astype(jnp.bfloat16)
    tdt = getattr(torch, dtype)
    pp = _port_params(p, None if dtype == "bfloat16" else torch.float32)
    px = _t(_np(x)).to(tdt)
    y_par, _ = pssm.mamba2_forward(pp, px, n_heads=4, head_dim=16, d_state=8,
                                   chunk=8)
    cache = pssm.init_ssm_cache(2, 4, 16, 8, dtype=torch.float32,
                                device="cpu")
    y_seq, _ = pssm.mamba2_forward(pp, px, n_heads=4, head_dim=16,
                                   d_state=8, cache=cache)
    tol = 8e-2 if dtype == "bfloat16" else F32_MODEL_ATOL
    np.testing.assert_allclose(y_par.float().numpy(), y_seq.float().numpy(),
                               atol=tol, rtol=tol if tol > 1e-3 else 0)


# ---------------------------------------------------------------------------
# the whole reduced model: loss and two decode steps
# ---------------------------------------------------------------------------


def model_outputs(model, params, batch, caches, decode_tokens, ref):
    """[loss, decode logits x 2] as f32 numpy, and the caches after each
    decode step (the port's cloned: its steps write in place)."""
    loss_fn, decode_fn = model.loss_fn, model.decode_fn
    if ref:  # the reference runs as it serves: jitted
        loss_fn, decode_fn = jax.jit(loss_fn), jax.jit(decode_fn)
    outs = [np.float32(loss_fn(params, batch))]
    after = []
    for idx, tok in enumerate(decode_tokens):
        if ref:
            lg, caches = decode_fn(params, {"tokens": jnp.asarray(tok)},
                                   caches, jnp.int32(idx))
            outs.append(_np(lg))
            after.append(caches)
        else:
            lg, caches = decode_fn(params, {"tokens": _t(tok).long()},
                                   caches, idx)
            outs.append(lg.float().numpy())
            after.append(clone_tree(caches))
    return outs, after


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(clone_tree(v) for v in tree))
    return tree.clone()


def ulp_spread(rm, rp32, rb, caches, toks, draws=2):
    """How far the reference's own f32 outputs (loss, logits and every
    cache leaf after each step) move when each of its f32 params is
    perturbed by one unit in the last place (relative 2^-23 normal
    noise): the largest absolute change over ``draws`` draws."""
    want, after = model_outputs(rm, rp32, rb, caches, toks, True)
    leaves, tdef = jax.tree.flatten(rp32)
    spread = 0.0
    for d in range(draws):
        keys = jax.random.split(jax.random.PRNGKey(100 + d), len(leaves))
        pert = jax.tree.unflatten(tdef, [
            a * (1 + 2.0 ** -23 * jax.random.normal(k, a.shape))
            for a, k in zip(leaves, keys)])
        got, g_after = model_outputs(rm, pert, rb, caches, toks, True)
        spread = max([spread] + [float(np.abs(g - w).max())
                                 for g, w in zip(got, want)])
        for ga, wa in zip(g_after, after):
            spread = max([spread] + [
                float(np.abs(_np(a) - _np(b)).max())
                for (_, a), (_, b) in zip(tree_items(ga), tree_items(wa))])
    return spread


def whole_model_case(arch, n_layers=None, B=8, S=10, T=32,
                     chaotic=False):
    """Loss and two decode steps of ``reduced(arch)`` (``n_layers`` when
    given) in f32 and in bf16, against the reference (see the module
    doc).  ``chaotic``: the f32 bound is the larger of 1e-4 and twice
    ``ulp_spread``, for a stack deep enough that the reference itself
    moves more than 1e-4 under a one-ulp change of its params (the
    rounding of another summation order is such a change).  Returns the
    f32 caches of both after the last step."""
    rcfg, cfg = ref_reduced(REF_ARCHS[arch]), reduced(ARCHS[arch])
    if n_layers is not None:
        rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rm, pm = ref_build(rcfg), build_model(cfg)
    assert pm.param_count() == rm.param_count()
    rp16 = rm.init_params(jax.random.PRNGKey(7))
    rp32 = jax.tree.map(lambda a: a.astype(jnp.float32), rp16)
    pp16, pp32 = _port_params(rp16), _port_params(rp16, torch.float32)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    toks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
            for _ in range(2)]
    rb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    pb = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}

    # f32: tight, caches leaf by leaf after each step
    rcache32 = cast_caches(rm.init_caches(B, T), True)
    want32, rc32 = model_outputs(rm, rp32, rb, rcache32, toks, True)
    got32, pc32 = model_outputs(
        pm, pp32, pb, cast_caches(pm.init_caches(B, T, device="cpu"), False),
        toks, False)
    atol = F32_MODEL_ATOL
    if chaotic:
        atol = max(atol, 2 * ulp_spread(rm, rp32, rb, rcache32, toks))
    assert len(got32) == len(want32) == 3
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        if np.ndim(w):
            assert np.array_equal(g.argmax(-1), w.argmax(-1))
    for g, w in zip(pc32, rc32):
        same_caches(g, w, atol)

    # bf16 (the served dtypes): each package against the f32 run
    want16, rc16 = model_outputs(rm, rp16, rb, rm.init_caches(B, T), toks,
                                 True)
    got16, pc16 = model_outputs(pm, pp16, pb,
                                pm.init_caches(B, T, device="cpu"), toks,
                                False)
    for g, w in zip(pc16, rc16):  # paths, shapes and dtypes as served
        assert [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
                for p, t in tree_items(g)] == [
            (p, tuple(t.shape), jnp.dtype(t.dtype).name)
            for p, t in tree_items(w)]
    step = BF16_STEPS * BF16_STEP
    assert abs(got16[0] - want32[0]) <= (
        2 * abs(want16[0] - want32[0]) + step * abs(want32[0]))
    flat = [np.concatenate([np.ravel(o) for o in outs[1:]])
            for outs in (got16, want16, want32)]
    port_err, ref_err = np.abs(flat[0] - flat[2]), np.abs(flat[1] - flat[2])
    assert port_err.mean() <= 2 * ref_err.mean(), (arch, ref_err.mean())
    assert port_err.max() <= (2 * ref_err.max()
                              + step * np.abs(flat[2]).max()), arch
    return pc32[-1], rc32[-1]


def test_reduced_zamba_matches_reference():
    whole_model_case("zamba2-1.2b")


def test_zamba_groups_and_a_deeper_stack():
    """4 layers at ``attn_every`` 2: two shared-block applications with
    their own KV caches, Mamba layers between them."""
    cfg = dataclasses.replace(reduced(ARCHS["zamba2-1.2b"]), n_layers=4,
                              attn_every=2)
    assert pzamba._groups(cfg) == [1, 3]
    rcfg = dataclasses.replace(ref_reduced(REF_ARCHS["zamba2-1.2b"]),
                               n_layers=4, attn_every=2)
    rm, pm = ref_build(rcfg), build_model(cfg)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      rm.init_params(jax.random.PRNGKey(3)))
    ref_decode = jax.jit(rm.decode_fn)
    pp = _port_params(rp)
    rng = np.random.default_rng(12)
    toks = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
            for _ in range(3)]
    rc = cast_caches(rm.init_caches(2, 16), True)
    pc = cast_caches(pm.init_caches(2, 16, device="cpu"), False)
    assert pc["k"].shape == (2, 2, cfg.n_kv, 16, cfg.head_dim_)
    for i, tok in enumerate(toks):
        lr, rc = ref_decode(rp, {"tokens": jnp.asarray(tok)}, rc,
                            jnp.int32(i))
        lp, pc = pm.decode_fn(pp, {"tokens": _t(tok).long()}, pc, i)
        _close(lp, lr, F32_MODEL_ATOL)
        same_caches(pc, rc, F32_MODEL_ATOL)


def test_f32_params_promote_a_bf16_conv_cache_as_the_reference():
    """f32 params over the default bf16 caches (the serving engine's
    case): after a step the reference's conv cache is f32 (the promoted
    window), its SSM state bf16; the port's caches agree leaf by leaf,
    dtypes included, over three steps.  Each step reads bf16 state and
    KV, where one f32 rounding apart can round to the neighbouring bf16
    number, so the logits and every leaf are held within 8 bf16 steps
    of their scale, the argmax equal."""
    rcfg, cfg = (ref_reduced(REF_ARCHS["zamba2-1.2b"]),
                 reduced(ARCHS["zamba2-1.2b"]))
    rm, pm = ref_build(rcfg), build_model(cfg)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      rm.init_params(jax.random.PRNGKey(5)))
    ref_decode = jax.jit(rm.decode_fn)
    pp = _port_params(rp)
    rc, pc = rm.init_caches(4, 16), pm.init_caches(4, 16, device="cpu")
    rng = np.random.default_rng(13)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
        lr, rc = ref_decode(rp, {"tokens": jnp.asarray(tok)}, rc,
                            jnp.int32(i))
        lp, pc = pm.decode_fn(pp, {"tokens": _t(tok).long()}, pc, i)
        _close(lp, lr, BF16_STEPS * BF16_STEP * float(np.abs(_np(lr)).max()))
        assert np.array_equal(lp.numpy().argmax(-1), _np(lr).argmax(-1))
        same_caches(pc, rc, F32_MODEL_ATOL, BF16_STEPS * BF16_STEP)
    assert pc["ssm"].conv.dtype == torch.float32
    assert pc["ssm"].state.dtype == torch.bfloat16
    assert pc["k"].dtype == torch.bfloat16


def test_zamba_caches_are_written_in_place():
    """Decode writes into the stacked cache tensors (no per-step stack)
    when the dtypes already agree."""
    cfg = reduced(ARCHS["zamba2-1.2b"])
    model = build_model(cfg)
    prm = model.init_params(torch.Generator().manual_seed(0), "cpu")
    caches = model.init_caches(2, 16, device="cpu")
    ptrs = [t.data_ptr() for _, t in tree_items(caches)]
    tok = torch.zeros((2, 1), dtype=torch.long)
    _, out = model.decode_fn(prm, {"tokens": tok}, caches, 0)
    assert [t.data_ptr() for _, t in tree_items(out)] == ptrs
    assert float(out["ssm"].state.float().abs().sum()) > 0
    assert float(out["k"][:, :, :, 0].float().abs().sum()) > 0
    assert float(out["k"][:, :, :, 1:].float().abs().sum()) == 0
    assert rzamba._groups(cfg) == pzamba._groups(cfg) == [0, 1]
