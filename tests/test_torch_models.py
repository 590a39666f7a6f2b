"""The port's model substrate and models against the reference's on the
CPU: the same numpy inputs, and the reference's params carried across
leaf for leaf with ``convert.model_params_from_reference``.

Tolerances, stated once:

* layers in f32: ``atol`` 1e-5 (inputs of unit scale; the two packages
  sum in different orders);
* whole models in f32 (``reduced`` configs, params cast to f32, f32 KV
  caches): logits and loss within ``atol`` 1e-4 (their scale is <= 4,
  so about 2^-15 relative), and equal argmax;
* whole models in bf16: the reference's compiled graph keeps f32
  intermediates inside its fusions where torch rounds after every op,
  and these random-init models amplify a bf16 rounding (2^-8 relative)
  into logit errors of several bf16 steps in BOTH packages, the larger
  in either one from row to row.  So each package is held to an f32
  run of the same (bf16-valued) weights, over all logits of the run
  (8 rows of prefill and both decode steps): the port's mean absolute
  error at most twice the reference's, its largest error at most twice
  the reference's largest plus 8 bf16 steps (8 * 2^-8) of the largest
  |logit|; the loss within twice the reference's error plus 8 steps of
  the loss.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES
from repro.configs import reduced as ref_reduced
from repro.models import base as rbase
from repro.models import build_model as ref_build
from repro.models import lm as rlm
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import model_params_from_reference
from repro_torch.models import base as pbase
from repro_torch.models import build_model
from repro_torch.models import lm as plm

F32_LAYER_ATOL = 1e-5
F32_MODEL_ATOL = 1e-4
BF16_STEP = 2.0 ** -8
BF16_STEPS = 8
PARITY_ARCHS = ("internlm2-1.8b", "yi-9b", "granite-moe-1b-a400m",
                "internvl2-2b", "whisper-base")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, _np(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# layers, f32
# ---------------------------------------------------------------------------


def _attn_params(rng, d, h, kv, dh, bias):
    p = {"wq": rng.standard_normal((d, h, dh)) / np.sqrt(d),
         "wk": rng.standard_normal((d, kv, dh)) / np.sqrt(d),
         "wv": rng.standard_normal((d, kv, dh)) / np.sqrt(d),
         "wo": rng.standard_normal((h, dh, d)) / np.sqrt(h * dh)}
    if bias:
        p.update(bq=rng.standard_normal((h, dh)) * 0.1,
                 bk=rng.standard_normal((kv, dh)) * 0.1,
                 bv=rng.standard_normal((kv, dh)) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_norm_rope_mlp_xent_mask():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    _close(pbase.rms_norm(_t(x), _t(w)), rbase.rms_norm(x, w),
           F32_LAYER_ATOL)
    xh = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7)).copy()
    for theta in (10_000.0, 1e6):
        _close(pbase.rope(_t(xh), _t(pos), theta),
               rbase.rope(xh, pos, theta), F32_LAYER_ATOL)
    for gated in (True, False):
        mp = {k: (rng.standard_normal(p.shape) / np.sqrt(p.shape[0])
                  ).astype(np.float32)
              for k, p in rbase.mlp_specs(64, 128, gated).items()}
        _close(pbase.mlp({k: _t(v) for k, v in mp.items()}, _t(x)),
               rbase.mlp(mp, x), F32_LAYER_ATOL)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    _close(pbase.softmax_xent(_t(logits), _t(labels)),
           rbase.softmax_xent(logits, labels), F32_LAYER_ATOL)
    _close(pbase.softmax_xent(_t(logits), _t(labels), _t(mask)),
           rbase.softmax_xent(logits, labels, mask), F32_LAYER_ATOL)
    assert np.array_equal(pbase.causal_additive_mask(_t(pos)).numpy(),
                          _np(rbase.causal_additive_mask(pos)))
    assert np.array_equal(
        pbase.causal_additive_mask(_t(pos[:, -1:]), T=16, cache_index=9,
                                   S=1).numpy(),
        _np(rbase.causal_additive_mask(pos[:, -1:], 16, jnp.int32(9), 1)))
    assert pbase.padded_vocab(92_544) == rbase.padded_vocab(92_544) == 92_672


@pytest.mark.parametrize("bias", [False, True])
def test_gqa_attention(bias):
    """Without a cache (causal and not), into a cache at an index that
    fits and at one the write must clamp (dynamic_update_slice clamps
    its start), and as cross-attention with ``kv_override``; f32 and a
    bf16 cache under f32 queries (the promotion JAX does)."""
    rng = np.random.default_rng(1 + bias)
    B, S, D, H, KV, DH, T = 2, 5, 64, 4, 2, 16, 12
    prm = _attn_params(rng, D, H, KV, DH, bias)
    pp = {k: _t(v) for k, v in prm.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    for causal in (True, False):
        got, _ = pbase.gqa_attention(pp, _t(x), _t(pos), causal=causal)
        want, _ = rbase.gqa_attention(prm, x, pos, causal=causal)
        _close(got, want, F32_LAYER_ATOL)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        for idx in (3, T - 2):  # the second write clamps to T - S
            ck = rng.standard_normal((B, KV, T, DH)).astype(np.float32)
            cv = rng.standard_normal((B, KV, T, DH)).astype(np.float32)
            rc = (jnp.asarray(ck).astype(dt), jnp.asarray(cv).astype(dt))
            pc = (_t(ck).to(tdt), _t(cv).to(tdt))
            p2 = pos + idx
            want, (wk, wv) = rbase.gqa_attention(
                prm, x, p2, kv_cache=rc, cache_index=jnp.int32(idx))
            got, (gk, gv) = pbase.gqa_attention(
                pp, _t(x), _t(p2), kv_cache=pc, cache_index=idx)
            atol = F32_LAYER_ATOL if tdt == torch.float32 else 1e-2
            _close(got, want, atol)
            _close(gk, wk, atol)
            _close(gv, wv, atol)
    enc_k = rng.standard_normal((B, KV, 9, DH)).astype(np.float32)
    enc_v = rng.standard_normal((B, KV, 9, DH)).astype(np.float32)
    want, none = rbase.gqa_attention(prm, x, pos, causal=False,
                                     kv_override=(enc_k, enc_v))
    got, _ = pbase.gqa_attention(pp, _t(x), _t(pos), causal=False,
                                 kv_override=(_t(enc_k), _t(enc_v)))
    assert none is None
    _close(got, want, F32_LAYER_ATOL)


# ---------------------------------------------------------------------------
# specs, counts, init, the facade
# ---------------------------------------------------------------------------


def _ref_spec_leaves(tree, path=()):
    if isinstance(tree, rbase.P):
        return {path: (tuple(tree.shape), jnp.dtype(tree.dtype).name)}
    out = {}
    for k in tree:
        out.update(_ref_spec_leaves(tree[k], path + (k,)))
    return out


@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHS.items()
                                        if c.arch in ("lm", "vlm", "encdec",
                                                      "zamba", "xlstm")))
def test_specs_and_counts_match_reference(arch):
    for cfg, rcfg in ((ARCHS[arch], REF_ARCHS[arch]),
                      (reduced(ARCHS[arch]), ref_reduced(REF_ARCHS[arch]))):
        model, ref = build_model(cfg), ref_build(rcfg)
        leaves = {}
        pbase.map_specs(lambda path, p: leaves.update(
            {path: (tuple(p.shape), str(p.dtype).split(".")[-1])}),
            model.param_specs())
        assert leaves == _ref_spec_leaves(ref.param_specs())
        assert model.param_count() == ref.param_count()
        assert model.active_param_count() == ref.active_param_count()
    # input_sample draws the reference's input_specs, shape and dtype
    for shape in SHAPES.values():
        spec = ref.input_specs(dataclasses.replace(shape, global_batch=2,
                                                   seq_len=8))
        got = model.input_sample(dataclasses.replace(
            shape, global_batch=2, seq_len=8),
            torch.Generator().manual_seed(0), "cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == {
            k: (tuple(v.shape), jnp.dtype(v.dtype).name)
            for k, v in spec.items()}
        assert all(int(t.max()) < cfg.vocab for k, t in got.items()
                   if not t.is_floating_point())


def test_init_params_rule_and_families_still_to_port():
    model = build_model(ARCHS["internlm2-1.8b"])
    spec = {"w": pbase.P((512, 256), (None, None), torch.float32, 2.0),
            "b": pbase.P((300,), (None,)),
            "s": pbase.P((), ())}
    p1 = pbase.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    p2 = pbase.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(p1[k], p2[k]) for k in spec)
    assert p1["b"].dtype == torch.bfloat16 and p1["s"].dtype == torch.bfloat16
    assert float(p1["s"]) == 0.0
    assert abs(float(p1["w"].std()) - 2.0 / np.sqrt(512)) < 0.005
    assert abs(float(p1["b"].float().std()) - 1.0 / np.sqrt(300)) < 0.01
    small = build_model(reduced(ARCHS["internlm2-1.8b"]))
    prm = small.init_params(torch.Generator().manual_seed(0), "cpu")
    assert prm["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert model.cfg.vocab == 92_544
    # the families of ROADMAP A13b build, with the reference's counts
    for arch, count in (("zamba2-1.2b", 1_192_987_200),
                        ("xlstm-125m", 199_719_936)):
        m = build_model(ARCHS[arch])
        assert m.param_count() == count
        assert m.decode_fn is not None and m.init_caches is not None


def test_params_carry_across_leaf_for_leaf():
    cfg = ref_reduced(REF_ARCHS["granite-moe-1b-a400m"])
    ref = ref_build(cfg).init_params(jax.random.PRNGKey(4))
    tree = jax.tree.map(np.asarray, ref)
    got = model_params_from_reference(tree, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        t = got
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf.astype(jnp.float32))
        assert str(t.dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
        assert np.array_equal(t.float().numpy(), want)
    f32 = model_params_from_reference(tree, device="cpu",
                                      dtype=torch.float32)
    assert f32["layers"]["moe"]["w_up"].dtype == torch.float32
    # copies: writing the carried tree leaves the caller's arrays alone
    before = np.array(tree["ln_f"], copy=True)
    f32["ln_f"].add_(1.0)
    assert np.array_equal(np.asarray(tree["ln_f"]), before)


# ---------------------------------------------------------------------------
# whole models: loss, prefill, two decode steps
# ---------------------------------------------------------------------------


def _inputs(cfg, rng, B, S):
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.arch == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    if cfg.arch == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _ref_batch(batch):
    return {k: (jnp.asarray(v).astype(jnp.bfloat16) if v.dtype == np.float32
                else jnp.asarray(v)) for k, v in batch.items()}


def _port_batch(batch):
    return {k: (_t(v).to(torch.bfloat16) if v.dtype == np.float32
                else _t(v).long()) for k, v in batch.items()}


def _ref_caches(cfg, B, T, dtype):
    if cfg.arch == "encdec":
        kv = (cfg.n_layers, B, cfg.n_kv, T, cfg.head_dim_)
        cr = (cfg.n_layers, B, cfg.n_kv, cfg.n_frontend_tokens,
              cfg.head_dim_)
        return {"k": jnp.zeros(kv, dtype), "v": jnp.zeros(kv, dtype),
                "ck": jnp.zeros(cr, dtype), "cv": jnp.zeros(cr, dtype)}
    return rlm.init_kv_cache(cfg, B, T, dtype=dtype)


def _port_caches(cfg, B, T, dtype):
    if cfg.arch == "encdec":
        kv = (cfg.n_layers, B, cfg.n_kv, T, cfg.head_dim_)
        cr = (cfg.n_layers, B, cfg.n_kv, cfg.n_frontend_tokens,
              cfg.head_dim_)
        z = lambda s: torch.zeros(s, dtype=dtype)  # noqa: E731
        return {"k": z(kv), "v": z(kv), "ck": z(cr), "cv": z(cr)}
    return plm.init_kv_cache(cfg, B, T, dtype=dtype, device="cpu")


def _outputs(model, params, batch, caches, cfg, decode_tokens, ref):
    """[loss, prefill logits (lm / vlm), decode logits x 2] as f32
    numpy; the decode tokens are given (the same for every run)."""
    loss_fn, prefill_fn, decode_fn = (model.loss_fn, model.prefill_fn,
                                      model.decode_fn)
    if ref:  # the reference runs as it serves: jitted
        loss_fn, decode_fn = jax.jit(loss_fn), jax.jit(decode_fn)
        prefill_fn = prefill_fn and jax.jit(prefill_fn)
    outs = [np.float32(loss_fn(params, batch))]
    S = batch["tokens"].shape[1]
    idx = 0
    if prefill_fn is not None:
        lg, caches = prefill_fn(params, batch, caches)
        outs.append(_np(lg) if ref else lg.float().numpy())
        idx = S + (cfg.n_frontend_tokens if cfg.arch == "vlm" else 0)
    for tok in decode_tokens:
        if ref:
            lg, caches = decode_fn(params, {"tokens": jnp.asarray(tok)},
                                   caches, jnp.int32(idx))
            outs.append(_np(lg))
        else:
            lg, caches = decode_fn(params, {"tokens": _t(tok).long()},
                                   caches, idx)
            outs.append(lg.float().numpy())
        idx += 1
    return outs


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_reduced_model_matches_reference(arch):
    rcfg, cfg = ref_reduced(REF_ARCHS[arch]), reduced(ARCHS[arch])
    rm, pm = ref_build(rcfg), build_model(cfg)
    rp16 = rm.init_params(jax.random.PRNGKey(7))
    rp32 = jax.tree.map(lambda a: a.astype(jnp.float32), rp16)
    tree = jax.tree.map(np.asarray, rp16)
    pp16 = model_params_from_reference(tree, device="cpu")
    pp32 = model_params_from_reference(tree, device="cpu",
                                       dtype=torch.float32)
    rng = np.random.default_rng(11)
    B, S, T = 8, 10, 32  # 24 rows of logits: a mean over rows
    batch = _inputs(cfg, rng, B, S)
    toks = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
            for _ in range(2)]
    rb, pb = _ref_batch(batch), _port_batch(batch)

    # f32: tight
    want32 = _outputs(rm, rp32, rb, _ref_caches(rcfg, B, T, jnp.float32),
                      rcfg, toks, True)
    got32 = _outputs(pm, pp32, pb, _port_caches(cfg, B, T, torch.float32),
                     cfg, toks, False)
    assert len(got32) == len(want32) == (3 if cfg.arch == "encdec" else 4)
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_MODEL_ATOL)
        if np.ndim(w):
            assert np.array_equal(g.argmax(-1), w.argmax(-1))

    # bf16: each package against the f32 run of the same weights
    want16 = _outputs(rm, rp16, rb, _ref_caches(rcfg, B, T, jnp.bfloat16),
                      rcfg, toks, True)
    got16 = _outputs(pm, pp16, pb, _port_caches(cfg, B, T, torch.bfloat16),
                     cfg, toks, False)
    step = BF16_STEPS * BF16_STEP
    assert abs(got16[0] - want32[0]) <= (
        2 * abs(want16[0] - want32[0]) + step * abs(want32[0]))
    flat = [np.concatenate([np.ravel(o) for o in outs[1:]])
            for outs in (got16, want16, want32)]
    port_err, ref_err = np.abs(flat[0] - flat[2]), np.abs(flat[1] - flat[2])
    assert port_err.mean() <= 2 * ref_err.mean(), (arch, ref_err.mean())
    assert port_err.max() <= (2 * ref_err.max()
                              + step * np.abs(flat[2]).max()), arch
