"""The port's backward passes against the reference's on the CPU:
``loss_fn``'s value and its gradient with respect to every param leaf,
``torch.autograd`` against ``jax.value_and_grad``, over reduced configs
of every family (the dense and MoE LM, the VLM, the enc-dec, zamba's
Mamba-2 hybrid, the xLSTM).  Both packages get the same numpy batch
(tokens, labels, a loss mask, the frontend embeddings in f32) and the
same f32 params: the reference's draws, conditioned as
``chip_smoke.conditioned`` conditions them (attention projections at
std 1/sqrt(contraction size), Mamba-2's per-head vectors by its
recipe, the mLSTM gate projections zeroed), carried across with
``convert.model_params_from_reference``.  As drawn, the init rule
makes even these 2-layer models chaotic for their grads: the
reference's own grads move by 4e-4 to 8e-4 (zamba, whisper, the VLM)
when its f32 params move by one ulp, so a 1e-4 comparison would
measure that, not the port; conditioned, the same spread is ~1e-6.

Tolerance, stated once: the loss within 1e-4 of its value, and every
grad leaf within 1e-4 of that leaf's largest magnitude (relative in
max-norm).  For the 8-block xLSTM (its block 7 is the sLSTM) the bound
is the larger of 1e-4 and twice the spread the reference's own grads
show when its f32 params move by one ulp (``grad_ulp_spread``, the
grad counterpart of ``test_torch_ssm.ulp_spread``), as the whole-model
test at that depth is held.

The remat policies change what is saved, not what is computed: on the
CPU ``"full"`` and ``"dots"`` give grads bit-identical to ``"none"``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import model_params_from_reference
from repro_torch.models import build_model
from repro_torch.tree import leaf_paths, leaves, unflatten

GRAD_RTOL = 1e-4
FAMILIES = ("internlm2-1.8b", "granite-moe-1b-a400m", "internvl2-2b",
            "whisper-base", "zamba2-1.2b", "xlstm-125m")
REMAT_ARCHS = ("internlm2-1.8b", "granite-moe-1b-a400m", "internvl2-2b",
               "whisper-base", "zamba2-1.2b")


def _configs(arch, n_layers=None, remat="none"):
    rcfg, cfg = ref_reduced(REF_ARCHS[arch]), reduced(ARCHS[arch])
    if n_layers is not None:
        rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return rcfg, dataclasses.replace(cfg, remat=remat)


def _batch(cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.arch == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    if cfg.arch == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def ref_value_and_grad(rcfg, batch):
    """The reference's ``params -> (loss, grads)`` on ``batch``, jitted
    once."""
    rm = ref_build(rcfg)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    f = jax.jit(jax.value_and_grad(lambda p: rm.loss_fn(p, rb)))

    def run(rp):
        loss, grads = f(rp)
        return float(loss), grads
    return run


def port_value_and_grad(cfg, pp, batch):
    pm = build_model(cfg)
    pb = {k: (torch.from_numpy(v) if v.dtype == np.float32
              else torch.from_numpy(v).long()) for k, v in batch.items()}
    flat = leaves(pp)
    for p in flat:
        p.requires_grad_(True)
    loss = pm.loss_fn(pp, pb)
    grads = torch.autograd.grad(loss, flat)
    return float(loss.detach()), unflatten(pp, list(grads))


def _ref_params(rcfg, seed=7):
    """The reference's f32 draws, conditioned (see the module doc):
    ``(jax tree, numpy tree)``."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import conditioned
    rp16 = ref_build(rcfg).init_params(jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rp16)
    tree = jax.tree.map(lambda t: t.numpy(), conditioned(
        model_params_from_reference(tree, "cpu", torch.float32)))
    return jax.tree.map(jnp.asarray, tree), tree


def _grad_errors(pgrads, rgrads):
    """``{path: (max |port - ref|, max |ref|)}`` over every leaf."""
    out = {}
    rflat = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): g
             for p, g in jax.tree_util.tree_flatten_with_path(rgrads)[0]}
    pflat = dict(leaf_paths(pgrads))
    assert sorted(pflat) == sorted(rflat)
    for path, g in pflat.items():
        want = np.asarray(rflat[path], np.float32)
        got = g.detach().numpy()
        assert got.shape == want.shape, path
        assert np.isfinite(got).all(), path
        out[path] = (float(np.abs(got - want).max()),
                     float(np.abs(want).max()))
    return out


def grad_ulp_spread(ref_vg, rp32, draws=2):
    """How far the reference's own loss and grads move, relative to each
    leaf's largest magnitude, when each of its f32 params is perturbed
    by one unit in the last place (relative 2^-23 normal noise): the
    largest over ``draws`` draws."""
    loss, grads = ref_vg(rp32)
    flat, tdef = jax.tree.flatten(rp32)
    gflat = [np.asarray(g) for g in jax.tree.leaves(grads)]
    spread = 0.0
    for d in range(draws):
        keys = jax.random.split(jax.random.PRNGKey(100 + d), len(flat))
        pert = jax.tree.unflatten(tdef, [
            a * (1 + 2.0 ** -23 * jax.random.normal(k, a.shape))
            for a, k in zip(flat, keys)])
        l2, g2 = ref_vg(pert)
        spread = max(spread, abs(l2 - loss) / abs(loss))
        for a, b in zip(jax.tree.leaves(g2), gflat):
            spread = max(spread, float(np.abs(np.asarray(a) - b).max())
                         / max(float(np.abs(b).max()), 1e-30))
    return spread


def grads_case(arch, n_layers=None, chaotic=False, seed=11):
    rcfg, cfg = _configs(arch, n_layers)
    rp32, tree = _ref_params(rcfg)
    batch = _batch(cfg, seed)
    ref_vg = ref_value_and_grad(rcfg, batch)
    rloss, rgrads = ref_vg(rp32)
    ploss, pgrads = port_value_and_grad(
        cfg, model_params_from_reference(tree, "cpu", torch.float32), batch)
    tol = GRAD_RTOL
    if chaotic:
        tol = max(GRAD_RTOL, 2 * grad_ulp_spread(ref_vg, rp32))
    assert abs(ploss - rloss) <= tol * abs(rloss), (arch, ploss, rloss)
    errs = _grad_errors(pgrads, rgrads)
    worst = max(errs.items(), key=lambda kv: kv[1][0] / max(kv[1][1], 1e-30))
    for path, (err, scale) in errs.items():
        assert err <= tol * scale, (arch, path, err, scale, tol)
    return worst, tol


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    grads_case(arch)


def test_xlstm_with_its_slstm_block_grads_match_reference():
    """Eight blocks, so block 7 is the sLSTM (the time loop's backward):
    the bound is the larger of 1e-4 and twice the reference's own
    one-ulp spread (see the module doc)."""
    grads_case("xlstm-125m", n_layers=8, chaotic=True)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_bit_identical_grads(arch):
    rcfg, _ = _configs(arch)
    _rp32, tree = _ref_params(rcfg, seed=3)
    out = {}
    for policy in ("none", "full", "dots"):
        _, cfg = _configs(arch, remat=policy)
        out[policy] = port_value_and_grad(
            cfg, model_params_from_reference(tree, "cpu", torch.float32),
            _batch(cfg, 5))
    for policy in ("full", "dots"):
        assert out[policy][0] == out["none"][0], policy
        for (path, a), (_, b) in zip(leaf_paths(out[policy][1]),
                                     leaf_paths(out["none"][1])):
            assert torch.equal(a, b), (arch, policy, path)


def test_dots_policy_saves_the_weight_products_only():
    """The selective policy saves ``mm`` and batch-1 ``bmm`` (einsums
    without batch dims) and recomputes batched products."""
    from repro_torch.models import base
    aten = torch.ops.aten
    assert base._saves_dot(aten.mm.default, (torch.empty(4, 3),))
    assert base._saves_dot(aten.bmm.default, (torch.empty(1, 4, 3),))
    assert not base._saves_dot(aten.bmm.default, (torch.empty(2, 4, 3),))
    assert not base._saves_dot(aten.mul.Tensor, (torch.empty(1, 4, 3),))
    with pytest.raises(KeyError):
        base.remat(lambda x: x, "sometimes")


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """A chunk that decays by more than e^88: the reference's
    ``where(tri, exp(seg), 0)`` gives the decays a NaN gradient (the
    masked exp overflows, 0 * inf); the port masks before the exp and
    gives the same gradient where the reference's is finite."""
    from repro.models import ssm as rssm
    from repro_torch.models import ssm as pssm
    rng = np.random.default_rng(0)
    B, S, H, Pd, N = 1, 64, 2, 4, 3
    xh = rng.standard_normal((B, S, H, Pd)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    for decay, ref_finite in ((0.5, True), (2.0, False)):   # 63 steps
        a = np.full((B, S, H), np.exp(-decay), np.float32)
        want = np.asarray(jax.grad(
            lambda a_: rssm.ssd_chunked(xh, b, c, a_, S)[0].sum())(
                jnp.asarray(a)))
        at = torch.from_numpy(a).requires_grad_(True)
        pssm.ssd_chunked(torch.from_numpy(xh), torch.from_numpy(b),
                         torch.from_numpy(c), at, S)[0].sum().backward()
        got = at.grad.numpy()
        assert np.isfinite(got).all()
        assert bool(np.isfinite(want).all()) == ref_finite
        if ref_finite:
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= GRAD_RTOL
