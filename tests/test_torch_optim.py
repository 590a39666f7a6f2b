"""The port's optimizers, schedules and gradient compression against the
reference's on the CPU: the same numpy inputs through both packages.

Tolerances, stated once:

* schedules: within 1e-7 of ``peak_lr``, the schedule's scale (both
  compute in f32; the two ``cos`` differ by an ulp on some inputs,
  which ``1 + cos`` amplifies relative to the value near the end);
* ``adamw_update`` / ``adafactor_update``: every f32 leaf (params,
  moments, factored moments, the global norm) within 1e-6 of the
  leaf's largest magnitude (XLA may contract a product and a sum into
  one FMA where torch rounds twice); bf16 leaves (params, Adafactor's
  momentum) within one bf16 step of the reference's value;
* ``compress_decompress`` / ``ef_compress_update``: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor_init as r_af_init
from repro.optim import adafactor_update as r_af_update
from repro.optim import adamw_init as r_adam_init
from repro.optim import adamw_update as r_adam_update
from repro.optim import cosine_schedule as r_cos
from repro.optim import wsd_schedule as r_wsd
from repro.optim.compress import compress_decompress as r_cd
from repro.optim.compress import ef_compress_update as r_ef
from repro_torch.optim import (OPTIMIZERS, adafactor_init, adafactor_update,
                               adamw_init, adamw_update, compress_decompress,
                               cosine_schedule, ef_compress_update,
                               residual_init, wsd_schedule)
from repro_torch.tree import leaf_paths, leaves

F32_RTOL = 1e-6
SCHED_RTOL = 1e-7


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_f32(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= F32_RTOL * scale, (what, err, scale)


def _within_bf16_step(got, want, what):
    got, want = _np(got), _np(want)
    mag = np.abs(want)
    step = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 2.0 ** -133)
    assert np.all(np.abs(got - want) <= step), what


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(peak_lr=3e-4, warmup_steps=10, total_steps=100),
    dict(peak_lr=1.0, warmup_steps=0, total_steps=7, final_frac=0.0),
    dict(peak_lr=6e-4, warmup_steps=2, total_steps=12),
])
def test_cosine_schedule_matches_reference(kw):
    for s in range(0, kw["total_steps"] + 5):
        want = float(r_cos(s, **kw))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = cosine_schedule(step, **kw)
            assert got.dtype == torch.float32 and got.ndim == 0
            assert abs(float(got) - want) <= SCHED_RTOL * kw["peak_lr"], (
                s, kw)


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1.0, warmup_steps=10, stable_steps=60, decay_steps=30),
    dict(peak_lr=3e-4, warmup_steps=2, stable_steps=9, decay_steps=1,
         final_frac=0.1),
])
def test_wsd_schedule_matches_reference(kw):
    for s in range(0, 110):
        want = float(r_wsd(s, **kw))
        got = float(wsd_schedule(torch.tensor(s, dtype=torch.int32), **kw))
        assert abs(got - want) <= SCHED_RTOL * kw["peak_lr"], (s, kw)
        assert float(wsd_schedule(s, **kw)) == got


# ---------------------------------------------------------------------------
# optimizer steps on the same grads, state and params
# ---------------------------------------------------------------------------


def _tree(rng):
    """A nested param tree: stacked 4-d and 3-d weights, 2-d, 1-d and a
    vector named like a slot key."""
    shapes = {"layers": {"attn": {"wq": (2, 16, 4, 8),
                                  "wo": (2, 8, 16)},
                         "ln": (2, 16)},
              "embed": (32, 16), "ln_f": (16,), "m": (5,)}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return (rng.standard_normal(node) * 0.5).astype(np.float32)
    return build(shapes)


def _ref(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _port(tree, dtype=torch.float32):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype),
        tree)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_adamw_update_matches_reference(bf16, lr_kind):
    rng = np.random.default_rng(3 + bf16)
    params = _tree(rng)
    rdt, pdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    rp, pp = _ref(params, rdt), _port(params, pdt)
    rs, ps = r_adam_init(rp), adamw_init(pp)
    assert [k for k, _ in leaf_paths(ps)] == [
        tuple(getattr(k, "key", None) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(rs)[0]]
    assert ps["step"].dtype == torch.int32 and ps["step"].ndim == 0
    for it in range(4):   # four steps: bias correction, clip on and off
        g = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape)
                       * (3.0 if it == 1 else 0.02)).astype(np.float32),
            params)
        lr = 1e-2 * (it + 1)
        rlr = lr if lr_kind == "float" else jnp.float32(lr)
        plr = lr if lr_kind == "float" else torch.tensor(lr)
        rp, rs, rg = r_adam_update(_ref(g), rs, rp, lr=rlr)
        pp, ps, pg = adamw_update(_port(g), ps, pp, lr=plr)
        _close_f32(pg, rg, "gnorm")
        assert int(ps["step"]) == int(rs["step"]) == it + 1
        for name in ("m", "v"):
            for a, b in zip(leaves(ps[name]), jax.tree.leaves(rs[name])):
                _close_f32(a, b, name)
        for a, b in zip(leaves(pp), jax.tree.leaves(rp)):
            assert a.dtype == pdt
            if bf16:
                _within_bf16_step(a, b, "param")
            else:
                _close_f32(a, b, "param")
        # carry the reference's trajectory so errors do not compound
        pp = _port(jax.tree.map(np.asarray, rp), pdt)
        ps = {"m": _port(jax.tree.map(np.asarray, rs["m"])),
              "v": _port(jax.tree.map(np.asarray, rs["v"])),
              "step": torch.tensor(int(rs["step"]), dtype=torch.int32)}


@pytest.mark.parametrize("bf16", [False, True])
def test_adafactor_update_matches_reference(bf16):
    rng = np.random.default_rng(7 + bf16)
    params = _tree(rng)
    rdt, pdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    rp, pp = _ref(params, rdt), _port(params, pdt)
    rs, ps = r_af_init(rp), adafactor_init(pp)
    rflat = jax.tree_util.tree_flatten_with_path(rs)[0]
    pflat = leaf_paths(ps)
    assert [tuple(getattr(k, "key", None) for k in p) for p, _ in rflat] \
        == [p for p, _ in pflat]
    for (_, a), (_, b) in zip(pflat, rflat):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name
    for it in range(4):
        g = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape)
                       * (3.0 if it == 2 else 0.05)).astype(np.float32),
            params)
        lr = 1e-2
        rp, rs, rg = r_af_update(_ref(g), rs, rp, lr=lr, weight_decay=0.01)
        pp, ps, pg = adafactor_update(_port(g), ps, pp, lr=lr,
                                      weight_decay=0.01)
        _close_f32(pg, rg, "gnorm")
        assert int(ps["step"]) == int(rs["step"]) == it + 1
        for (path, a), (_, b) in zip(leaf_paths(ps["slots"]),
                                     jax.tree_util.tree_flatten_with_path(
                                         rs["slots"])[0]):
            if path[-1] == "m":
                assert a.dtype == torch.bfloat16
                _within_bf16_step(a, b, path)
            else:
                _close_f32(a, b, path)
        for a, b in zip(leaves(pp), jax.tree.leaves(rp)):
            if bf16:
                _within_bf16_step(a, b, "param")
            else:
                _close_f32(a, b, "param")
        pp = _port(jax.tree.map(np.asarray, rp), pdt)
        ps = {"slots": jax.tree.map(
            lambda a: torch.from_numpy(np.array(a, np.float32)).to(
                torch.bfloat16 if a.dtype == jnp.bfloat16
                else torch.float32), rs["slots"]),
            "step": torch.tensor(int(rs["step"]), dtype=torch.int32)}


# ---------------------------------------------------------------------------
# EF-int8 compression
# ---------------------------------------------------------------------------


def test_compress_and_error_feedback_are_exact():
    rng = np.random.default_rng(5)
    # values at exact .5 multiples of the scale test the rounding mode
    x = (np.arange(-40, 41, dtype=np.float32) * 0.5)
    for arr in (x, rng.standard_normal((8, 33)).astype(np.float32) * 3,
                np.zeros((4,), np.float32), np.float32(2.5)):
        d, q, s = compress_decompress(torch.from_numpy(np.array(arr)))
        rd, rq, rs = r_cd(jnp.asarray(arr))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.array_equal(d.numpy(), np.asarray(rd))
        assert float(s) == float(rs)
    g = {"w": rng.standard_normal((8, 8)).astype(np.float32),
         "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
    e = {"w": (rng.standard_normal((8, 8)) * 1e-3).astype(np.float32),
         "b": {"c": np.zeros((3,), np.float32)}}
    rdq, rres = r_ef(_ref(g), _ref(e))
    pdq, pres = ef_compress_update(_port(g), _port(e))
    for a, b in zip(leaves(pdq) + leaves(pres),
                    jax.tree.leaves(rdq) + jax.tree.leaves(rres)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    z = residual_init(_port(g))
    assert all(t.dtype == torch.float32 and not t.any() for t in leaves(z))


# ---------------------------------------------------------------------------
# the reference's own optimizer tests, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_reduce_quadratic(name):
    init, update = OPTIMIZERS[name]
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = update(grads, state, params, lr=5e-2)
    assert float(params["w"].abs().max()) < 0.3


def test_adafactor_memory_is_factored():
    params = {"w": torch.zeros((64, 32))}
    slot = adafactor_init(params)["slots"]["w"]
    assert slot["vr"].shape == (64,) and slot["vc"].shape == (32,)
    assert slot["m"].dtype == torch.bfloat16
