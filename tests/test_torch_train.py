"""The port's trainer, checkpoints and launcher against the reference's
on the CPU.

Both trainers start from one state: the reference ``Trainer``'s
``init_state(0)`` with its params cast to f32, saved at step 0 by the
reference's ``CheckpointManager``; each trainer resumes from that file
(the port's across packages), over the same learned-index loader (a
fresh one each, same seed).  Tolerances, stated once:

* per-step loss and global grad norm within 1e-4 relative; the lr
  within 1e-7 of ``peak_lr``; ``bad_step`` and ``step`` equal;
* final params within ``rtol`` 1e-4 and ``atol`` 2 * ``peak_lr`` *
  steps: Adam turns a grad at the noise floor of either package into a
  full +-lr step, so a few elements may part by up to one lr a step.

Checkpoints: either package resumes the other's mid-run checkpoint, the
two write manifests equal in ``leaves``, ``dtypes`` and ``extra`` and
``.npy`` files with equal headers (bf16 leaves included), and list
leaves in JAX's order (``b1, b10, b11, b2``, not sorted joined names).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.data import IndexedTokenDataset as RefDataset
from repro.data import PackedTokenStore as RefStore
from repro.data import ShardedLoader as RefLoader
from repro.models import build_model as ref_build
from repro.train import CheckpointManager as RefCkpt
from repro.train import FailureInjector as RefInjector
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import train_state_from_reference
from repro_torch.data import IndexedTokenDataset, PackedTokenStore, \
    ShardedLoader
from repro_torch.models import build_model
from repro_torch.train import CheckpointManager, FailureInjector, \
    TrainConfig, Trainer
from repro_torch.tree import leaf_paths, leaves

ARCH = "internlm2-1.8b"
STEPS = 8
PEAK_LR = 3e-4
RTOL = 1e-4


def _ref_loader():
    cfg = ref_reduced(REF_ARCHS[ARCH])
    store = RefStore.synthetic(256, mean_len=33, vocab=cfg.vocab, seed=0)
    ds = RefDataset.build(store, method="fiting", eps=8)
    return RefLoader(ds, global_batch=4, seq_len=32, seed=0)


def _port_loader():
    cfg = reduced(ARCHS[ARCH])
    store = PackedTokenStore.synthetic(256, mean_len=33, vocab=cfg.vocab,
                                       seed=0)
    ds = IndexedTokenDataset.build(store, method="fiting", eps=8,
                                   device="cpu")
    return ShardedLoader(ds, global_batch=4, seq_len=32, seed=0)


def _tcfg(ckpt_dir, cls, **kw):
    base = dict(total_steps=STEPS, peak_lr=PEAK_LR, warmup_steps=2,
                ckpt_every=4, ckpt_dir=str(ckpt_dir), log_every=1)
    base.update(kw)
    return cls(**base)


def _seed_dir(tmp_path, name, grad_compress=False, f32=True):
    """A checkpoint directory holding the reference's step-0 state."""
    d = tmp_path / name
    model = ref_build(ref_reduced(REF_ARCHS[ARCH]))
    tr = RefTrainer(model, _tcfg(d, RefTrainConfig,
                                 grad_compress=grad_compress), _ref_loader())
    state = tr.init_state(0)
    if f32:
        state["params"] = _conditioned_f32(state["params"])
    RefCkpt(str(d)).save(0, state, extra={"step": 0, "loader_step": 0})
    return d


def _conditioned_f32(params):
    """The reference's params in f32, conditioned as
    ``chip_smoke.conditioned`` conditions them (see the module doc)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import conditioned
    from repro_torch.convert import model_params_from_reference
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    tree = conditioned(model_params_from_reference(tree, "cpu",
                                                   torch.float32))
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _clone(src, dst):
    shutil.copytree(src, dst)
    return dst


def _ref_trainer(d, injector=None, loader=None, **kw):
    model = ref_build(ref_reduced(REF_ARCHS[ARCH]))
    return RefTrainer(model, _tcfg(d, RefTrainConfig, **kw),
                      loader or _ref_loader(), failure_injector=injector)


def _port_trainer(d, injector=None, loader=None, **kw):
    model = build_model(reduced(ARCHS[ARCH]))
    return Trainer(model, _tcfg(d, TrainConfig, **kw),
                   loader or _port_loader(), failure_injector=injector,
                   device="cpu")


def _run_ref(d, **kw):
    tr = _ref_trainer(d, **kw)
    return tr, tr.run(seed=0)


def _run_port(d, **kw):
    tr = _port_trainer(d, **kw)
    return tr, tr.run(seed=0)


def _same_metrics(got, want):
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for g, w in zip(got, want):
        assert g["bad_step"] == w["bad_step"], (g, w)
        assert abs(g["lr"] - w["lr"]) <= 1e-7 * PEAK_LR, (g, w)
        for k in ("loss", "gnorm"):
            if np.isnan(w[k]):
                assert np.isnan(g[k]), (k, g, w)
            else:
                assert abs(g[k] - w[k]) <= RTOL * abs(w[k]), (k, g, w)


def _same_params(got, want, steps=STEPS):
    flat = {tuple(k.key for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    for path, t in leaf_paths(got):
        np.testing.assert_allclose(
            t.detach().float().numpy(),
            np.asarray(jnp.asarray(flat[path]).astype(jnp.float32)),
            rtol=RTOL, atol=2 * PEAK_LR * steps, err_msg=str(path))


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Both trainers over 8 steps from the reference's f32 step-0 state,
    each in its own copy of the seeded directory."""
    tmp = tmp_path_factory.mktemp("traj")
    seed = _seed_dir(tmp, "seed")
    rtr, ref = _run_ref(_clone(seed, tmp / "ref"))
    ptr, port = _run_port(_clone(seed, tmp / "port"))
    return {"tmp": tmp, "seed": seed, "ref": ref, "port": port}


def test_trajectory_matches_reference(uninterrupted):
    ref, port = uninterrupted["ref"], uninterrupted["port"]
    assert len(port["metrics"]) == len(ref["metrics"]) == STEPS
    _same_metrics(port["metrics"], ref["metrics"])
    _same_params(port["state"]["params"], ref["state"]["params"])
    # resumed across packages: the port's params are the file's f32
    assert all(t.dtype == torch.float32
               for t in leaves(port["state"]["params"]))
    assert int(port["state"]["opt"]["step"]) == STEPS


def test_manifests_and_npy_headers_equal(uninterrupted):
    tmp = uninterrupted["tmp"]
    for step in (4, 8):
        rd = tmp / "ref" / f"step_{step:08d}"
        pd = tmp / "port" / f"step_{step:08d}"
        rm = json.loads((rd / "manifest.json").read_text())
        pm = json.loads((pd / "manifest.json").read_text())
        for k in ("step", "leaves", "dtypes", "extra"):
            assert pm[k] == rm[k], k
        assert rm["extra"] == {"step": step, "loader_step": step}
        for name in rm["leaves"]:
            assert _npy_header(pd / f"{name}.npy") == \
                _npy_header(rd / f"{name}.npy"), name


def _npy_header(path):
    with open(path, "rb") as f:
        np.lib.format.read_magic(f)
        np.lib.format.read_array_header_1_0(f)
        n = f.tell()
        f.seek(0)
        return f.read(n)


@pytest.mark.parametrize("crash_in", ["ref", "port"])
def test_each_package_resumes_the_others_checkpoint(uninterrupted,
                                                     crash_in, tmp_path):
    """One package crashes at step 6 after its step-4 checkpoint; the
    other resumes from that file and finishes, within the trajectory
    tolerance of the uninterrupted runs (its loader seeked to 4)."""
    d = _clone(uninterrupted["seed"], tmp_path / "x")
    make_a, run_b = ((_ref_trainer, _run_port) if crash_in == "ref"
                     else (_port_trainer, _run_ref))
    inj = (RefInjector if crash_in == "ref" else FailureInjector)({6: "crash"})
    crashed = make_a(d, injector=inj)
    with pytest.raises(RuntimeError, match="injected crash"):
        crashed.run(seed=0)
    # the crash is injected into a live process: its async save of step
    # 4 completes before the restart reads the directory
    crashed.ckpt.wait()
    crashed.watchdog.close()
    assert sorted(p.name for p in d.iterdir())[-1] == "step_00000004"
    tr, out = run_b(d)
    assert [m["step"] for m in out["metrics"]] == [5, 6, 7, 8]
    assert tr.loader.step == STEPS
    want = uninterrupted["ref"]
    _same_metrics(out["metrics"], want["metrics"][4:])
    if crash_in == "ref":
        _same_params(out["state"]["params"], want["state"]["params"])
    else:   # the reference finished the port's run: carry its state over
        carried = train_state_from_reference(
            jax.tree.map(np.asarray, out["state"]), "cpu")
        mine = uninterrupted["port"]["state"]
        assert [(p, t.dtype, tuple(t.shape)) for p, t in
                leaf_paths(carried)] == [(p, t.dtype, tuple(t.shape))
                                         for p, t in leaf_paths(mine)]
        _same_params(carried["params"], want["state"]["params"])
        assert int(carried["opt"]["step"]) == STEPS


def _nan_loader(make, at):
    """A loader whose batch ``at`` (0-based) carries a NaN in its loss
    mask, so that step's loss is NaN in either package."""
    loader = make()
    nxt = loader.next_batch

    def next_batch():
        step = loader.step
        b = nxt()
        if step == at:
            b["mask"] = b["mask"].copy()
            b["mask"][0, 0] = np.nan
        return b
    loader.next_batch = next_batch
    return loader


def test_nan_guard_matches_reference(tmp_path):
    """Step 3's loss is NaN: both keep params and moments, count the
    step (the lr schedule moves on), flag ``bad_step``, and go on."""
    seed = _seed_dir(tmp_path, "seed")
    _, ref = _run_ref(_clone(seed, tmp_path / "ref"),
                      loader=_nan_loader(_ref_loader, 2))
    ptr, port = _run_port(_clone(seed, tmp_path / "port"),
                          loader=_nan_loader(_port_loader, 2))
    assert [m["bad_step"] for m in port["metrics"]] == [
        0.0, 0.0, 1.0] + [0.0] * (STEPS - 3)
    _same_metrics(port["metrics"], ref["metrics"])
    _same_params(port["state"]["params"], ref["state"]["params"])
    assert int(port["state"]["opt"]["step"]) == STEPS


def test_bad_step_keeps_params_and_moments_but_counts_the_step(tmp_path):
    model = build_model(reduced(ARCHS[ARCH]))
    tr = Trainer(model, _tcfg(tmp_path, TrainConfig), _port_loader(),
                 device="cpu")
    state = tr.init_state(0)
    tr.train_step(state, tr.device_batch(tr.loader.next_batch()))
    before = [t.clone() for t in leaves(state["params"])
              + leaves(state["opt"]) if t.ndim]
    batch = tr.loader.next_batch()
    batch["mask"][0, 0] = np.nan
    m = tr.train_step(state, tr.device_batch(batch))
    assert float(m["bad_step"]) == 1.0 and np.isnan(float(m["loss"]))
    after = [t for t in leaves(state["params"]) + leaves(state["opt"])
             if t.ndim]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert int(state["opt"]["step"]) == 2


@pytest.mark.parametrize("kw", [dict(grad_compress=True),
                                dict(schedule="wsd")],
                         ids=["ef_int8", "wsd"])
def test_variant_trajectories_match_reference(tmp_path, kw):
    seed = _seed_dir(tmp_path, "seed", grad_compress=kw.get(
        "grad_compress", False))
    _, ref = _run_ref(_clone(seed, tmp_path / "ref"), **kw)
    _, port = _run_port(_clone(seed, tmp_path / "port"), **kw)
    _same_metrics(port["metrics"], ref["metrics"])
    _same_params(port["state"]["params"], ref["state"]["params"])
    if kw.get("grad_compress"):
        assert all(t.shape == p.shape for t, p in zip(
            leaves(port["state"]["residual"]),
            leaves(port["state"]["params"])))


def test_crash_restart_resumes(tmp_path):
    """The reference's own crash-restart test, on the port: a crash at
    step 13, a fresh trainer resumes from the step-8 checkpoint."""
    def setup():
        model = build_model(reduced(ARCHS[ARCH]))
        return model, _tcfg(tmp_path, TrainConfig, total_steps=20,
                            ckpt_every=8, log_every=4)
    model, tcfg = setup()
    tr = Trainer(model, tcfg, _port_loader(),
                 failure_injector=FailureInjector({13: "crash"}),
                 device="cpu")
    with pytest.raises(RuntimeError, match="injected crash"):
        tr.run()
    tr.ckpt.wait()
    tr.watchdog.close()
    model2, tcfg2 = setup()
    loader2 = _port_loader()
    out = Trainer(model2, tcfg2, loader2, device="cpu").run()
    assert out["metrics"][0]["step"] == 12
    assert out["metrics"][-1]["step"] == 20
    assert loader2.step >= 20
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    a: object
    b: object


def test_leaf_order_and_bf16_files_match_reference(tmp_path):
    """A tree with blocks b0..b11 (JAX's order puts b10, b11 after b1),
    a list, a 0-d int32, a None and bf16 leaves: both packages list the
    same leaves in the same order and write byte-identical files; each
    restores the other's against a template.  (The reference cannot
    save a NamedTuple: its treedef field refuses one; the port names its
    fields as JAX does.)"""
    rng = np.random.default_rng(0)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"blocks": {f"b{i}": {"w": arr(3, 2)} for i in range(12)},
            "seq": [arr(2), arr(1, 2)],
            "step": np.int32(7), "bf": arr(5, 3), "none": None}
    bf16 = {"bf"}

    def ref_leaf(path, a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if path[0].key in bf16 else a

    def port_leaf(a):
        return torch.from_numpy(np.array(a))

    rtree = jax.tree_util.tree_map_with_path(ref_leaf, tree)
    ptree = jax.tree.map(port_leaf, tree)
    ptree["bf"] = ptree["bf"].to(torch.bfloat16)
    RefCkpt(str(tmp_path / "r")).save(3, rtree, extra={"k": 1})
    CheckpointManager(str(tmp_path / "p")).save(3, ptree, extra={"k": 1})
    rd, pd = tmp_path / "r" / "step_00000003", tmp_path / "p" / "step_00000003"
    rm = json.loads((rd / "manifest.json").read_text())
    pm = json.loads((pd / "manifest.json").read_text())
    assert pm["leaves"] == rm["leaves"]
    assert [n for n in pm["leaves"] if n.startswith("blocks")][:4] == [
        "blocks__b0__w", "blocks__b1__w", "blocks__b10__w", "blocks__b11__w"]
    assert pm["dtypes"] == rm["dtypes"] and "bfloat16" in pm["dtypes"]
    assert pm["extra"] == rm["extra"]
    for name in rm["leaves"]:
        assert (pd / f"{name}.npy").read_bytes() == \
            (rd / f"{name}.npy").read_bytes(), name
    # cross restores against a template
    got, extra = CheckpointManager(str(tmp_path / "r")).restore(
        template=ptree)
    assert extra == {"k": 1} and got["none"] is None
    assert got["bf"].dtype == torch.bfloat16
    for (_, a), (_, b) in zip(leaf_paths(got), leaf_paths(ptree)):
        assert torch.equal(a, b)
    back, _ = RefCkpt(str(tmp_path / "p")).restore(template=rtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rtree)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))
    with pytest.raises(ValueError, match="other leaves"):
        CheckpointManager(str(tmp_path / "r")).restore(
            template={"blocks": ptree["blocks"]})
    pair = {"c": _Pair(torch.ones(2), torch.zeros(3))}
    CheckpointManager(str(tmp_path / "n")).save(1, pair)
    man = json.loads((tmp_path / "n" / "step_00000001" / "manifest.json"
                      ).read_text())
    assert man["leaves"] == ["c__a", "c__b"]
    got, _ = CheckpointManager(str(tmp_path / "n")).restore(template=pair)
    assert isinstance(got["c"], _Pair) and torch.equal(got["c"].a, pair["c"].a)


def test_save_async_snapshots_before_the_thread(tmp_path, monkeypatch):
    """``save_async`` copies every leaf to the host before its thread
    starts: an in-place update right after the call does not reach the
    file."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(4)
    started = []
    real_save = mgr.save

    def slow_save(step, state, extra=None):
        started.append(True)
        return real_save(step, state, extra)
    monkeypatch.setattr(mgr, "save", slow_save)
    mgr.save_async(1, {"w": w}, extra={"step": 1})
    w.add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(1, template={"w": w})
    assert started and torch.equal(got["w"], torch.zeros(4))
    # the index snapshots' flat form still restores without a template
    flat, extra = mgr.restore(1)
    assert set(flat) == {"w"} and extra == {"step": 1}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_train_runs_end_to_end_on_the_cpu(tmp_path):
    from repro_torch.launch import train as launch
    ck = tmp_path / "ck"
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "6",
            "--ckpt-every", "3", "--seq-len", "32", "--n-docs", "128",
            "--ckpt-dir", str(ck)]
    with pytest.raises(RuntimeError, match="injected crash"):
        launch.main(args + ["--inject-crash-at", "4"])
    # the restart as a user runs it: a fresh process resumes from step 3
    root = Path(__file__).resolve().parents[1]
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, cwd=root, timeout=120,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert done.returncode == 0, done.stderr
    assert "resumed from step 3" in done.stdout
    assert "[train] step=6" in done.stdout and "on cpu" in done.stdout
    assert CheckpointManager(str(ck)).latest_step() == 6
    # --mesh builds the production mesh: one process outside a group of
    # 256 ranks gets the mesh's own error, as jax.make_mesh gives it
    with pytest.raises(ValueError, match="Number of devices 1 .* 256"):
        launch.main(args + ["--mesh", "single"])
