"""Rank programs for tests/test_torch_dist.py: each runs in one process
of a ``gloo`` group on the CPU, spawned by ``launch``.  The module
imports only the port (no JAX), so a rank starts in seconds.

    python tests/torch_dist_ranks.py moe_ep 8 TMPDIR

With ``TORCH_DIST_DEVICE=cuda`` the ranks run on one card each over
``nccl`` (TF32 off), against one-process values on their own card:

    TORCH_DIST_DEVICE=cuda python tests/torch_dist_ranks.py \
        sharded_training 4 TMPDIR

Each rank asserts its own checks; rank 0 prints one JSON line of
numbers.  A failing rank makes ``launch`` raise, and the process exits
nonzero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
DEVICE = os.environ.get("TORCH_DIST_DEVICE", "cpu")
RTOL = 1e-4          # the grad tests' bound (test_torch_grad.py)
EP_ATOL = 2e-4       # the reference's own bound (tests/test_moe_ep.py)
ADAFACTOR_UPDATE_RTOL = 1e-2


def launch(name: str, world: int, tmp: str) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(_rank, args=(name, world, tmp), nprocs=world,
                       start_method="spawn")


def _rank(rank: int, name: str, world: int, tmp: str) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.set_num_threads(1)
    if DEVICE == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store_"
                                        f"{name.replace(':', '_')}",
                            rank=rank, world_size=world)
    try:
        out = RANKS[name](rank, world, Path(tmp))
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rel_max(got, want) -> float:
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _rel_quantile(got, want, q: float) -> float:
    """The ``q`` quantile of ``|got - want|`` over ``max |want|``."""
    d = (got - want).abs().flatten().double()
    return float(torch.quantile(d, q)) / max(float(want.abs().max()), 1e-30)


def _max_over_ranks(x: float) -> float:
    t = torch.tensor(x, dtype=torch.float64, device=DEVICE)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(DEVICE, shape, mesh_dim_names=("data", "model"))


def _draw(model, seed):
    """The CPU's f32 draw of ``model``'s params, on ``DEVICE``."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.float().to(DEVICE), model.init_params(
        torch.Generator().manual_seed(seed), "cpu"))


# ---------------------------------------------------------------------------
# expert parallelism against moe_gspmd
# ---------------------------------------------------------------------------


def moe_ep(rank, world, tmp):
    """The reference's test_moe_ep case on a (2, 4) mesh: E = 8, D = 16,
    F = 32, top-2, capacity factor 8.0 (no token dropped), x (4, 8, D).
    Forward within 2e-4 of ``moe_gspmd`` on the whole batch; the grads
    of sum(out * w) (each rank's share 1/4, summed over the ranks)
    within 1e-4 of the whole batch's."""
    from repro_torch.models import moe
    from repro_torch.models.base import init_params
    from repro_torch.tree import leaf_paths, tree_map
    mesh = _mesh((2, 4))
    E, D, F, K = 8, 16, 32, 2
    params = tree_map(lambda t: t.float().to(DEVICE), init_params(
        moe.moe_specs(D, F, E), torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    x, w = (torch.from_numpy(rng.standard_normal((4, 8, D)).astype(
        np.float32)).to(DEVICE) for _ in range(2))

    def grads(fn, p, share):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        out = fn(p)
        loss = (out * share[1]).sum() * share[0]
        flat = [t for _, t in leaf_paths(p)]
        return out.detach(), torch.autograd.grad(loss, flat)

    ref, ref_g = grads(lambda p: moe.moe_gspmd(p, x, top_k=K,
                                               capacity_factor=8.0),
                       params, (1.0, w))
    d = mesh.get_local_rank("data")
    rows = slice(2 * d, 2 * d + 2)
    ep = mesh.shape[1]
    out, g = grads(lambda p: moe.moe_ep_shardmap(
        p, x[rows], top_k=K, mesh=mesh, capacity_factor=8.0),
        params, (1.0 / ep, w[rows]))
    err = float((out - ref[rows]).abs().max())
    g = [t.contiguous() for t in g]
    for t in g:
        dist.all_reduce(t)
    g_err = max(rel_max(a, b) for a, b in zip(g, ref_g))
    err, g_err = _max_over_ranks(err), _max_over_ranks(g_err)
    assert err < EP_ATOL, f"EP vs GSPMD mismatch: {err}"
    assert g_err <= RTOL, f"EP vs GSPMD grads: {g_err}"
    return {"max_abs_err": err, "grad_max_rel_err": g_err}


# ---------------------------------------------------------------------------
# sharded training against one process; checkpoints and elastic restore
# ---------------------------------------------------------------------------


def _reduced(arch, **kw):
    from repro_torch.configs import ARCHS, reduced
    return dataclasses.replace(reduced(ARCHS[arch]), **kw)


def _batch(rng, cfg, rows, seq):
    """tokens, labels and a mask with about a fifth of its tokens off,
    unevenly over the rows (so ranks count different tokens); the
    stub frontend's embeddings (standard normal, f32) for an enc-dec's
    frames or a VLM's patches."""
    mask = (rng.random((rows, seq)) > 0.2 * (1 + np.arange(rows)[:, None]
                                            / rows)).astype(np.float32)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (rows, seq))
                                      ).to(DEVICE),
           "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (rows, seq))
                                      ).to(DEVICE),
           "mask": torch.from_numpy(mask).to(DEVICE)}
    out.update(_frontend(rng, cfg, rows))
    return out


def _frontend(rng, cfg, rows):
    """``{"frames"}`` (enc-dec) or ``{"patches"}`` (VLM) of ``rows``
    rows, else nothing."""
    width = {"encdec": ("frames", cfg.d_model),
             "vlm": ("patches", cfg.d_frontend)}.get(cfg.arch)
    if width is None:
        return {}
    name, d = width
    return {name: torch.from_numpy(rng.standard_normal(
        (rows, cfg.n_frontend_tokens, d)).astype(np.float32)).to(DEVICE)}


def _rows(batch, shard_id, n_shards):
    return {k: v[shard_id::n_shards] for k, v in batch.items()}


def _whole(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def _f32_state(model, params, compress=False):
    from repro_torch.optim import OPTIMIZERS
    from repro_torch.optim.compress import residual_init
    from repro_torch.tree import tree_map
    opt_init = OPTIMIZERS[model.cfg.optimizer][0]
    residual = (residual_init(params) if compress else tree_map(
        lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
        params))
    return {"params": params, "opt": opt_init(params), "residual": residual}


def sharded_training(rank, world, tmp):
    """Reduced internlm2 (fsdp) on a (2, 2) mesh, ``conditioned`` f32
    params: loss and grads of a masked batch (unequal token counts over
    the ranks) within 1e-4 of one process on the whole batch; three
    ``Trainer`` steps with EF-int8 compression (lr at its peak from the
    first, so each later loss reads an update): losses, gnorms, each
    param on its scale and 99% of its change's components within 1e-4;
    the state's
    placements; a checkpoint written by rank 0 alone, byte for byte the
    one-process save of the same state, restored through
    ``elastic_restore`` onto (4, 1) with equal leaves and through
    ``restore(shardings=)`` onto (2, 2); the constrainer on a DTensor;
    reduced kimi-k2 with Adafactor (``_adafactor_step``); then a
    crash-and-resume ``Trainer.run`` over the mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from chip_smoke import conditioned
    from repro_torch.dist import activation_constrainer, param_shardings
    from repro_torch.dist.partitioning import batch_shard, place
    from repro_torch.models import build_model
    from repro_torch.train import CheckpointManager, TrainConfig, Trainer
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.tree import leaf_paths, tree_map
    cfg = _reduced("internlm2-1.8b", fsdp=True)
    model = build_model(cfg)
    mesh = _mesh((2, 2))
    constrain = activation_constrainer(mesh, fsdp=True)
    params = conditioned(_draw(model, 0))
    rng = np.random.default_rng(5)
    batches = [_batch(rng, cfg, 8, 16) for _ in range(4)]
    sid, n_shards = batch_shard(mesh)
    assert (sid, n_shards) == (mesh.get_local_rank("data"), 2)

    def tcfg(name):
        return TrainConfig(total_steps=3, warmup_steps=0, grad_compress=True,
                           ckpt_dir=str(tmp / name), log_every=1)

    one = Trainer(model, tcfg(f"one{rank}"), None, device=DEVICE)
    sh = Trainer(model, tcfg("sharded"), None, constrain=constrain,
                 device=DEVICE)
    clone = lambda tr: tree_map(lambda t: t.detach().clone(), tr)  # noqa
    l1, g1 = one.loss_and_grads(clone(params), batches[0])
    # the tensor-parallel design takes and gives each rank's shards
    assert sh.design == "tensor-parallel"
    l2, g2 = sh.loss_and_grads(_shards_of(sh, params),
                               _rows(batches[0], sid, n_shards))
    loss_err = abs(float(l2) - float(l1)) / abs(float(l1))
    grad_err = max(_shard_err(b, a, sh._shardings[path])
                   for (path, a), (_, b) in
                   zip(leaf_paths(g1), leaf_paths(g2)))

    s1 = _f32_state(model, clone(params), compress=True)
    s2 = sh.shard_state(_f32_state(model, clone(params), compress=True))
    assert isinstance(s2["residual"]["layers"]["attn"]["wq"], DTensor)
    emb = s2["params"]["embed"]
    assert isinstance(emb, DTensor)
    # ("vocab", "embed") under fsdp: vocab over "model", embed over "data"
    assert tuple(emb.placements) == (Shard(1), Shard(0))
    assert tuple(s2["opt"]["m"]["embed"].placements) == (Shard(1), Shard(0))
    assert not isinstance(s2["opt"]["step"], DTensor)
    norm = s2["params"]["ln_f"]    # ("embed",) -> "data"
    assert tuple(norm.placements) == (Shard(0), Replicate())
    losses = []
    for b in batches[1:]:
        m1 = one.train_step(s1, b)
        m2 = sh.train_step(s2, _rows(b, sid, n_shards))
        losses.append((float(m1["loss"]), float(m2["loss"]),
                       float(m1["gnorm"]), float(m2["gnorm"])))
    step_err = max(abs(b - a) / abs(a) for a, b, _, _ in losses)
    gnorm_err = max(abs(d - c) / abs(c) for _, _, c, d in losses)
    whole = _whole(s2)
    # each leaf's change over the three steps (a step that skipped the
    # update would miss it by all of it), at the grads' bound: every
    # leaf on its own scale, and 99% of each leaf's components on its
    # change's.  The tensor-parallel grads part from one process's by
    # ~1e-6 of their scale, and two steps amplify a few components by
    # far more: EF-int8 rounds a value at a quantum's edge (1/127 of the
    # leaf's max) either way, and AdamW's first updates divide each
    # component by its own size
    upd = {path: max(rel_max(b, a), _rel_quantile(b - p0, a - p0, 0.99))
           for (path, a), (_, b), (_, p0)
           in zip(leaf_paths(s1["params"]), leaf_paths(whole["params"]),
                  leaf_paths(params))}
    upd_err = max(upd.values())
    assert upd_err <= RTOL, upd
    assert int(whole["opt"]["step"]) == 3

    # the checkpoint: gathered on every rank, written by rank 0 alone
    ck = tmp / "ck"
    CheckpointManager(str(ck)).save(3, s2, extra={"step": 3})
    if rank == 0:
        plain = tmp / "ck_plain"
        CheckpointManager(str(plain)).save(3, whole, extra={"step": 3})
        for f in sorted((plain / "step_00000003").iterdir()):
            assert f.read_bytes() == (ck / "step_00000003" / f.name
                                      ).read_bytes(), f.name
    template = _f32_state(model, _draw(model, 1), compress=True)
    restored, rmesh, extra = elastic_restore(model, str(ck), template=template,
                                             device=DEVICE)
    assert tuple(rmesh.shape) == (4, 1) and extra == {"step": 3}
    got = _whole(restored)
    for (path, a), (_, b) in zip(leaf_paths(whole), leaf_paths(got)):
        assert torch.equal(a, b), path
    rp = restored["params"]["embed"]
    assert isinstance(rp, DTensor) and tuple(rp.placements) == (
        Shard(1), Shard(0))
    assert rp.to_local().shape[1] == cfg.d_model // 4
    # restore(shardings=): a params checkpoint onto the (2, 2) placements
    ckp = tmp / "ck_params"
    CheckpointManager(str(ckp)).save(3, s2["params"])
    pshard = param_shardings(model.logical_axes(), mesh, fsdp=True,
                             abstract_tree=model.abstract_params())
    back, _ = CheckpointManager(str(ckp)).restore(
        template=template["params"], shardings=pshard)
    for (path, a), (_, b) in zip(leaf_paths(back), leaf_paths(s2["params"])):
        assert tuple(a.placements) == tuple(b.placements), path
        assert torch.equal(a.to_local(), b.to_local()), path
    # the constrainer redistributes a DTensor to the spec of its shape
    x = place(torch.arange(4 * 8 * 16.0, device=DEVICE).reshape(4, 8, 16),
              mesh, (Replicate(), Replicate()))
    y = constrain(x, ("batch", None, "embed"))
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert torch.equal(y.full_tensor(), x.full_tensor())
    assert constrain(x.full_tensor(), ("batch", None, "embed")).shape == \
        (4, 8, 16)
    ada = _adafactor_step(mesh, tmp, rank)
    run = _run_with_crash(model, constrain, mesh, tmp, rank)
    if rank == 0:   # elastic_one's reference: every leaf, whole
        torch.save(tree_map(lambda t: t.cpu(), whole), tmp / "whole.pt")
    l1 = _max_over_ranks(loss_err)
    return {"loss_rel_err": l1, "grad_max_rel_err": _max_over_ranks(grad_err),
            "step_loss_rel_err": _max_over_ranks(step_err),
            "gnorm_rel_err": _max_over_ranks(gnorm_err),
            "update_max_rel_err": _max_over_ranks(upd_err),
            "adafactor": {k: _max_over_ranks(v) for k, v in ada.items()},
            "losses": losses, "run": run}


def _adafactor_step(mesh, tmp, rank):
    """Reduced kimi-k2 (MoE, ``fsdp``, Adafactor): two sharded steps
    against one process.  Adafactor's factored moments are sharded by
    their param's spec less the dim each averages away; their means
    over a split dim are reduced over its ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from chip_smoke import conditioned
    from repro_torch.dist import activation_constrainer
    from repro_torch.dist.partitioning import batch_shard
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths, tree_map
    base = _reduced("kimi-k2-1t-a32b")
    assert base.fsdp and base.optimizer == "adafactor"
    # capacity counts each rank's tokens (see test_torch_dist.py): a
    # factor that drops no token keeps one process's answer
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=8.0))
    model = build_model(cfg)
    params = conditioned(_draw(model, 2))
    tc = TrainConfig(total_steps=3, warmup_steps=0,
                     ckpt_dir=str(tmp / f"ada{rank}"))
    one = Trainer(model, tc, None, device=DEVICE)
    sh = Trainer(model, tc, None, device=DEVICE,
                 constrain=activation_constrainer(mesh, fsdp=True))
    clone = lambda tr: tree_map(lambda t: t.detach().clone(), tr)  # noqa
    s1 = _f32_state(model, clone(params))
    s2 = sh.shard_state(_f32_state(model, clone(params)))
    slots = s2["opt"]["slots"]["layers"]["attn"]["wq"]
    assert isinstance(slots["m"], DTensor)
    # the factored moments by wq's spec (None, "data", "model", None)
    # less the dim each drops, as the reference's dry run places them
    assert tuple(slots["vr"].placements) == (Shard(1), Shard(2))
    assert tuple(slots["vc"].placements) == (Shard(1), Replicate())
    sid, n = batch_shard(mesh)
    rng = np.random.default_rng(11)
    errs = []
    for _ in range(3):
        b = _batch(rng, cfg, 4, 16)
        m1 = one.train_step(s1, b)
        m2 = sh.train_step(s2, _rows(b, sid, n))
        errs.append(abs(float(m2["loss"]) - float(m1["loss"]))
                    / abs(float(m1["loss"])))
    # a bad step (a loss that is not finite): no leaf moves, the step
    # count advances, on every rank
    before = _whole(s2)
    good = sh.loss_and_grads
    sh.loss_and_grads = lambda p, b: (
        torch.tensor(float("nan"), device=DEVICE), good(p, b)[1])
    m = sh.train_step(s2, _rows(_batch(rng, cfg, 4, 16), sid, n))
    sh.loss_and_grads = good
    after = _whole(s2)
    assert float(m["bad_step"]) == 1.0
    assert int(after["opt"]["step"]) == int(before["opt"]["step"]) + 1
    for (path, a), (_, b) in zip(leaf_paths(before), leaf_paths(after)):
        if a.ndim:
            assert torch.equal(a, b), path
    whole = _whole(s2)
    upd = max(rel_max(b.detach() - p0, a.detach() - p0)
              for (_, a), (_, b), (_, p0) in zip(
                  leaf_paths(s1["params"]), leaf_paths(whole["params"]),
                  leaf_paths(params)))
    assert max(errs) <= RTOL, errs
    # each leaf's update, in max norm: Adafactor divides by the factored
    # second moments, so on rows of experts few tokens reach it grows
    # the grads' ~1e-6 differences (about 1e-3 measured)
    assert upd <= ADAFACTOR_UPDATE_RTOL, upd
    return {"loss_rel_err": max(errs), "update_max_rel_err": upd}


def _run_with_crash(model, constrain, mesh, tmp, rank):
    """``Trainer.run`` over the mesh from ``launch/train.py``'s data path
    (each rank its rows by ``batch_shard``): a crash at step 3 with a
    checkpoint every 2, then a fresh trainer resumes at 2 and ends at
    4; the replayed step 3 equals the crashed run's, and the final
    checkpoint restores every rank's shards bit for bit."""
    from repro_torch.data import (IndexedTokenDataset, PackedTokenStore,
                                  ShardedLoader)
    from repro_torch.dist.partitioning import batch_shard
    from repro_torch.train import (CheckpointManager, FailureInjector,
                                   TrainConfig, Trainer)
    from repro_torch.tree import leaf_paths
    store = PackedTokenStore.synthetic(64, mean_len=17, vocab=model.cfg.vocab,
                                       seed=0)
    sid, n = batch_shard(mesh)

    def loader():
        ds = IndexedTokenDataset.build(store, method="pgm", sample_rate=0.5,
                                       gap_rho=0.15, device=DEVICE)
        return ShardedLoader(ds, global_batch=4, seq_len=16, seed=0,
                             shard_id=sid, n_shards=n)

    cfg = TrainConfig(total_steps=4, warmup_steps=1, ckpt_every=2,
                      ckpt_dir=str(tmp / "run"), log_every=1)
    t1 = Trainer(model, cfg, loader(), constrain=constrain,
                 failure_injector=FailureInjector({3: "crash"}),
                 device=DEVICE)
    try:
        t1.run(seed=0)
        raise AssertionError("run 1 did not crash")
    except RuntimeError as e:
        assert "injected crash at step 3" in str(e), e
    t1.watchdog.close()
    t2 = Trainer(model, cfg, loader(), constrain=constrain, device=DEVICE)
    out = t2.run(seed=0)
    t2.watchdog.close()
    run1 = [m["loss"] for m in t1.metrics]
    run2 = [m["loss"] for m in out["metrics"]]
    assert [m["step"] for m in out["metrics"]] == [3, 4]
    assert run2[0] == run1[2], (run1, run2)
    restored, extra = CheckpointManager(cfg.ckpt_dir).restore(
        template=out["state"])
    for (path, a), (_, b) in zip(leaf_paths(out["state"]),
                                 leaf_paths(restored)):
        la = a.to_local() if hasattr(a, "to_local") else a
        lb = b.to_local() if hasattr(b, "to_local") else b
        assert torch.equal(la, lb), path
    assert extra == {"step": 4, "loader_step": 4}
    return {"run1": run1, "run2": run2}


def elastic_one(rank, world, tmp):
    """The (2, 2) run's checkpoint restored onto a (1, 1) mesh in a
    group of one: every leaf equal to the whole state the (2, 2) run
    gathered (its ``whole.pt``)."""
    from repro_torch.models import build_model
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.tree import leaf_paths
    cfg = _reduced("internlm2-1.8b", fsdp=True)
    model = build_model(cfg)
    template = _f32_state(model, _draw(model, 1), compress=True)
    restored, mesh, extra = elastic_restore(model, str(tmp / "ck"),
                                            template=template, device=DEVICE)
    assert tuple(mesh.shape) == (1, 1) and extra == {"step": 3}
    got = leaf_paths(_whole(restored))
    want = leaf_paths(torch.load(tmp / "whole.pt"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), path
    return {"leaves": len(got)}


def moe_ep_training(rank, world, tmp):
    """Reduced granite-moe with ``moe_impl="ep"`` and capacity factor 8
    (no token dropped) on a (2, 2) mesh: loss and grads within 1e-4 of
    one process running ``moe_gspmd`` on the whole batch."""
    from chip_smoke import conditioned
    from repro_torch.configs.base import MoEConfig
    from repro_torch.dist import activation_constrainer
    from repro_torch.dist.partitioning import batch_shard
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths, tree_map
    base = _reduced("granite-moe-1b-a400m")
    moe = dataclasses.replace(base.moe, capacity_factor=8.0)
    assert isinstance(moe, MoEConfig)
    gs = build_model(dataclasses.replace(base, moe=moe))
    ep = build_model(dataclasses.replace(base, moe=moe, moe_impl="ep"))
    mesh = _mesh((2, 2))
    params = conditioned(_draw(gs, 0))
    batch = _batch(np.random.default_rng(9), base, 4, 16)
    tc = TrainConfig(ckpt_dir=str(tmp / f"moe{rank}"))
    one = Trainer(gs, tc, None, device=DEVICE)
    sh = Trainer(ep, tc, None, constrain=activation_constrainer(mesh),
                 device=DEVICE)
    clone = lambda tr: tree_map(lambda t: t.detach().clone(), tr)  # noqa
    l1, g1 = one.loss_and_grads(clone(params), batch)
    sid, n = batch_shard(mesh)
    # the tensor-parallel design takes and gives each rank's shards
    assert sh.design == "tensor-parallel"
    l2, g2 = sh.loss_and_grads(_shards_of(sh, params), _rows(batch, sid, n))
    loss_err = abs(float(l2) - float(l1)) / abs(float(l1))
    grad_err = max(_shard_err(b, a, sh._shardings[path])
                   for (path, a), (_, b) in
                   zip(leaf_paths(g1), leaf_paths(g2)))
    loss_err, grad_err = _max_over_ranks(loss_err), _max_over_ranks(grad_err)
    assert loss_err <= RTOL and grad_err <= RTOL, (loss_err, grad_err)
    return {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err}


# ---------------------------------------------------------------------------
# tensor parallelism (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

# reduced LM-family configs: (arch, overrides).  "guard": qwen-style
# (qkv bias, FSDP) with 6 heads, whole on a "model" axis of 4;
# "kv_index": 12 query heads over 3 KV heads, a KV count no "model"
# axis of 2 or 4 divides, with local query heads that are neither whole
# groups nor a part of one (``base._kv_of_heads``'s index path)
TP_CELLS = {
    "internlm2": ("internlm2-1.8b", {}),
    "granite_ep": ("granite-moe-1b-a400m", {"moe_impl": "ep"}),
    "granite": ("granite-moe-1b-a400m", {}),
    "yi_fsdp": ("yi-9b", {}),
    "kimi": ("kimi-k2-1t-a32b", {}),
    "guard": ("qwen1.5-32b", {"n_heads": 6, "n_kv": 6}),
    "kv_index": ("internlm2-1.8b", {"n_heads": 12, "n_kv": 3,
                                    "head_dim": 8}),
}
# the other four families (tests/test_torch_tp_families.py), reduced.
# xlstm: 8 blocks (block 7 is the sLSTM) at d_model 96, so the sLSTM's
# GeGLU FFN (4/3 of it, 128) splits over "model" too; "_fsdp": FSDP on
# (the per-layer gathers over "data"); "whisper_guard": 6 heads and 6 KV
# heads, whole on a "model" axis of 4, as whisper-base's 8 are on 16;
# "xlstm_guard": 3 heads, whole on 4 as xlstm-125m's 4 are on 16 (the
# mLSTM cell whole between its split up- and down-projections)
TP_FAMILY_CELLS = {
    "internvl2": ("internvl2-2b", {}),
    "whisper": ("whisper-base", {}),
    "zamba": ("zamba2-1.2b", {}),
    "zamba_fsdp": ("zamba2-1.2b", {"fsdp": True}),
    "xlstm": ("xlstm-125m", {"n_layers": 8, "d_model": 96}),
    "xlstm_fsdp": ("xlstm-125m", {"n_layers": 8, "d_model": 96,
                                  "fsdp": True}),
    "whisper_guard": ("whisper-base", {"n_heads": 6, "n_kv": 6}),
    "xlstm_guard": ("xlstm-125m", {"n_layers": 8, "d_model": 96,
                                   "n_heads": 3}),
}
# full width at 2 layers (whisper 2 + 2, zamba 6: one shared block,
# xlstm 8: one sLSTM), for four cards over ``nccl``
TP_FULL_CELLS = {"internlm2_full2": ("internlm2-1.8b", 2),
                 "yi_full2": ("yi-9b", 2),
                 "internvl2_full": ("internvl2-2b", 2),
                 "whisper_full": ("whisper-base", 2),
                 "zamba_full": ("zamba2-1.2b", 6),
                 "xlstm_full": ("xlstm-125m", 8)}
TP_MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}


def tp_config(cell):
    if cell in TP_FULL_CELLS:
        from repro_torch.configs import ARCHS
        arch, layers = TP_FULL_CELLS[cell]
        kw = {"n_enc_layers": layers} if ARCHS[arch].n_enc_layers else {}
        return dataclasses.replace(ARCHS[arch], n_layers=layers,
                                   remat="full", **kw)
    arch, kw = {**TP_CELLS, **TP_FAMILY_CELLS}[cell]
    cfg = _reduced(arch, remat="full", **kw)
    if cfg.moe is not None:   # no token dropped (see test_torch_dist.py)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _cut(whole, like):
    """This rank's shard of one process's ``whole`` leaf, by the
    placements of ``like`` (a DTensor or a ``Sharding``)."""
    from repro_torch.dist.partitioning import place
    return place(whole.detach(), like.mesh if hasattr(like, "spec")
                 else like.device_mesh, like.placements).to_local()


def _shards_of(trainer, params):
    """This rank's shards of one process's whole ``params`` by
    ``trainer``'s param shardings (what a tensor-parallel step takes)."""
    from repro_torch.tree import leaf_paths, unflatten
    return unflatten(params, [_cut(t, trainer._shardings[path]).clone()
                              for path, t in leaf_paths(params)])


def _shard_err(local, whole, like):
    """max |local - whole's shard| over max |whole|: a shard's error on
    the whole leaf's scale."""
    whole = whole.detach()
    return float((local.detach() - _cut(whole, like)).abs().max()) / max(
        float(whole.abs().max()), 1e-30)


@contextlib.contextmanager
def _grads_of(trainer):
    """Within: each ``trainer.loss_and_grads`` call's grads appended to
    the yielded list (the optimizer reads them and writes nothing)."""
    got, inner = [], trainer.loss_and_grads

    def keep(params, batch):
        loss, grads = inner(params, batch)
        got.append(grads)
        return loss, grads
    trainer.loss_and_grads = keep
    try:
        yield got
    finally:
        trainer.loss_and_grads = inner


def _bits(t):
    """``t``'s bits as an int32 tensor (f32 as they are, bf16 widened)."""
    t = t.detach().contiguous()
    if t.element_size() == 2:
        return t.view(torch.int16).to(torch.int32)
    return t.view(torch.int32)


def _replicas_differ(t, placements, mesh) -> bool:
    """Whether the local ``t`` differs in any bit from a copy on another
    rank of a mesh dim that ``placements`` replicate it over (each such
    dim's elementwise max and min of the bits; every rank runs the same
    collectives whatever it finds)."""
    bits, differ = _bits(t), False
    for i, pl in enumerate(placements):
        if not pl.is_replicate() or mesh.size(i) == 1:
            continue
        hi, lo = bits.clone(), bits.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.get_group(i))
        differ |= not torch.equal(hi, lo)
    return differ


def _assemble(local, like, shape):
    """The whole leaf of ``shape`` from each rank's ``local`` shard by
    ``like``'s placements (a replicated dim keeps this rank's copy)."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.detach(), like.mesh, like.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride).full_tensor()


def _on_all_ranks(items):
    """The sorted union of every rank's ``items``."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, sorted(items))
    return sorted(set().union(*map(set, out)))


def _clip_scale(gnorm, clip_norm=1.0):
    """The optimizers' clip factor for a global norm (their default
    ``clip_norm``)."""
    return torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def _adamw_direction(m, v, step):
    """AdamW's direction ``mh / (sqrt(vh) + eps)`` at ``step`` (the
    step count after the update), with ``adamw_update``'s defaults."""
    from repro_torch.optim.adamw import adamw_update
    kw = {k: p.default for k, p in
          inspect.signature(adamw_update).parameters.items()
          if k in ("b1", "b2", "eps")}
    mh = m / (1 - kw["b1"] ** step)
    vh = v / (1 - kw["b2"] ** step)
    return mh / (torch.sqrt(vh) + kw["eps"]), kw["b1"]


def _sign_moves(A, B, G1, Gm, gnorm_1, gnorm_m):
    """(d): ``B - A`` = U(S, Gm) - U(S, G1) read leaf by leaf.  In each
    AdamW leaf, the components whose direction has another sign in the
    two (``[count, max |G1| of them, max |Gm - G1|]``, both on the
    leaf's grad scale), and how many of them are not the grads'
    doing: a flip on a ``|G1|`` above the leaf's grad difference whose
    new first moment (one process's) is also above the difference's
    share of it, ``(1 - b1) max |s_m Gm - s_1 G1|`` (``s`` the clip
    factors) plus one rounding of ``(1 - b1) s_1 |G1|``.  With ``S``'s
    moments zero (step 1) a flip's ``|G1|`` is at most the difference;
    at a later step a flip may also sit where the old moment cancels
    the new grad's share."""
    from repro_torch.tree import leaf_paths
    step = int(B["opt"]["step"])
    s1, sm = _clip_scale(gnorm_1), _clip_scale(gnorm_m)
    by_leaf, unexplained, above = {}, 0, 0
    g1s, gms = dict(leaf_paths(G1)), dict(leaf_paths(Gm))
    vAs, mBs, vBs = (dict(leaf_paths(t)) for t in (
        A["opt"]["v"], B["opt"]["m"], B["opt"]["v"]))
    for path, mA in leaf_paths(A["opt"]["m"]):
        vA, mB, vB = vAs[path], mBs[path], vBs[path]
        dA, b1 = _adamw_direction(mA, vA, step)
        dB, _ = _adamw_direction(mB, vB, step)
        flips = torch.sign(dA) != torch.sign(dB)
        n = int(flips.sum())
        if not n:
            continue
        g1, gm = g1s[path].float(), gms[path].float()
        scale = max(float(g1.abs().max()), 1e-30)
        gdiff = float((gm - g1).abs().max())
        share = (1 - b1) * float((sm * gm - s1 * g1).abs().max())
        g_f = g1[flips].abs()
        big = g_f > gdiff
        loose = mA[flips].abs() > share + 2.0 ** -22 * (1 - b1) * float(
            s1) * g_f
        above += int(big.sum())
        unexplained += int((big & loose).sum())
        by_leaf["/".join(map(str, path))] = [n, float(g_f.max()) / scale,
                                             gdiff / scale]
    return by_leaf, above, unexplained


def _step_readings(one, sh, S, A, G1, M, Gm_local, gnorm_1, gnorm_m,
                   noise):
    """The per-step check from a common state ``S`` (the one process's
    state before the step, whole; consumed: it becomes U(S, Gm)).  ``A``
    = U(S, G1) is the one process's state after its step on the whole
    batch, ``G1`` its grads; ``M`` the mesh's state after its step from
    ``shard_state(S)`` on its rows, ``Gm_local`` this rank's grad shards
    and ``gnorm_m`` its global norm.

    (a) ``grad_rel_err``: the mesh's grads assembled whole (``Gm``)
    against ``G1``, leaf by leaf on the leaf's scale (``grad_misses``:
    the leaves above ``RTOL``; for them ``noise(S's params, Gm,
    names)`` gives ``grad_ulp_spread_rank0``, how far one process's own
    grads of each move under one-ulp changes of the params, and
    ``grad_row_split_rank0``, ``_row_split``'s reading); and
    ``grad_excess``, the largest ratio of a leaf's error to ``max(RTOL,
    2 x`` its one-ulp spread``)``, the rule ``state_excess`` holds the
    state to.
    (b) the one process's optimizer on ``S`` with ``Gm`` and the mesh's
    ``gnorm``, U(S, Gm), cut by each leaf's placements, against the
    rank's state: ``update_mismatches`` lists the leaves that differ in
    any bit (AdamW's, Adafactor's unfactored leaves, the step count),
    ``adafactor_update_rel_err`` the largest error of a factored param's
    update on its change's scale and of its ``m`` / ``vr`` / ``vc`` on
    their scale (their means reduce over split dims in another order).
    (c) ``replica_mismatches``: the grads and state leaves (and the
    global norm) that differ in any bit between two ranks holding the
    same copy.
    (d) ``_sign_moves`` of U(S, Gm) - U(S, G1) (AdamW), and
    ``state_rel_err``, its largest leaf on the leaf's scale."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.optim import OPTIMIZERS
    from repro_torch.tree import leaf_paths, unflatten
    mesh = sh.mesh
    ada = sh.model.cfg.optimizer == "adafactor"
    # (a), and (c) of the grads
    whole, grad_err, worst, misses, rep = [], 0.0, None, {}, []
    for (path, g1), (_, gm) in zip(leaf_paths(G1), leaf_paths(Gm_local)):
        like = sh._shardings[path]
        name = "grads/" + "/".join(map(str, path))
        if _replicas_differ(gm, like.placements, mesh):
            rep.append(name)
        w = _assemble(gm, like, tuple(g1.shape))
        whole.append(w)
        e = rel_max(w.float(), g1.float())
        if e > RTOL:
            misses[name] = e
        if e >= grad_err:
            grad_err, worst = e, name
    Gm = unflatten(G1, whole)
    if _replicas_differ(gnorm_m, [Replicate()] * mesh.ndim, mesh):
        rep.append("gnorm")
    spread, split = noise(S["params"], Gm, misses) if misses else ({}, {})
    excess = max([misses[k] / max(RTOL, 2 * spread[k]) for k in misses],
                 default=0.0)
    # (b): U(S, Gm) with the one process's optimizer, S updated in place
    p0 = ({p: t.detach().clone() for p, t in leaf_paths(S["params"])}
          if ada else {})
    update = OPTIMIZERS[sh.model.cfg.optimizer][1]
    params, opt, _ = update(Gm, S["opt"], S["params"],
                            lr=one.lr_at(S["opt"]["step"]), gnorm=gnorm_m)
    B = {"params": params, "opt": opt, "residual": S["residual"]}
    factored = set()
    if ada:
        factored = {p[:-1] for p, _ in leaf_paths(opt["slots"])
                    if p[-1] == "vr"}
    exact, loose = [], 0.0
    for (path, b), (_, m) in zip(leaf_paths(B), leaf_paths(M)):
        name = "/".join(map(str, path))
        if not isinstance(m, DTensor):   # the step count, placeholders
            if not torch.equal(b, m):
                exact.append(name)
            continue
        if _replicas_differ(m.to_local(), m.placements, mesh):
            rep.append(name)
        want = _cut(b, m)
        got = m.to_local().detach()
        if ada and path[0] == "params" and path[1:] in factored:
            before = _cut(p0[path[1:]], m)
            loose = max(loose, rel_max(got.float() - before.float(),
                                       want.float() - before.float()))
        elif ada and path[0] == "opt" and path[2:-1] in factored:
            loose = max(loose, _shard_err(got.float(), b.float(), m))
        elif not torch.equal(got, want):
            exact.append(name)
    # (d), and U(S, Gm) - U(S, G1) on each leaf's scale
    state_err = max(rel_max(b.detach().float(), a.detach().float())
                    for (_, a), (_, b) in zip(leaf_paths(A), leaf_paths(B))
                    if a.ndim)
    flips, above, unexplained = ({}, 0, 0) if ada else _sign_moves(
        A, B, G1, Gm, gnorm_1, gnorm_m)
    return {"grad_rel_err": _max_over_ranks(grad_err),
            "grad_worst_rank0": worst, "grad_misses_rank0": misses,
            "grad_ulp_spread_rank0": spread, "grad_row_split_rank0": split,
            "grad_excess": _max_over_ranks(excess),
            "update_mismatches": _on_all_ranks(exact),
            "adafactor_update_rel_err": _max_over_ranks(loose),
            "replica_mismatches": _on_all_ranks(rep),
            "state_rel_err": state_err,
            "sign_flips": sum(v[0] for v in flips.values()),
            "flips_above_grad_diff": above,
            "flips_unexplained": int(_max_over_ranks(unexplained)),
            "flips_by_leaf_rank0": flips}


def _ulp_draws(one, params, batch, G1, names, draws=3):
    """For each leaf in ``names`` (``grads/...``): the largest error on
    its scale of one process's grads, over ``draws`` draws of its f32
    params moved by one ulp (relative 2^-23 normal noise), against
    ``G1``."""
    from repro_torch.tree import leaf_paths, tree_map
    out = dict.fromkeys(names, 0.0)
    for d in range(draws):
        g = torch.Generator(device="cpu").manual_seed(200 + d)
        p = tree_map(lambda t: (t * (1 + 2.0 ** -23 * torch.randn(
            t.shape, generator=g).to(t.device))).detach(), params)
        _, gd = one.loss_and_grads(p, batch)
        for (path, a), (_, b) in zip(leaf_paths(G1), leaf_paths(gd)):
            name = "grads/" + "/".join(map(str, path))
            if name in out:
                out[name] = max(out[name], rel_max(b.float(), a.float()))
    return out


def _row_split(one, params, batch, n, G1, Gm, names):
    """For each leaf in ``names``: one process's grads of ``batch`` taken
    in the mesh's ``n`` row groups (rows ``i::n``), each group's mean
    loss weighted by its token share before the backward as the mesh
    weights a rank's, summed in group order (what the batch split alone
    does to the order of the sums); ``[its error against G1, Gm's error
    against it]`` on the leaf's scale."""
    from repro_torch.tree import leaf_paths, leaves, tree_map
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    flat = leaves(p)
    parts = [_rows(batch, i, n) for i in range(n)]
    counts = [torch.clamp(torch.sum(r["mask"].float()), min=1.0)
              for r in parts]
    total = sum(counts)
    acc = None
    for r, c in zip(parts, counts):
        g = torch.autograd.grad(one.model.loss_fn(p, r, None) * (c / total),
                                flat, allow_unused=True)
        g = [torch.zeros_like(x) if y is None else y for x, y in zip(flat, g)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    out = {}
    for (path, a), (_, b), c in zip(leaf_paths(G1), leaf_paths(Gm), acc):
        name = "grads/" + "/".join(map(str, path))
        if name in names:
            out[name] = [rel_max(c.float(), a.float()),
                         rel_max(b.float(), c.float())]
    return out


def _per_step(one, sh, s_one, s_mesh, batch, rows):
    """One step of each trainer from one state: ``s_one`` (the one
    process's, whole) and ``s_mesh`` (``shard_state`` of the same
    state), each stepped in place, ``batch`` whole and this rank's
    ``rows`` of it.  Returns ``_step_readings`` (with, for each leaf
    whose grads miss ``RTOL``, its one-ulp spread over three draws and
    ``_row_split``) and the two steps' metrics."""
    from repro_torch.dist.partitioning import batch_shard
    from repro_torch.tree import tree_map
    S = tree_map(lambda t: t.detach().clone(), s_one)
    with _grads_of(one) as g1:
        m1 = one.train_step(s_one, batch)
    with _grads_of(sh) as gm:
        mm = sh.train_step(s_mesh, rows)
    out = _step_readings(
        one, sh, S, s_one, g1[0], s_mesh, gm[0], m1["gnorm"], mm["gnorm"],
        lambda params, Gm, names: (
            _ulp_draws(one, params, batch, g1[0], names),
            _row_split(one, params, batch, batch_shard(sh.mesh)[1], g1[0],
                       Gm, names)))
    return out, m1, mm


def tp_training(rank, world, tmp, cell, mesh_name):
    """One reduced LM-family config on a ``TP_MESHES`` mesh in f32 on
    ``conditioned`` params, under the tensor-parallel design: the loss
    and every grad shard of a masked batch against one process; then
    two ``Trainer`` steps from one state (lr at its peak from the
    first): losses and gnorms, and every leaf of each rank's state
    (its placements those of the leaf's spec) against one process's
    state cut by them, on the leaf's scale; the step count exactly.
    AdamW's first update divides each grad component by its own size,
    so a component whose grad is below the grads' rounding differences
    moves by a sign the differences decide: the params are held on
    their own scale (a skipped update misses by 2 lr, over 1e-3 of it),
    not on their change's.  Adafactor's bf16 momentum and the factored
    moments it divides by are held at ``ADAFACTOR_UPDATE_RTOL`` (see
    ``_adafactor_step``).  ``grad_ulp_spread`` / ``step_ulp_spread``:
    how far one process's own grads (on each leaf's scale) and two
    steps' losses and gnorms move when its f32 params move by one ulp
    (the bound for a model that sensitive); ``state_ulp_spread`` the
    same of each state leaf's shard, and ``state_excess`` the largest
    ratio of a leaf's error to ``max(1e-4, 2 x`` its own spread``)``,
    with its leaf, error and spread on rank 0 (``state_worst_rank0``):
    a leaf whose AdamW sign moves the rounding decides has a spread of
    its error's size, any other leaf one below 1e-4.

    ``per_step``: each step k of the two again from a common state, the
    one process's before it (``_per_step``, ``_step_readings``), so
    that no difference of step 1 compounds into step 2: the grads, the
    update apart from them, the replicas, and the sign moves."""
    from torch.distributed.tensor import DTensor
    from chip_smoke import conditioned
    from repro_torch.dist import activation_constrainer
    from repro_torch.dist.partitioning import batch_shard, local_shard
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths, leaves, tree_map
    cfg = tp_config(cell)
    model = build_model(cfg)
    mesh = _mesh(TP_MESHES[mesh_name])
    params = conditioned(_draw(model, 0))
    rng = np.random.default_rng(7)
    batches = [_batch(rng, cfg, 8, 16) for _ in range(3)]
    sid, n_shards = batch_shard(mesh)
    tc = TrainConfig(total_steps=2, warmup_steps=0,
                     ckpt_dir=str(tmp / f"tp{rank}"))
    one = Trainer(model, tc, None, device=DEVICE)
    sh = Trainer(model, tc, None, device=DEVICE,
                 constrain=activation_constrainer(mesh, fsdp=cfg.fsdp))
    assert sh.design == "tensor-parallel"
    clone = lambda tr: tree_map(lambda t: t.detach().clone(), tr)  # noqa
    s1 = _f32_state(model, clone(params))
    s2 = sh.shard_state(_f32_state(model, clone(params)))
    l1, g1 = one.loss_and_grads(clone(params), batches[0])
    local = tree_map(lambda t: local_shard(t).detach().clone(),
                     s2["params"])
    l2, g2 = sh.loss_and_grads(local, _rows(batches[0], sid, n_shards))
    loss_err = abs(float(l2) - float(l1)) / abs(float(l1))
    grad_err, worst = max(
        (_shard_err(b, a, sh._shardings[path]), path)
        for (path, a), (_, b) in zip(leaf_paths(g1), leaf_paths(g2)))
    # the one process again from params moved by one ulp (relative
    # 2^-23 normal noise): how far its own grads and steps move
    g = torch.Generator(device="cpu").manual_seed(100)
    p0 = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
        t.shape, generator=g).to(t.device)), clone(params))
    _, g0 = one.loss_and_grads(clone(p0), batches[0])
    grad_spread = max(rel_max(b, a) for a, b in zip(leaves(g1),
                                                     leaves(g0)))
    del g0
    s0 = _f32_state(model, p0)
    del g1, g2
    steps, per_step = [], []
    for k, b in enumerate(batches[1:], 1):
        rows = _rows(b, sid, n_shards)
        # the per-step check from the one process's state before step k
        # (``_per_step``); at k = 1 the mesh's own state is that state's
        # shards, so its step is the two-step run's first
        if k == 1:
            check, m1, m2 = _per_step(one, sh, s1, s2, b, rows)
        else:
            mk = sh.shard_state(tree_map(lambda t: t.detach().clone(), s1))
            check, m1, _ = _per_step(one, sh, s1, mk, b, rows)
            del mk
            m2 = sh.train_step(s2, rows)
        per_step.append(check)
        m0 = one.train_step(s0, b)
        steps.append((float(m1["loss"]), float(m2["loss"]),
                      float(m1["gnorm"]), float(m2["gnorm"]),
                      float(m0["loss"]), float(m0["gnorm"])))
    step_err = max(abs(b - a) / abs(a) for a, b, *_ in steps)
    gnorm_err = max(abs(d - c) / abs(c) for _, _, c, d, *_ in steps)
    spread = max(max(abs(e - a) / abs(a), abs(f - c) / abs(c))
                 for a, _, c, _, e, f in steps)
    state_err, loose_err, state_spread = 0.0, 0.0, 0.0
    excess = (0.0, None, 0.0, 0.0)
    for (path, a), (_, b), (_, c) in zip(leaf_paths(s1), leaf_paths(s2),
                                         leaf_paths(s0)):
        if not isinstance(b, DTensor):   # the step count
            assert torch.equal(a, b), path
            continue
        assert b.placements == _shard_like(sh, path).placements, path
        err = _shard_err(b.to_local().float(), a.float(), b)
        if cfg.optimizer == "adafactor" and path[0] == "opt" and \
                path[-1] in ("m", "vr", "vc"):
            loose_err = max(loose_err, err)
        else:
            state_err = max(state_err, err)
            own = _shard_err(_cut(c.float(), b), a.float(), b)
            state_spread = max(state_spread, own)
            excess = max(excess, (err / max(1e-4, 2 * own),
                                  "/".join(map(str, path)), err, own))
    out = {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
           "step_loss_rel_err": step_err, "gnorm_rel_err": gnorm_err,
           "state_max_rel_err": state_err, "adafactor_rel_err": loose_err,
           "grad_ulp_spread": grad_spread, "step_ulp_spread": spread,
           "state_ulp_spread": state_spread, "state_excess": excess[0]}
    return {**{k: _max_over_ranks(v) for k, v in out.items()},
            "grad_worst_leaf_rank0": "/".join(map(str, worst)),
            "state_worst_rank0": excess[1:], "per_step": per_step}


STEP_FAULT_RANK = 1
STEP_FAULT_LEAF = {"step": ("layers", "attn", "wq"),   # split on "model"
                   "reduce": ("ln_f",)}                 # replicated


def _plant(sh, fault):
    """A fault in this rank's mesh trainer, patched on the instance (no
    port code changes).  "step": the optimizer updates this rank's shard
    of ``STEP_FAULT_LEAF["step"]`` with the step count one too high.
    "reduce": this rank's grad of ``STEP_FAULT_LEAF["reduce"]`` skips
    its sum over "data" (the rank still joins the collective, with a
    copy, so the group stays in step)."""
    from repro_torch.tree import leaf_paths
    target = STEP_FAULT_LEAF[fault]
    if fault == "step":
        paths = [p for p, _ in leaf_paths(sh.model.abstract_params())]
        i = paths.index(target)
        assert 0 < i < len(paths) - 1 and sh.tp.splits(
            sh._shardings[target].spec, 2)
        update, calls = sh._opt_update, [0]

        def off_by_one(grads, state, params, **kw):
            n, calls[0] = calls[0], calls[0] + 1
            if n % len(paths) == i:
                state = {**state, "step": state["step"] + 1}
            return update(grads, state, params, **kw)
        sh._opt_update = off_by_one
        return
    data = sh.tp.axes["data"].group
    split_axes, asked = sh._split_axes, [None]
    all_reduce = dist.all_reduce

    def ask(path, dim=None):
        asked[0] = path
        return split_axes(path, dim)

    def skip(t, *args, group=None, **kw):
        if asked[0] == target and group is data:   # this leaf's sum only
            asked[0] = None
            all_reduce(t.clone(), *args, group=group, **kw)
            return None
        return all_reduce(t, *args, group=group, **kw)
    inner = sh.loss_and_grads

    def loss_and_grads(params, batch):
        sh._split_axes, dist.all_reduce = ask, skip
        try:
            return inner(params, batch)
        finally:
            sh._split_axes, dist.all_reduce = split_axes, all_reduce
            asked[0] = None
    sh.loss_and_grads = loss_and_grads


def tp_step_fault(rank, world, tmp, fault):
    """``_per_step`` of reduced internlm2 on a (2, 2) mesh from one fresh
    state, with ``fault`` ("none", or a ``_plant`` fault) planted in
    rank ``STEP_FAULT_RANK``'s mesh trainer: the readings, which must
    name the fault."""
    from chip_smoke import conditioned
    from repro_torch.dist import activation_constrainer
    from repro_torch.dist.partitioning import batch_shard
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import tree_map
    cfg = tp_config("internlm2")
    model = build_model(cfg)
    mesh = _mesh((2, 2))
    params = conditioned(_draw(model, 0))
    batch = _batch(np.random.default_rng(7), cfg, 8, 16)
    tc = TrainConfig(total_steps=2, warmup_steps=0,
                     ckpt_dir=str(tmp / f"fault{rank}"))
    one = Trainer(model, tc, None, device=DEVICE)
    sh = Trainer(model, tc, None, device=DEVICE,
                 constrain=activation_constrainer(mesh, fsdp=cfg.fsdp))
    if fault != "none" and rank == STEP_FAULT_RANK:
        _plant(sh, fault)
    clone = lambda tr: tree_map(lambda t: t.detach().clone(), tr)  # noqa
    s_one = _f32_state(model, clone(params))
    s_mesh = sh.shard_state(_f32_state(model, clone(params)))
    check, _, _ = _per_step(one, sh, s_one, s_mesh, batch,
                            _rows(batch, *batch_shard(mesh)))
    return {**check, "fault_rank": STEP_FAULT_RANK,
            "fault_leaf": "/".join(STEP_FAULT_LEAF.get(fault, ()))}


def _shard_like(trainer, path):
    """The placements a state leaf at ``path`` must have: its param's,
    a factored slot's by the spec less its dim."""
    from repro_torch.dist.partitioning import PS, Sharding
    kind = path[0]
    if kind == "params":
        return trainer._shardings[path[1:]]
    tree, rest = path[1], path[2:]
    if trainer.model.cfg.optimizer == "adafactor":
        param, slot = rest[:-1], rest[-1]
        s = trainer._shardings[param]
        if slot in trainer._factored:
            spec = list(s.spec)
            del spec[trainer._factored[slot]]
            return Sharding(s.mesh, PS(*spec))
        return s
    del tree
    return trainer._shardings[rest]


def _serve(model, params, batch, cache, steps, tp=None):
    """A prefill of ``batch`` and a decode step a token of ``steps``
    (each ``(B, 1)``): ``[(logits or loss, cache)]``.  The enc-dec has
    no prefill: its first entry is the dry run's (the loss with labels
    = tokens; the caches are drawn); the recurrent families' prefill is
    the prompt through ``decode_fn`` at index 0."""
    cfg = model.cfg
    S = batch["tokens"].shape[1]
    if model.prefill_fn is not None:
        out = [model.prefill_fn(params, batch, cache, tp)]
        start = S + (cfg.n_frontend_tokens if cfg.arch == "vlm" else 0)
    elif cfg.arch == "encdec":
        loss = model.loss_fn(params, {**batch, "labels": batch["tokens"]},
                             tp)
        out, start = [(loss[None], cache)], S
    else:
        out = [model.decode_fn(params, batch, cache, 0, tp)]
        start = S
    for i, t in enumerate(steps):
        out.append(model.decode_fn(params, {"tokens": t}, out[-1][1],
                                   start + i, tp))
    return out


def tp_decode(rank, world, tmp, cell, mesh_name, n_rows=32):
    """``_serve`` of ``n_rows`` x 16 tokens (and the frontend's rows)
    under the tensor-parallel hook on the rank's params, rows and cache
    shards (``launch.dryrun._cache_shardings``) against one process's:
    each rank's logits columns (the enc-dec's loss) and its cache shards
    within 1e-4 of their scale.  At 32 rows the caches split by rows
    and heads; ``_cache_shardings`` splits a KV cache of fewer rows on
    its sequence over the batch axes (the reference's long-context
    rule), and the hook's ``kv_seq`` then attends over each rank's
    positions (``tp_long_decode``: one row, as long_500k).  The
    enc-dec's caches are drawn standard normal (its cross-KV as an
    encoder would have written it)."""
    from chip_smoke import conditioned
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.partitioning import (TensorParallel,
                                               input_shardings,
                                               param_shardings, place)
    from repro_torch.launch.dryrun import (_cache_len, _cache_shardings,
                                           _kv_seq)
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = tp_config(cell)
    model = build_model(cfg)
    mesh = _mesh(TP_MESHES[mesh_name])
    params = conditioned(_draw(model, 0))
    pshard = param_shardings(model.logical_axes(), mesh, fsdp=cfg.fsdp,
                             abstract_tree=model.abstract_params())
    local = tree_map(lambda t, s: place(t, mesh, s.placements).to_local(),
                     params, pshard)
    rng = np.random.default_rng(3)
    B, S = n_rows, 16
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                        ).to(DEVICE),
             **_frontend(rng, cfg, B)}
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).to(DEVICE)
             for _ in range(2)]
    shape = ShapeConfig("decode_small", S + 8, B, "decode")
    T = _cache_len(cfg, shape)
    whole = tree_map(lambda t: t.float(),
                     model.init_caches(B, T, device=DEVICE))
    if cfg.arch == "encdec":
        g = torch.Generator(device="cpu").manual_seed(5)
        whole = tree_map(lambda t: torch.randn(t.shape, generator=g).to(
            DEVICE), whole)
    cshard = _cache_shardings(whole, mesh, cfg, shape)
    tp = TensorParallel(mesh, tree_map(lambda s: s.spec, pshard),
                        _kv_seq(whole, cshard, mesh, shape))
    mine = tree_map(lambda t, s: place(t.clone(), mesh, s.placements
                                       ).to_local(), whole, cshard)
    rows = input_shardings(batch, mesh)

    def my_rows(t, name="tokens"):
        return place(t, mesh, rows[name].placements).to_local()

    mine_batch = {k: my_rows(v, k) for k, v in batch.items()}
    with torch.no_grad():
        if cfg.arch == "encdec":   # the one process's loss of my rows
            out = _serve(model, params, mine_batch, whole, [], None)[:1]
            rest = _serve(model, params, batch, whole, steps)[1:]
            out = out + [(my_rows(lg), c) for lg, c in rest]
        else:
            out = [(my_rows(lg), c)
                   for lg, c in _serve(model, params, batch, whole, steps)]
        out_tp = _serve(model, local, mine_batch, mine,
                        [my_rows(t) for t in steps], tp)
    err, split_cols = 0.0, False
    for (want, cache), (got, cache_tp) in zip(out, out_tp):
        if got.shape[-1] != want.shape[-1]:   # the rank's vocab columns
            split_cols = True
            vl = got.shape[-1]
            want = want[..., tp.model.rank * vl:(tp.model.rank + 1) * vl]
        err = max(err, float((got - want).abs().max())
                  / float(want.abs().max()))
        for a, b, s in zip(leaves(cache), leaves(cache_tp), leaves(cshard)):
            err = max(err, _shard_err(b, a, s))
    return {"rel_err": _max_over_ranks(err), "vocab_split": split_cols,
            "kv_seq": [a.name for a in tp.kv_seq],
            "cache_leaves_split": sum(
                1 for t, s in zip(leaves(whole), leaves(mine))
                if s.numel() < t.numel())}


def tp_long_decode(rank, world, tmp, cell, mesh_name):
    """``tp_decode`` of one row: the KV caches' sequence split over the
    batch axes."""
    return tp_decode(rank, world, tmp, cell, mesh_name, n_rows=1)


def tp_case(rank, world, tmp, cell, mesh_name):
    """``tp_training`` and ``tp_decode`` of one cell in one group."""
    return {**tp_training(rank, world, tmp, cell, mesh_name),
            **tp_decode(rank, world, tmp, cell, mesh_name)}


def tp_one_rank(rank, world, tmp):
    """The tensor-parallel design on a 1x1 mesh (a group of one, every
    collective skipped) against the plain trainer: reduced internlm2
    (AdamW, EF-int8 compression) and kimi-k2 (Adafactor, FSDP, MoE), two
    steps from one seed, bf16 as drawn: losses, gnorms and every state
    leaf bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import activation_constrainer
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths
    mesh = _mesh((1, 1))
    out = {}
    for cell, compress in (("internlm2", True), ("kimi", False)):
        cfg = tp_config(cell)
        model = build_model(cfg)
        rng = np.random.default_rng(4)
        batches = [_batch(rng, cfg, 4, 16) for _ in range(2)]
        runs = []
        for hook in (None, activation_constrainer(mesh, fsdp=cfg.fsdp)):
            tr = Trainer(model, TrainConfig(
                total_steps=2, warmup_steps=0, grad_compress=compress,
                ckpt_dir=str(tmp / f"one_{cell}_{hook is None}")), None,
                constrain=hook, device=DEVICE)
            state = tr.init_state(0)
            ms = [tr.train_step(state, b) for b in batches]
            runs.append((tr, state, [(float(m["loss"]), float(m["gnorm"]))
                                     for m in ms]))
        (_, plain, m1), (tr, sharded, m2) = runs
        assert tr.design == "tensor-parallel"
        assert m1 == m2, (cell, m1, m2)
        whole = {p: t.full_tensor() if isinstance(t, DTensor) else t
                 for p, t in leaf_paths(sharded)}
        for path, a in leaf_paths(plain):
            assert torch.equal(a.detach(), whole[path].detach()), (cell, path)
        out[cell] = {"steps": m1, "leaves": len(whole)}
    return out


def tp_families_one_rank(rank, world, tmp):
    """``tp_one_rank`` for the four other families: reduced internvl2,
    whisper, zamba and xlstm (8 blocks), two steps bf16 as drawn on a
    1x1 mesh against the plain trainer, bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import activation_constrainer
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths
    mesh = _mesh((1, 1))
    out = {}
    for cell in ("internvl2", "whisper", "zamba", "xlstm"):
        cfg = tp_config(cell)
        model = build_model(cfg)
        rng = np.random.default_rng(4)
        batches = [_batch(rng, cfg, 4, 16) for _ in range(2)]
        runs = []
        for hook in (None, activation_constrainer(mesh, fsdp=cfg.fsdp)):
            tr = Trainer(model, TrainConfig(
                total_steps=2, warmup_steps=0,
                ckpt_dir=str(tmp / f"one_{cell}_{hook is None}")), None,
                constrain=hook, device=DEVICE)
            state = tr.init_state(0)
            ms = [tr.train_step(state, b) for b in batches]
            runs.append((tr, state, [(float(m["loss"]), float(m["gnorm"]))
                                     for m in ms]))
        (_, plain, m1), (tr, sharded, m2) = runs
        assert tr.design == "tensor-parallel"
        assert m1 == m2, (cell, m1, m2)
        whole = {p: t.full_tensor() if isinstance(t, DTensor) else t
                 for p, t in leaf_paths(sharded)}
        for path, a in leaf_paths(plain):
            assert torch.equal(a.detach(), whole[path].detach()), (cell, path)
        out[cell] = {"steps": m1, "leaves": len(whole)}
    return out


def tp_xent(rank, world, tmp):
    """``base.vocab_parallel_xent`` over logits split on the vocab of a
    (1, 4) mesh (padded columns masked, labels in every shard, a mask)
    against ``softmax_xent`` of the whole logits: the loss and the
    logits' grad shard."""
    from repro_torch.dist.partitioning import PS, TensorParallel
    from repro_torch.models.base import softmax_xent, vocab_parallel_xent
    mesh = _mesh((1, 4))
    tp = TensorParallel(mesh, {"x": PS(None, "model")})
    rng = np.random.default_rng(2)
    V, vl = 256, 64
    logits = torch.from_numpy(rng.standard_normal((3, 5, V)).astype(
        np.float32) * 4).to(DEVICE)
    logits[..., 250:] = -1e30   # padded columns, as logits_fn masks them
    labels = torch.from_numpy(rng.integers(0, 250, (3, 5))).to(DEVICE)
    mask = torch.from_numpy((rng.random((3, 5)) > 0.3).astype(
        np.float32)).to(DEVICE)
    whole = logits.clone().requires_grad_(True)
    want = softmax_xent(whole, labels, mask)
    (gw,) = torch.autograd.grad(want, whole)
    j = tp.model.rank
    part = logits[..., j * vl:(j + 1) * vl].clone().requires_grad_(True)
    got = vocab_parallel_xent(part, labels, mask, tp, j * vl)
    (gp,) = torch.autograd.grad(got, part)
    loss_err = abs(float(got) - float(want)) / abs(float(want))
    grad_err = float((gp - gw[..., j * vl:(j + 1) * vl]).abs().max()) / \
        float(gw.abs().max())
    return {"loss_rel_err": _max_over_ranks(loss_err),
            "grad_max_rel_err": _max_over_ranks(grad_err),
            "labels_per_shard": [int(((labels >= k * vl)
                                      & (labels < (k + 1) * vl)).sum())
                                 for k in range(4)]}


DRYRUN_CELLS = {"dense": ("internlm2-1.8b", {"fsdp": True}),
                "ep": ("granite-moe-1b-a400m", {"moe_impl": "ep"})}


def dryrun_counts(mesh, device, cell):
    """``launch.dryrun``'s count of one train step of a reduced config
    as this rank of ``mesh`` (4 x 16 tokens), on ``device`` (``meta``,
    or a drawn state), under ``CommDebugMode`` too: what both sides of
    ``test_torch_dryrun``'s collective check compare."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    arch, kw = DRYRUN_CELLS[cell]
    model = build_model(_reduced(arch, remat="full", **kw))
    shape = ShapeConfig("train_small", 16, 4, "train")
    step, args = dryrun.build_step(model, shape, mesh, device=device)
    with CommDebugMode() as comm:
        out = dryrun.count_step(step, args)
    return {"comm_counts": {str(k): v for k, v in
                            comm.get_comm_counts().items()},
            **{k: out[k] for k in ("collectives", "collective_ops",
                                   "collective_bytes_per_device",
                                   "flops_per_device", "bytes_per_device",
                                   "argument_size_in_bytes")}}


def dryrun_dense(rank, world, tmp):
    return dryrun_counts(_mesh((2, 2)), DEVICE, "dense")


def dryrun_ep(rank, world, tmp):
    return dryrun_counts(_mesh((2, 2)), DEVICE, "ep")


RANKS = {"moe_ep": moe_ep, "sharded_training": sharded_training,
         "elastic_one": elastic_one, "moe_ep_training": moe_ep_training,
         "dryrun_dense": dryrun_dense, "dryrun_ep": dryrun_ep,
         "tp_xent": tp_xent, "tp_one_rank": tp_one_rank,
         "tp_families_one_rank": tp_families_one_rank}
for _fault in ("none", *STEP_FAULT_LEAF):
    RANKS[f"tp_step_fault:{_fault}"] = functools.partial(tp_step_fault,
                                                         fault=_fault)
for _cell in (*TP_CELLS, *TP_FAMILY_CELLS, *TP_FULL_CELLS):
    for _mesh_name in TP_MESHES:
        for _name, _fn in (("tp_training", tp_training),
                           ("tp_decode", tp_decode), ("tp_case", tp_case),
                           ("tp_long_decode", tp_long_decode)):
            RANKS[f"{_name}:{_cell}:{_mesh_name}"] = functools.partial(
                _fn, cell=_cell, mesh_name=_mesh_name)


if __name__ == "__main__":   # python tests/torch_dist_ranks.py NAME WORLD TMP
    launch(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    os._exit(0)
