"""Fault-tolerant training loop: the counterpart of
``repro.train.train_loop``.

Composition per step:
  data (seekable learned-index pipeline) -> loss + grads (autograd)
  -> [optional EF-int8 grad compression] -> optimizer (in place)
  -> metrics -> watchdog disarm -> periodic async atomic checkpoint.

The step keeps the reference's semantics (``train_loop.py:68-155``):
the lr is taken at the optimizer's step count *before* the update; the
compression runs before the optimizer and its residual advances even
on a bad step; a step whose loss is not finite is a **bad step**: the
params and every >= 1-d optimizer leaf keep their values, the 0-d
leaves (the step count) advance (the reference's ``jnp.where(bad, o,
n) if n.ndim else n``; no config has a 0-d param).  After the loss and
grads, the compression and the optimizer run a leaf at a time, each on
that leaf's grad and state, with the global norm of all the grads
(``gnorm=``): the arithmetic of one call on the whole trees, leaf for
leaf.  The optimizers update in place, so a bad step is recognised on
the host (the loss is read back once a step) and runs the optimizer on
no leaf: only its counters advance.  Which trees of an optimizer's
state mirror the params is the optimizer's declaration
(``optim.PARAM_SLOTS``).

Restart semantics: ``Trainer.run`` restores the latest checkpoint (if
any) against ``init_state``'s template, seeks the loader to the
restored step, and continues — a crash at any point loses at most
``ckpt_every`` steps and zero data order.  A crash that leaves ``run``
as an exception first lets the write in flight publish.  The
checkpoints are the reference trainer's files (``train.checkpoint``),
so either package resumes the other's.

Sharded training.  ``constrain`` is the reference's hook
(``dist.partitioning.activation_constrainer``); when it carries a
``torch.distributed`` mesh (``constrain.mesh``, covering the whole
default process group, one process a rank), the trainer keeps its state
sharded over that mesh, and runs one of two designs (``design``):

* ``init_state`` draws the whole params on every rank (one generator
  seed, so every rank draws the same numbers) and keeps each rank's
  shard (``shard_state``): the params by ``param_shardings(
  model.logical_axes(), mesh, fsdp=cfg.fsdp, abstract_tree=
  model.abstract_params())``, the optimizer's param-shaped slots and the
  compression residual as their param, a factored slot
  (``optim.FACTORED_SLOTS``: Adafactor's ``vr`` / ``vc``) by its param's
  spec less the dim it drops, as the reference's dry run places them;
  the step count is whole on every rank.
* **"tensor-parallel"** (a model with ``tensor_parallel``: every
  family, each on its own shards as its module doc says): the model
  runs on each rank's shards under a
  ``dist.partitioning.TensorParallel`` hook, as GSPMD runs the
  reference's step.  No param is gathered whole: "model"-sharded leaves
  stay sharded, FSDP leaves are gathered over "data" a layer at a time
  inside the forward and their grads reduce-scattered back.  Each rank's
  grads are then whole over "model" (the hook's ``copy`` / ``reduce``
  pair) and summed over the batch axes ("pod", "data") a leaf is not
  split over (the reduce-scatter has summed the rest).  The compression
  and the optimizer run leaf by leaf on the local shards, in place; a
  per-tensor max (EF-int8's scale) and Adafactor's row and column means
  are reduced over the ranks the leaf (or the averaged dim) is split
  over, and the global norm sums each leaf's squares once: over the
  axes it is split over, and not over those it is replicated on.
* **"gather-at-use"** (a model whose ``tensor_parallel`` the caller
  has turned off, the FLOP-ratio tests' baseline): a step gathers the
  params whole (``full_tensor``: ZeRO-3's gather at use) for the loss
  and grads; the leaf-at-a-time compression and optimizer run on that
  leaf's state gathered whole, and each rank keeps its shard of what
  they write.  The grads and the loss are summed over the whole group.
* The loader gives each rank its rows of the batch (``ShardedLoader(
  shard_id=, n_shards=)`` by ``partitioning.batch_shard``); ranks that
  differ only on "model" hold the same rows.
* The loss that a rank differentiates is its share of the global mean:
  its mean times its token count (the mask's sum) over the count summed
  over the ranks the loss is summed over.  Summed, these shares are the
  mean over every token once (under gather-at-use a batch held by r
  ranks counts r times in the sum of counts, and each holder takes 1/r
  of it; under tensor parallelism the counts and the loss are summed
  over the batch axes only).  So every rank holds the one-process loss
  and grads of the whole batch (its shard of them); the global norm,
  the clip and the NaN guard read those and agree on every rank.  A
  collective inside the model (the expert-parallel MoE) is
  differentiable and adjoint, so the same sum is right through it.
* An MoE layer's capacity counts the tokens it is given, here a rank's
  rows, so each rank drops by its own rows (as the reference's
  ``moe_ep_shardmap`` drops by each device's tokens, where its GSPMD
  dispatch counts the whole batch); where no token is dropped the
  result is one process's.
* ``run`` resumes every rank from one step: global rank 0's newest
  checkpoint, broadcast.  ``ckpt_dir`` must lie on a filesystem every
  rank reads (rank 0 alone writes it).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dist.partitioning import (PS, Sharding, TensorParallel, local_shard,
                                 param_shardings, place)
from ..models.api import Model
from ..optim import FACTORED_SLOTS, OPTIMIZERS, PARAM_SLOTS
from ..optim.compress import ef_compress_update, residual_init
from ..optim.schedules import cosine_schedule, wsd_schedule
from ..tree import leaf_paths, leaves, tree_map, unflatten
from .checkpoint import CheckpointManager
from .fault import FailureInjector, StepWatchdog

__all__ = ["TrainConfig", "Trainer"]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _gathered(leaf):
    """A state leaf whole (a DTensor is gathered: a collective)."""
    return leaf.detach().full_tensor() if _is_dtensor(leaf) else leaf


def _reshard(whole, like):
    """``whole`` as this rank's shard of ``like``'s placements when
    ``like`` is a DTensor, else as it is."""
    if not _is_dtensor(like):
        return whole
    return place(whole.detach(), like.device_mesh, like.placements)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    _at(tree, path[:-1])[path[-1]] = value


def _default_ckpt_dir() -> str:
    # the reference's "/tmp/repro_ckpt", under the process's TMPDIR
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "cosine"           # cosine | wsd
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep_ckpts: int = 3
    watchdog_timeout_s: float = 300.0
    grad_compress: bool = False        # EF-int8 on the DP gradient path
    log_every: int = 10


class Trainer:
    """``run`` trains ``model`` on ``loader``'s batches on ``device``
    (cuda unless ``"cpu"``); ``train_step`` is one step on a state."""

    def __init__(self, model: Model, train_cfg: TrainConfig, loader,
                 constrain=None,
                 failure_injector: Optional[FailureInjector] = None,
                 device=None):
        if train_cfg.schedule not in ("cosine", "wsd"):
            raise ValueError(f"unknown schedule {train_cfg.schedule!r}")
        self.model = model
        self.cfg = train_cfg
        self.loader = loader
        self.constrain = constrain
        self.device = resolve_device(device)
        self.mesh = getattr(constrain, "mesh", None)
        self._shardings = None
        self.tp = None
        self.design = None
        if self.mesh is not None:
            import torch.distributed as dist
            if self.mesh.size() != dist.get_world_size():
                raise ValueError(
                    f"the mesh holds {self.mesh.size()} ranks, the process "
                    f"group {dist.get_world_size()}")
            # a meta trainer (the dry run's count) runs over any mesh
            if self.device.type not in (self.mesh.device_type, "meta"):
                raise ValueError(f"a {self.mesh.device_type} mesh for a "
                                 f"trainer on {self.device}")
            shardings = param_shardings(
                model.logical_axes(), self.mesh, fsdp=model.cfg.fsdp,
                abstract_tree=model.abstract_params())
            self._shardings = dict(leaf_paths(shardings))
            if model.tensor_parallel:
                self.tp = TensorParallel(self.mesh, tree_map(
                    lambda s: s.spec, shardings))
            self.design = ("tensor-parallel" if self.tp is not None
                           else "gather-at-use")
        self.injector = failure_injector or FailureInjector()
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir,
                                      keep=train_cfg.keep_ckpts)
        self.watchdog = StepWatchdog(train_cfg.watchdog_timeout_s)
        self.metrics: List[Dict] = []
        self._opt_init, self._opt_update = OPTIMIZERS[model.cfg.optimizer]
        self._slots = PARAM_SLOTS[model.cfg.optimizer]
        self._factored = FACTORED_SLOTS[model.cfg.optimizer]

    # ------------------------------------------------------------------
    def lr_at(self, step):
        c = self.cfg
        if c.schedule == "wsd":
            return wsd_schedule(
                step, peak_lr=c.peak_lr, warmup_steps=c.warmup_steps,
                stable_steps=int(0.8 * c.total_steps),
                decay_steps=max(1, int(0.1 * c.total_steps)))
        return cosine_schedule(step, peak_lr=c.peak_lr,
                               warmup_steps=c.warmup_steps,
                               total_steps=c.total_steps)

    def init_state(self, seed: int = 0):
        """Random params drawn from a ``torch.Generator`` on the device
        (not JAX's numbers: parity tests carry a reference state
        across), the optimizer's state and the compression residual
        (0-d zeros without compression, as in the reference)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init_params(gen, self.device)
        opt_state = self._opt_init(params)
        residual = (residual_init(params) if self.cfg.grad_compress
                    else tree_map(lambda p: torch.zeros(
                        (), dtype=torch.float32, device=p.device), params))
        state = {"params": params, "opt": opt_state, "residual": residual}
        return state if self.mesh is None else self.shard_state(state)

    def shard_state(self, state):
        """Each rank's shard of a whole state (see the module doc)."""
        paths = [path for path, _ in leaf_paths(state["params"])]

        def shard(path, leaf, drop=None):
            s = self._shardings[path]
            if drop is not None:   # a factored slot: the spec less a dim
                spec = list(s.spec)
                del spec[drop]
                s = Sharding(s.mesh, PS(*spec))
            return place(leaf, s.mesh, s.placements)

        def mirror(tree, keys):
            # a tree that mirrors the params, its param-shaped slots
            # (``keys`` of each param's entry; None: the entry) and its
            # factored slots sharded
            def entry(path, e):
                if keys is None:
                    return shard(path, e)
                return {n: shard(path, v) if n in keys else
                        shard(path, v, self._factored[n])
                        if n in self._factored else v
                        for n, v in e.items()}
            return unflatten(state["params"],
                             [entry(p, _at(tree, p)) for p in paths])

        opt = dict(state["opt"])
        for k, keys in self._slots.items():
            opt[k] = mirror(opt[k], keys)
        residual = state["residual"]
        if self.cfg.grad_compress:   # else 0-d placeholders
            residual = mirror(residual, None)
        return {"params": mirror(state["params"], None), "opt": opt,
                "residual": residual}

    def device_batch(self, batch: Dict[str, np.ndarray]):
        """A loader batch on the device; integer ids as int64."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(self.device)
        return out

    def loss_and_grads(self, params, batch):
        """``(loss, grads)``: the model's loss and its gradient with
        respect to every param leaf (a tree like ``params``).  Under the
        tensor-parallel design ``params`` are this rank's shards, and so
        are the grads."""
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = self.model.loss_fn(params, batch, self.tp or self.constrain)
        if self.mesh is not None:
            loss = loss * self._token_share(batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a param the loss does not reach has a zero grad, as in JAX
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(flat, grads)]
        loss = loss.detach()
        if self.mesh is not None:
            import torch.distributed as dist
            if self.tp is None:
                for t in grads + [loss]:
                    dist.all_reduce(t)
            else:
                for g, (path, _) in zip(grads, leaf_paths(params)):
                    split = self._split_axes(path)
                    for a in self.tp.batch:
                        if a not in split:
                            dist.all_reduce(g, group=a.group)
                for a in self.tp.batch:
                    dist.all_reduce(loss, group=a.group)
        return loss, unflatten(params, grads)

    def _token_share(self, batch):
        """This rank's share of the global mean loss: its token count
        over the count summed over the ranks the loss is summed over
        (see the module doc)."""
        import torch.distributed as dist
        mask = batch.get("mask")
        count = (torch.clamp(torch.sum(mask.float()), min=1.0)
                 if mask is not None else
                 torch.tensor(float(batch["labels"].numel()),
                              device=batch["labels"].device))
        total = count.clone()
        if self.tp is None:
            dist.all_reduce(total)
        else:
            for a in self.tp.batch:
                dist.all_reduce(total, group=a.group)
        return count / total

    # -- the tensor-parallel design's reductions, a leaf at a time --------
    def _split_axes(self, path, dim=None):
        """The axes of more than one rank that leaf ``path``'s spec
        splits (dim ``dim``, or any dim)."""
        spec = self._shardings[path].spec
        dims = range(len(spec)) if dim is None else (dim,)
        return tuple(a for d in dims for a in self.tp.split_axes(spec, d))

    def _global_norm(self, paths, flat_g):
        """``global_norm`` of the whole grads from this rank's shards:
        each leaf's sum of squares summed over the axes the leaf is
        split over, then added up as ``global_norm`` adds them."""
        sq = [torch.sum(torch.square(g.float())) for g in flat_g]
        if self.tp is not None:
            import torch.distributed as dist
            by_axes = {}
            for i, path in enumerate(paths):
                axes = self._split_axes(path)
                if axes:
                    by_axes.setdefault(axes, []).append(i)
            for axes, idx in by_axes.items():
                t = torch.stack([sq[i] for i in idx])
                for a in axes:
                    dist.all_reduce(t, group=a.group)
                for i, v in zip(idx, t):
                    sq[i] = v
        return torch.sqrt(sum(sq))

    def _leaf_max(self, path):
        """EF-int8's per-tensor max of a leaf's shards, over its ranks
        (None: the local max is the leaf's)."""
        axes = () if self.tp is None else self._split_axes(path)
        if not axes:
            return None
        import torch.distributed as dist

        def amax(m):
            m = m.clone()
            for a in axes:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=a.group)
            return m
        return amax

    def _leaf_mean(self, path):
        """Adafactor's ``mean`` hook for a leaf: the mean over a dim,
        averaged over the ranks the param's dim is split over."""
        if self.tp is None:
            return None
        import torch.distributed as dist
        spec = self._shardings[path].spec

        def mean(t, dim, pdim, keepdim=False):
            m = torch.mean(t, dim=dim, keepdim=keepdim)
            axes = self.tp.split_axes(spec, pdim % len(spec))
            for a in axes:
                dist.all_reduce(m, group=a.group)
            n = 1
            for a in axes:
                n *= a.size
            return m / n if n > 1 else m
        return mean

    def train_step(self, state, batch) -> Dict[str, Any]:
        """One step on ``state`` (updated in place); returns the step's
        metrics as tensors.  The loss and grads are taken on the params
        (this rank's shards under the tensor-parallel design, gathered
        whole under gather-at-use); the compression and the optimizer
        then run a leaf at a time on that leaf's state (the local shards
        in place, or gathered whole with each rank keeping its shard of
        what they write) with the global norm of all the grads (see the
        module doc)."""
        tp = self.tp is not None
        view = local_shard if tp else _gathered
        paths = [path for path, _ in leaf_paths(state["params"])]
        params = (tree_map(lambda t: local_shard(t).detach(), state["params"])
                  if tp else tree_map(_gathered, state["params"]))
        loss, grads = self.loss_and_grads(params, batch)
        flat_g = leaves(grads)
        del grads
        if self.cfg.grad_compress:
            res = leaves(state["residual"])
            for i, e in enumerate(res):
                g, e_new = ef_compress_update({"x": flat_g[i]},
                                              {"x": view(e)},
                                              self._leaf_max(paths[i]))
                flat_g[i] = g["x"]
                if tp:
                    local_shard(e).copy_(e_new["x"])
                else:
                    res[i] = _reshard(e_new["x"], e)
            state["residual"] = unflatten(state["residual"], res)
        gnorm = self._global_norm(paths, flat_g)
        opt = state["opt"]
        lr = self.lr_at(opt["step"])
        finite = torch.isfinite(loss)
        # a meta loss (the dry run's count) has no value: finite
        bad = not finite.is_meta and not bool(finite)
        if bad:  # the NaN guard: no leaf moves; the counters advance
            _, new, _ = self._opt_update(
                {}, {k: {} if k in self._slots else v
                     for k, v in opt.items()}, {}, lr=lr, gnorm=gnorm)
        else:
            new_params = []
            for path, p, g, old in zip(paths, leaves(params), flat_g,
                                       leaves(state["params"])):
                own = {k: _at(opt[k], path) for k in self._slots}
                one = {k: {"x": tree_map(view, own[k])}
                       if k in own else v for k, v in opt.items()}
                hooks = ({"mean": self._leaf_mean(path)} if self._factored
                         else {})
                _, new, _ = self._opt_update({"x": g}, one, {"x": p}, lr=lr,
                                             gnorm=gnorm, **hooks)
                if not tp:   # the local shards were updated in place
                    new_params.append(_reshard(p, old))
                    for k in own:
                        _put(opt[k], path,
                             tree_map(_reshard, new[k]["x"], own[k]))
            if not tp:
                state["params"] = unflatten(state["params"], new_params)
        for k, v in new.items():
            if k not in self._slots:
                opt[k] = v
        return {"loss": loss, "gnorm": gnorm, "lr": lr,
                "bad_step": torch.tensor(float(bad))}

    def _resume_step(self) -> Optional[int]:
        """The newest checkpoint's step, None when there is none.  Under
        a mesh every rank takes global rank 0's, which waits for its
        own write in flight before it lists the directory; the
        broadcast orders every rank's restore after that."""
        self.ckpt.wait()
        step = self.ckpt.latest_step()
        if self.mesh is None:
            return step
        import torch.distributed as dist
        t = torch.tensor(-1 if step is None else step, device=self.device)
        dist.broadcast(t, src=0)
        return None if int(t) < 0 else int(t)

    # ------------------------------------------------------------------
    def run(self, seed: int = 0, resume: bool = True) -> Dict[str, Any]:
        state = None
        start_step = 0
        latest = self._resume_step() if resume else None
        if latest is not None:
            template = self.init_state(seed)
            state, extra = self.ckpt.restore(step=latest, template=template)
            del template
            start_step = int(extra.get("step", 0))
            self.loader.seek(start_step)
            print(f"[train] resumed from step {start_step}")
        if state is None:
            state = self.init_state(seed)

        step = start_step
        t_start = time.time()
        try:
            while step < self.cfg.total_steps:
                self.watchdog.arm(step)
                self.injector.maybe_fail(step)
                batch = self.device_batch(self.loader.next_batch())
                m = self.train_step(state, batch)
                self.watchdog.cancel()
                step += 1
                if (step % self.cfg.log_every == 0
                        or step == self.cfg.total_steps):
                    m = {k: float(v) for k, v in m.items()}
                    m.update(step=step,
                             stragglers=len(self.watchdog.events),
                             elapsed_s=round(time.time() - t_start, 2))
                    self.metrics.append(m)
                    print(f"[train] step={step} loss={m['loss']:.4f} "
                          f"lr={m['lr']:.2e} gnorm={m['gnorm']:.3f}")
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save_async(step, state, extra={
                        "step": step, "loader_step": self.loader.step})
        finally:
            # a crash too lets the write in flight publish: a restart
            # in this process then finds it
            self.ckpt.wait()
        self.ckpt.save(step, state, extra={"step": step,
                                           "loader_step": self.loader.step})
        return {"state": state, "metrics": self.metrics,
                "straggler_events": self.watchdog.events}
