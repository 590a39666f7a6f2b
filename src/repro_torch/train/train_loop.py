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
n) if n.ndim else n``).  The optimizers update in place, so a bad step
is recognised on the host (the loss is read back once a step) and its
>= 1-d leaves are restored from a copy taken before the update.

Restart semantics: ``Trainer.run`` restores the latest checkpoint (if
any) against ``init_state``'s template, seeks the loader to the
restored step, and continues — a crash at any point loses at most
``ckpt_every`` steps and zero data order.  The checkpoints are the
reference trainer's files (``train.checkpoint``), so either package
resumes the other's.
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
from ..models.api import Model
from ..optim import OPTIMIZERS
from ..optim.compress import ef_compress_update, residual_init
from ..optim.schedules import cosine_schedule, wsd_schedule
from ..tree import leaves, tree_map, unflatten
from .checkpoint import CheckpointManager
from .fault import FailureInjector, StepWatchdog

__all__ = ["TrainConfig", "Trainer"]


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
        self.injector = failure_injector or FailureInjector()
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir,
                                      keep=train_cfg.keep_ckpts)
        self.watchdog = StepWatchdog(train_cfg.watchdog_timeout_s)
        self.metrics: List[Dict] = []
        self._opt_init, self._opt_update = OPTIMIZERS[model.cfg.optimizer]

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
        return {"params": params, "opt": opt_state, "residual": residual}

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
        respect to every param leaf (a tree like ``params``)."""
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss = self.model.loss_fn(params, batch, self.constrain)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a param the loss does not reach has a zero grad, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(params, grads)

    def train_step(self, state, batch) -> Dict[str, Any]:
        """One step on ``state`` (updated in place); returns the step's
        metrics as tensors."""
        loss, grads = self.loss_and_grads(state["params"], batch)
        residual = state["residual"]
        if self.cfg.grad_compress:
            grads, residual = ef_compress_update(grads, residual)
        lr = self.lr_at(state["opt"]["step"])
        bad = not bool(torch.isfinite(loss))
        if bad:  # the NaN guard (see the module doc)
            held = [t for t in leaves(state["params"])
                    + leaves(state["opt"]) if t.ndim]
            kept = [t.detach().clone() for t in held]
        params, opt, gnorm = self._opt_update(grads, state["opt"],
                                              state["params"], lr=lr)
        del grads
        if bad:
            with torch.no_grad():
                for t, old in zip(held, kept):
                    t.copy_(old)
        state.update(params=params, opt=opt, residual=residual)
        return {"loss": loss, "gnorm": gnorm, "lr": lr,
                "bad_step": torch.tensor(float(bad))}

    # ------------------------------------------------------------------
    def run(self, seed: int = 0, resume: bool = True) -> Dict[str, Any]:
        state = None
        start_step = 0
        if resume and self.ckpt.latest_step() is not None:
            template = self.init_state(seed)
            state, extra = self.ckpt.restore(template=template)
            del template
            start_step = int(extra.get("step", 0))
            self.loader.seek(start_step)
            print(f"[train] resumed from step {start_step}")
        if state is None:
            state = self.init_state(seed)

        step = start_step
        t_start = time.time()
        while step < self.cfg.total_steps:
            self.watchdog.arm(step)
            self.injector.maybe_fail(step)
            batch = self.device_batch(self.loader.next_batch())
            m = self.train_step(state, batch)
            self.watchdog.cancel()
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                m = {k: float(v) for k, v in m.items()}
                m.update(step=step,
                         stragglers=len(self.watchdog.events),
                         elapsed_s=round(time.time() - t_start, 2))
                self.metrics.append(m)
                print(f"[train] step={step} loss={m['loss']:.4f} "
                      f"lr={m['lr']:.2e} gnorm={m['gnorm']:.3f}")
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step, state,
                                     extra={"step": step,
                                            "loader_step": self.loader.step})
        self.ckpt.wait()
        self.ckpt.save(step, state, extra={"step": step,
                                           "loader_step": self.loader.step})
        return {"state": state, "metrics": self.metrics,
                "straggler_events": self.watchdog.events}
