"""Unified model API: one object per architecture family.

The counterpart of ``repro.models.api``.  ``build_model(cfg)`` returns
a :class:`Model` exposing:

  param_specs / abstract_params / logical_axes / init_params(generator,
  device)
  param_count / active_param_count
  loss_fn(params, batch, constrain)           -> scalar (autograd backward)
  prefill_fn(params, batch, cache, constrain) -> (logits, cache)   [if any]
  decode_fn(params, batch, cache, idx, constrain) -> (logits, cache)
  cache_specs(batch, max_len) / init_caches(batch, max_len, device)
                                              -> the reference's layouts
  input_specs(shape)  -> the batch's shapes and dtypes, no allocation
  input_sample(shape, generator, device)      -> a real batch
  tensor_parallel     -> the forward takes a rank's shards under
                         ``dist.partitioning.TensorParallel``

for the ``lm``, ``vlm``, ``encdec``, ``zamba`` (Mamba-2 + shared
attention) and ``xlstm`` families.  The reference's ``ShapeDtypeStruct``
stand-ins (``abstract_params``, ``cache_specs``, ``input_specs``) are
``meta`` tensors here; ``logical_axes`` feeds
``dist.partitioning.param_shardings``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import base as _base
from . import encdec as _encdec
from . import lm as _lm
from . import vlm as _vlm
from . import xlstm_lm as _xlstm
from . import zamba as _zamba


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    _specs: Any
    loss_fn: Callable
    decode_fn: Optional[Callable] = None
    prefill_fn: Optional[Callable] = None
    cache_specs: Optional[Callable] = None
    init_caches: Optional[Callable] = None
    # the forward computes on each rank's shards under a
    # ``dist.partitioning.TensorParallel`` hook (every family; off, a
    # trainer or the dry run gathers the params whole at use instead)
    tensor_parallel: bool = True

    def param_specs(self):
        return self._specs

    def abstract_params(self):
        return _base.abstract_params(self._specs)

    def logical_axes(self):
        return _base.logical_axes(self._specs)

    def _leaves(self):
        out = []
        _base.map_specs(lambda path, p: out.append((path, p)), self._specs)
        return out

    def init_params(self, generator: torch.Generator, device=None):
        """Random params (``base.init_params``) on ``device`` (cuda
        unless ``"cpu"``), drawn from ``generator`` on its device."""
        return _base.init_params(self._specs, generator,
                                 resolve_device(device))

    def param_count(self) -> int:
        return sum(int(np.prod(p.shape)) for _, p in self._leaves())

    def active_param_count(self) -> int:
        """6*N*D accounting for MoE: routed-expert share scaled by top_k/E."""
        total = 0
        for path, p in self._leaves():
            n = int(np.prod(p.shape))
            if (self.cfg.moe and "moe" in path
                    and path[-1] in ("w_gate", "w_up", "w_down")):
                n = n * self.cfg.moe.top_k // self.cfg.moe.n_experts
            total += n
        return total

    # ------------------------------------------------------------------
    def _input_shapes(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Name -> (shape, dtype) of a batch of ``shape`` (the
        reference's ``input_specs`` without JAX)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": ((B, 1), torch.int32)}
        if shape.kind not in ("train", "prefill"):
            raise KeyError(shape.kind)
        batch = {"tokens": ((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = ((B, S), torch.int32)
        if cfg.arch == "encdec":
            batch["frames"] = ((B, cfg.n_frontend_tokens, cfg.d_model),
                               torch.bfloat16)
        if cfg.arch == "vlm":
            batch["patches"] = ((B, cfg.n_frontend_tokens, cfg.d_frontend),
                                torch.bfloat16)
        return batch

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Dry-run stand-ins: ``meta`` tensors of the batch's shapes and
        dtypes (no allocation)."""
        return {name: torch.empty(shp, dtype=dtype, device="meta")
                for name, (shp, dtype) in self._input_shapes(shape).items()}

    def input_sample(self, shape: ShapeConfig, generator: torch.Generator,
                     device=None) -> Dict[str, Any]:
        """A real batch: token ids uniform below ``vocab``, embeddings
        standard normal, drawn from ``generator`` on its device."""
        dev = resolve_device(device)
        gdev = generator.device
        out = {}
        for name, (shp, dtype) in self._input_shapes(shape).items():
            if dtype == torch.int32:
                t = torch.randint(0, self.cfg.vocab, shp, generator=generator,
                                  device=gdev, dtype=torch.int64)
            else:
                t = torch.randn(shp, generator=generator, device=gdev,
                                dtype=torch.float32)
            out[name] = t.to(device=dev, dtype=dtype)
        return out


def _encdec_caches(cfg, batch, max_len, device=None):
    """The reference's enc-dec layout: stacked self-KV ``(L, B, KV, T,
    Dh)`` and a zero cross-KV ``(L, B, KV, F, Dh)``, bf16."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.head_dim_)
    cross = (cfg.n_layers, batch, cfg.n_kv, cfg.n_frontend_tokens,
             cfg.head_dim_)
    z = lambda s: torch.zeros(s, dtype=torch.bfloat16, device=dev)  # noqa: E731
    return {"k": z(shape), "v": z(shape), "ck": z(cross), "cv": z(cross)}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch == "lm":
        return Model(
            cfg=cfg,
            _specs=_lm.param_specs(cfg),
            loss_fn=lambda p, b, c=None: _lm.loss_fn(p, b, cfg, c),
            prefill_fn=lambda p, b, cache, c=None: _lm.prefill(
                p, b["tokens"], cache, cfg, c),
            decode_fn=lambda p, b, cache, idx, c=None: _lm.decode_step(
                p, b["tokens"], cache, idx, cfg, c),
            cache_specs=lambda batch, max_len: _lm.kv_cache_specs(
                cfg, batch, max_len),
            init_caches=lambda batch, max_len, device=None: _lm.init_kv_cache(
                cfg, batch, max_len, device=device),
        )
    if cfg.arch == "vlm":
        return Model(
            cfg=cfg,
            _specs=_vlm.param_specs(cfg),
            loss_fn=lambda p, b, c=None: _vlm.loss_fn(p, b, cfg, c),
            prefill_fn=lambda p, b, cache, c=None: _vlm.prefill(
                p, b, cache, cfg, c),
            decode_fn=lambda p, b, cache, idx, c=None: _vlm.decode_step(
                p, b["tokens"], cache, idx, cfg, c),
            cache_specs=lambda batch, max_len: _vlm.kv_cache_specs(
                cfg, batch, max_len),
            init_caches=lambda batch, max_len, device=None:
                _vlm.init_kv_cache(cfg, batch, max_len, device=device),
        )
    if cfg.arch == "encdec":
        return Model(
            cfg=cfg,
            _specs=_encdec.param_specs(cfg),
            loss_fn=lambda p, b, c=None: _encdec.loss_fn(p, b, cfg, c),
            decode_fn=lambda p, b, cache, idx, c=None: _encdec.decode_step(
                p, b["tokens"], cache, idx, cfg, c),
            cache_specs=lambda batch, max_len: _encdec_caches(
                cfg, batch, max_len, "meta"),
            init_caches=lambda batch, max_len, device=None: _encdec_caches(
                cfg, batch, max_len, device),
        )
    if cfg.arch == "zamba":
        return Model(
            cfg=cfg,
            _specs=_zamba.param_specs(cfg),
            loss_fn=lambda p, b, c=None: _zamba.loss_fn(p, b, cfg, c),
            decode_fn=lambda p, b, cache, idx, c=None: _zamba.decode_step(
                p, b["tokens"], cache, idx, cfg, c),
            cache_specs=lambda batch, max_len: _zamba.cache_specs(
                cfg, batch, max_len),
            init_caches=lambda batch, max_len, device=None:
                _zamba.init_caches(cfg, batch, max_len, device=device),
        )
    if cfg.arch == "xlstm":
        return Model(
            cfg=cfg,
            _specs=_xlstm.param_specs(cfg),
            loss_fn=lambda p, b, c=None: _xlstm.loss_fn(p, b, cfg, c),
            decode_fn=lambda p, b, cache, idx, c=None: _xlstm.decode_step(
                p, b["tokens"], cache, idx, cfg, c),
            cache_specs=lambda batch, max_len: _xlstm.cache_specs(
                cfg, batch),
            init_caches=lambda batch, max_len, device=None:
                _xlstm.init_caches(cfg, batch, device=device),
        )
    raise KeyError(cfg.arch)
