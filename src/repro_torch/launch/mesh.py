"""Production mesh construction: the counterpart of
``repro.launch.mesh`` over ``torch.distributed``.

Functions (not module-level constants), so importing this module never
touches device or process-group state.  Shapes as in the reference:
  single pod : (16, 16)      axes ("data", "model")   — 256 ranks
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model") — 512 ranks

Each rank is one process and one device: the caller initialises the
default process group (``torch.distributed.init_process_group`` with
its address, world size and rank) before building a mesh.  The mesh's
device type is ``cuda`` unless the caller asks for ``"cpu"``.  A group
with fewer ranks than the shape needs raises ``ValueError``, as
``jax.make_mesh`` does with fewer devices.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_production_mesh", "make_mesh_for"]


def _make_mesh(shape, axes, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda" if device is None else device)
    need = math.prod(shape)
    # a process outside any group is one rank
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(
            f"Number of devices {world} must be >= the product of "
            f"mesh_shape {need} (mesh {shape}, axes {axes})")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialised default process group "
            "(torch.distributed.init_process_group)")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_mesh_for(n_devices: int, model_parallel: int = 1, *, device=None):
    """Elastic helper: best (data, model) mesh for whatever is alive.

    Used by the elastic-restart path (``train.elastic``) when a job
    comes back with fewer healthy ranks.
    """
    model_parallel = max(1, min(model_parallel, n_devices))
    while n_devices % model_parallel:
        model_parallel -= 1
    return _make_mesh((n_devices // model_parallel, model_parallel),
                      ("data", "model"), device)
