"""Elastic re-meshing: resume a checkpoint on a different rank count.

The counterpart of ``repro.train.elastic``.  At scale, a failed node
returns with fewer healthy ranks; training must continue on the
survivors.  Because checkpoints are host-format arrays and shardings
are derived (not stored), elasticity is just:

    mesh' = make_mesh_for(world_size, model_parallel)
    shardings' = param_shardings(logical_axes, mesh', fsdp)
    state = ckpt.restore(template=...), params placed by shardings'

Every rank reads the whole leaves and keeps its own shard of the params
(``dist.partitioning.place``); the rest of the state is restored as the
template holds it.  The caller initialises the process group first
(one process a rank) and owns the batch policy.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..dist import param_shardings
from ..dist.partitioning import place
from ..launch.mesh import make_mesh_for
from ..tree import tree_map
from .checkpoint import CheckpointManager

__all__ = ["elastic_restore"]


def elastic_restore(model, ckpt_dir: str, *, model_parallel: int = 1,
                    n_devices: Optional[int] = None,
                    template: Any = None, device=None
                    ) -> Tuple[Any, Any, Any]:
    """Returns (state, mesh, extra) resharded onto the surviving ranks
    (``n_devices``: the process group's size when None; the mesh's
    device type is cuda unless ``device="cpu"``)."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    mesh = make_mesh_for(n, model_parallel, device=device)
    pshard = param_shardings(model.logical_axes(), mesh,
                             fsdp=model.cfg.fsdp,
                             abstract_tree=model.abstract_params())
    mgr = CheckpointManager(ckpt_dir)
    if template is None:
        raise ValueError("elastic_restore needs a state template")
    # reshard only the params subtree; opt state follows its own tree
    state, extra = mgr.restore(template=template)
    state["params"] = tree_map(
        lambda a, s: place(a.to(mesh.device_type), mesh, s.placements),
        state["params"],
        pshard)
    return state, mesh, extra
