"""PyTorch + CUDA port of ``repro``, the sampled, gap-inserted learned
index (A Pluggable Learned Index Method via Sampling and Gap Insertion).

The layout mirrors ``repro``: ``core/`` holds the host build (copies of
the reference's numpy modules) and the ``Index`` handle; ``kernels/``
holds the freeze, the lookup engine, the write path, device Eq. 3, the
shard fan-out and the hand-written CUDA kernels that serve them on an
NVIDIA Hopper card; ``dist/`` the range-sharded index; ``serving/`` the
pipeline, the WAL, the paged-KV block table and the decode engine;
``data/`` the indexed token dataset and its loader; ``models/`` the
model families; ``optim/`` and ``train/`` the optimizers and the
fault-tolerant trainer; ``launch/`` the serving and training entry
points; ``tree.py`` nested-container trees in JAX's flattening order.

This package imports ``torch`` and never ``jax``, and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
