"""Checkpoints: ``CheckpointManager`` writes the reference trainer's
array layout (one fsynced ``.npy`` per array + manifest, atomic
publish), which ``Index.save_snapshot`` / ``Index.restore`` use."""

from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
