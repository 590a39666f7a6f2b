"""Training: the counterpart of ``repro.train``.

``CheckpointManager`` writes the reference trainer's array layout (one
fsynced ``.npy`` per leaf + manifest, atomic publish; ``Index
.save_snapshot`` / ``Index.restore`` use it too), ``StepWatchdog`` and
``FailureInjector`` are the reference's fault primitives (a verbatim
copy), and ``Trainer`` / ``TrainConfig`` the fault-tolerant loop.
``elastic.py`` waits for the partitioning item (ROADMAP A13d).
"""

from .checkpoint import CheckpointManager
from .fault import StepWatchdog, FailureInjector
from .train_loop import Trainer, TrainConfig

__all__ = ["CheckpointManager", "StepWatchdog", "FailureInjector",
           "Trainer", "TrainConfig"]
