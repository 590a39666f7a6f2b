"""Training: the counterpart of ``repro.train``.

``CheckpointManager`` writes the reference trainer's array layout (one
fsynced ``.npy`` per leaf + manifest, atomic publish; ``Index
.save_snapshot`` / ``Index.restore`` use it too), ``StepWatchdog`` and
``FailureInjector`` are the reference's fault primitives (a verbatim
copy), ``Trainer`` / ``TrainConfig`` the fault-tolerant loop (sharded
over a ``torch.distributed`` mesh when its ``constrain`` hook carries
one), and ``elastic.elastic_restore`` resumes a checkpoint on a mesh of
another shape.
"""

from .checkpoint import CheckpointManager
from .fault import StepWatchdog, FailureInjector
from .train_loop import Trainer, TrainConfig

__all__ = ["CheckpointManager", "StepWatchdog", "FailureInjector",
           "Trainer", "TrainConfig"]
