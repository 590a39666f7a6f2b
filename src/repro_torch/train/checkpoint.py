"""Atomic array checkpoints in the reference's on-disk layout, without
JAX.

Layout (``repro.train.checkpoint.CheckpointManager``'s): ``<dir>/
step_<k:08d>/`` with one fsynced ``<leaf>.npy`` per array and a
``manifest.json`` holding ``step``, ``leaves``, ``dtypes``, ``treedef``
and ``extra``.  A save writes ``step_<k>.tmp`` and renames it only
after every file is fsynced, so a torn write never shadows the newest
good checkpoint; ``keep`` bounds the published steps.

The state is a flat dict of numpy arrays.  Its leaves are written in
sorted key order, the order in which JAX flattens a dict: the
reference's ``Index.restore`` unflattens the listed arrays against a
same-keyed template, so a snapshot that listed them in any other order
would hand it the wrong array under a name.  ``treedef`` is written as
an empty string: the reference serializes JAX's tree structure there,
which cannot be built without JAX, and the index snapshots that this
package writes and reads never consult the field (the reference
restores them against its template).  ``restore`` maps the listed
names to their arrays and does not read ``treedef`` either.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """Save, list, restore and garbage-collect checkpoints of a flat
    dict of numpy arrays under ``directory``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state: Dict[str, np.ndarray],
             extra: Optional[Dict] = None) -> str:
        """Publish ``state`` as ``step_<step>``; returns its directory."""
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        names = sorted(state)
        dtypes = []
        for name in names:
            arr = np.asarray(state[name])
            dtypes.append(str(arr.dtype))
            with open(os.path.join(tmp, name + ".npy"), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
        manifest = {
            "step": step,
            "leaves": names,
            "dtypes": dtypes,
            "treedef": "",
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None
                ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """``(state, extra)`` of ``step`` (the newest when None): each
        listed leaf name mapped to its array."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        state = {n: np.load(os.path.join(d, n + ".npy"))
                 for n in manifest["leaves"]}
        return state, manifest["extra"]

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))
