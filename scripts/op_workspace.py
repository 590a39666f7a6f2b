"""Find the temporaries that CUDA kernels allocate inside an op, out of
a dispatch mode's sight, over the dry run's plain train step.

``launch/dryrun.py`` counts a step's peak memory on ``meta`` tensors,
where an op allocates only its outputs; on the card some kernels
allocate more while they run.  This runs ``dryrun.build_step``'s plain
step (no mesh) on the card, once to warm up and once under a dispatch
mode that, around each aten op, synchronises, resets the allocator's
peak and records the peak during the op less what was allocated before
it and less the op's outputs.  It prints, per config, the ops whose
excess passed 50 MB: their name, call count, largest excess and the
shapes of their first arguments.  ``dryrun._card_workspace`` holds what
it found over those ops; run this again after a change to the models
or to PyTorch:

    PYTHONPATH=src python scripts/op_workspace.py

internlm2-1.8b at 4 rows and granite-moe-1b-a400m at 8 rows of
train_4k's 4,096 tokens, both at full width and 2 layers (chip_smoke.py
phase 17's cells).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CELLS = (("granite-moe-1b-a400m", 8), ("internlm2-1.8b", 4))
THRESHOLD = 50e6


class Excess(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.rows = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = func(*args, **(kwargs or {}))
        torch.cuda.synchronize()
        excess = (torch.cuda.max_memory_allocated() - before
                  - sum(t.numel() * t.element_size()
                        for t in dryrun._tensors(out) if t.is_cuda))
        if excess > THRESHOLD:
            row = self.rows.setdefault(str(func), {"calls": 0, "bytes": 0})
            row["calls"] += 1
            row["bytes"] = max(row["bytes"], excess)
            row["args"] = [list(t.shape) for t in
                           dryrun._tensors(list(args))][:4]
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("op_workspace: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for arch, rows in CELLS:
        cfg = dataclasses.replace(ARCHS[arch], n_layers=2)
        shape = dataclasses.replace(SHAPES["train_4k"], global_batch=rows)
        step, args = dryrun.build_step(build_model(cfg), shape, None,
                                       device="cuda")
        step(*args)
        mode = Excess()
        with mode:
            step(*args)
        print(json.dumps({"card": card, "arch": arch, "rows": rows,
                          "ops": mode.rows}))
        del step, args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
