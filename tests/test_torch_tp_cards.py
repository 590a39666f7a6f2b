"""The per-step check of the tensor-parallel step on four cards (marker
``gpu``; the test skips itself with fewer than four CUDA devices).

Each case is one subprocess running ``tp_training:CELL:MESH`` of
tests/torch_dist_ranks.py with ``TORCH_DIST_DEVICE=cuda``: four ranks,
one card each, over ``nccl`` with TF32 off, f32 ``conditioned`` params
at full width (``TP_FULL_CELLS``: internlm2-1.8b and yi-9b at 2 layers,
internvl2-2b at 2, whisper-base 2 + 2, zamba2-1.2b 6, xlstm-125m 8), 8
rows of 16 tokens, on the (2, 2) and (1, 4) meshes.  Each of two steps
runs again from a common state, the one process's before it, and the
case holds:

* (b) the mesh's new state equal, bit for bit, to the one process's
  optimizer applied to that state with the mesh's grads and global
  norm, the step count included;
* (c) every grad and state leaf, and the norm, equal bit for bit on the
  ranks that replicate it;
* (d) every component whose AdamW direction changes sign between
  U(S, Gm) and U(S, G1) one the grads' difference decides.

(a), the mesh's grads against one process's on each leaf's scale, is
printed with each leaf above 1e-4 and its one-ulp spread (the largest
of three draws), not held: on the cards it is a reading.  Each case
prints its JSON line (run with ``-s`` to see them).  Run:

    python -m pytest -m gpu tests/test_torch_tp_cards.py -s
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif(torch.cuda.device_count() < 4,
                       reason="needs four CUDA devices"),
]

FULL_CELLS = ["internlm2_full2", "yi_full2", "internvl2_full",
              "whisper_full", "zamba_full", "xlstm_full"]
CASES = [(c, m) for c in FULL_CELLS for m in ("2x2", "1x4")]


def launch(name):
    # a fresh file store for every run: a stale one makes ranks time out
    with tempfile.TemporaryDirectory() as tmp:
        done = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"),
             name, "4", tmp],
            capture_output=True, text=True, cwd=ROOT, timeout=900,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "TORCH_DIST_DEVICE": "cuda"})
    assert done.returncode == 0, (done.stdout[-2000:], done.stderr[-4000:])
    line = [x for x in done.stdout.splitlines() if x.startswith("{")][-1]
    print(f"{name} {line}", flush=True)
    return json.loads(line)


@pytest.mark.parametrize("cell,mesh", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_each_step_from_a_common_state_on_four_cards(cell, mesh):
    out = launch(f"tp_training:{cell}:{mesh}")
    assert len(out["per_step"]) == 2
    for step in out["per_step"]:
        assert step["update_mismatches"] == []
        assert step["replica_mismatches"] == []
        assert step["flips_unexplained"] == 0, step["flips_by_leaf_rank0"]
