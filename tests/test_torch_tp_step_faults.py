"""The per-step check of the tensor-parallel step decides: two faults
planted in one rank's mesh trainer are named by it, and with none
planted it names nothing.

Each case is one subprocess of 4 ``gloo`` ranks on the CPU running
``tp_step_fault:FAULT`` of tests/torch_dist_ranks.py (which imports no
JAX): reduced internlm2 on a (2, 2) mesh takes one step from the same
fresh state as one process, and ``_step_readings`` compares (a) the
mesh's grads assembled whole with the one process's, (b) the mesh's new
state with the one process's optimizer applied to that state with the
mesh's grads and norm, bit for bit, and (c) every replicated grad and
state leaf across the ranks that hold it, bit for bit.  The faults are
patched on the trainer instance inside the rank program, so no port
file changes:

* "step": rank 1 updates its shard of ``layers/attn/wq`` (split over
  "model") with the step count one too high.  (b) must name that leaf.
* "reduce": rank 1's grad of ``ln_f`` (replicated) skips its sum over
  "data".  (c) or (a) must flag it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4


def launch(name, world, tmp):
    done = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"), name,
         str(world), str(tmp)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert done.returncode == 0, (done.stdout[-2000:], done.stderr[-4000:])
    line = [x for x in done.stdout.splitlines() if x.startswith("{")][-1]
    return json.loads(line)


@pytest.mark.parametrize("fault", ["none", "step", "reduce"])
def test_per_step_check_names_a_planted_fault(fault, tmp_path):
    out = launch(f"tp_step_fault:{fault}", 4, tmp_path)
    if fault == "none":
        assert out["update_mismatches"] == []
        assert out["replica_mismatches"] == []
        assert out["grad_rel_err"] <= RTOL
        assert out["flips_unexplained"] == 0
    elif fault == "step":
        # the update is wrong where the grads are right
        assert out["grad_rel_err"] <= RTOL
        assert f"params/{out['fault_leaf']}" in out["update_mismatches"]
    else:
        assert (f"grads/{out['fault_leaf']}" in out["replica_mismatches"]
                or out["grad_rel_err"] > RTOL)
