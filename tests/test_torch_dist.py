"""The port's partitioning over several processes: ``torch.distributed``
on the ``gloo`` backend, one CPU process a rank (the rank programs are
in tests/torch_dist_ranks.py, which imports no JAX).  Each test runs
one subprocess that spawns its ranks (``torch.multiprocessing``,
``spawn``, one thread a rank, a file store under ``tmp_path``) under a
time limit, so a hang fails one test.

* ``moe_ep_shardmap`` on a (2, 4) mesh equals the port's ``moe_gspmd``
  on the whole batch within the reference's 2e-4 (its
  tests/test_moe_ep.py case: E = 8, D = 16, F = 32, top-2, capacity
  factor 8.0), and its grads, summed over the ranks, the whole batch's
  within 1e-4; a reduced granite-moe with ``moe_impl="ep"`` on (2, 2)
  trains to the one-process loss and grads within 1e-4.
* Reduced internlm2 with ``fsdp`` on a (2, 2) mesh, under the
  tensor-parallel design the trainer runs for the LM family (the loss
  and grads of each rank's shards): loss and grads of a masked batch
  within 1e-4 of one process on ``chip_smoke.conditioned`` params cut
  by each leaf's spec, three ``Trainer`` steps too (AdamW, EF-int8
  compression: losses, gnorms, each param on its scale and 99% of its
  change), and three of reduced kimi-k2 (Adafactor, its factored
  moments sharded); a checkpoint saved from (2, 2) (byte for byte the
  one-process file) restores through ``elastic_restore`` onto (4, 1)
  and (1, 1) with every leaf equal to the state saved; a
  crash-and-resume ``Trainer.run`` over the mesh replays its step
  (every rank resumes where rank 0 does, with no wait or barrier of
  the test's own).

An MoE layer's capacity counts the tokens of the rows it is given, so
under data parallelism each rank drops by its own rows, as the
reference's ``moe_ep_shardmap`` does by its own tokens; the MoE cases
use a capacity factor that drops no token (ROADMAP queue C).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4


def launch(name, world, tmp):
    done = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"), name,
         str(world), str(tmp)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert done.returncode == 0, (done.stdout[-2000:], done.stderr[-4000:])
    line = [x for x in done.stdout.splitlines() if x.startswith("{")][-1]
    return json.loads(line)


def test_expert_parallel_moe_equals_gspmd_on_a_2x4_mesh(tmp_path):
    out = launch("moe_ep", 8, tmp_path)
    assert out["max_abs_err"] < 2e-4
    assert out["grad_max_rel_err"] <= RTOL


def test_expert_parallel_training_equals_one_process(tmp_path):
    out = launch("moe_ep_training", 4, tmp_path)
    assert out["loss_rel_err"] <= RTOL
    assert out["grad_max_rel_err"] <= RTOL


def test_sharded_training_equals_one_process_and_restores_elastically(
        tmp_path):
    out = launch("sharded_training", 4, tmp_path)
    assert out["loss_rel_err"] <= RTOL
    assert out["grad_max_rel_err"] <= RTOL
    assert out["step_loss_rel_err"] <= RTOL
    assert out["gnorm_rel_err"] <= RTOL
    assert out["update_max_rel_err"] <= RTOL
    assert out["adafactor"]["loss_rel_err"] <= RTOL
    assert out["adafactor"]["update_max_rel_err"] <= 1e-2
    run = out["run"]
    assert len(run["run1"]) == 3 and run["run2"][0] == run["run1"][2]
    one = launch("elastic_one", 1, tmp_path)
    assert one["leaves"] == 49
