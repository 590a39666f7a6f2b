"""The dry run's collectives against a real multi-process step.

A real (2, 2) ``gloo`` run of ``Trainer.train_step``
(``tests/torch_dist_ranks.py``, four CPU processes) counts the same
collectives, by ``CommDebugMode``'s op names and by the dry run's kinds
and result bytes, and the same FLOPs and operand bytes, as
``launch.dryrun.count_step`` of the same step on ``meta`` tensors as
rank 3 of a ``fake`` group of four: for reduced internlm2-1.8b with
FSDP, and for reduced granite-moe with ``moe_impl="ep"`` (its
``all_to_all_single`` exchanges under ``all-to-all``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


FAKE_COUNT = r"""
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, "tests")
from torch_dist_ranks import dryrun_counts
from repro_torch.launch.dryrun import fake_group
with fake_group(4):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    print(json.dumps(dryrun_counts(mesh, "meta", sys.argv[1])))
"""


def _last_json(stdout):
    return json.loads([x for x in stdout.splitlines()
                       if x.startswith("{")][-1])


@pytest.mark.parametrize("cell", ["dense", "ep"])
def test_fake_collectives_equal_a_real_gloo_step(cell, tmp_path):
    real = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"),
         f"dryrun_{cell}", "4", str(tmp_path)], capture_output=True,
        text=True, cwd=ROOT, timeout=300, env=ENV)
    assert real.returncode == 0, real.stderr[-4000:]
    fake = subprocess.run([sys.executable, "-c", FAKE_COUNT, cell],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300, env=ENV)
    assert fake.returncode == 0, fake.stderr[-4000:]
    got, want = _last_json(fake.stdout), _last_json(real.stdout)
    assert got == want
    assert want["collective_ops"] == sum(want["comm_counts"].values()) > 0
    if cell == "ep":
        assert want["collectives"]["all-to-all"] > 0
        assert want["comm_counts"]["c10d.alltoall_base_"] > 0
