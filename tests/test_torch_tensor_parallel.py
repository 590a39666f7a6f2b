"""Tensor parallelism for the LM family over ``torch.distributed``:
``gloo`` ranks on the CPU, one process a rank (the rank programs are in
tests/torch_dist_ranks.py, which imports no JAX; each test runs one
subprocess that spawns its ranks under a time limit).

Under a mesh the trainer runs the LM on each rank's shards
(``dist.partitioning.TensorParallel``, the design GSPMD gives the
reference's jitted step): heads, "ffn" columns, experts and the vocab
split over "model", FSDP leaves gathered over "data" a layer at a time.

* Reduced internlm2-1.8b, granite-moe with ``moe_impl="ep"`` and yi-9b
  (FSDP) in f32 on (1, 4) and (2, 2) meshes, and reduced kimi-k2 (MoE,
  FSDP, Adafactor), granite-moe's replicated-token MoE, a qwen-style
  config whose 6 heads the guard keeps whole on a "model" axis of 4 and
  one whose 3 KV heads no axis divides: the loss and every grad shard
  of a masked batch within 1e-4 of one process, two ``Trainer`` steps'
  losses and gnorms within 1e-4, and every leaf of each rank's state
  (placed by its spec, Adafactor's factored moments by the spec less
  the dim each drops) against one process's state cut by that spec.
* Prefill and two decode steps on the rank's params, rows and cache
  shards: each rank's vocab columns of the logits and its cache shards
  within 1e-4 of one process's.
* ``base.vocab_parallel_xent`` over a vocab split four ways equals
  ``softmax_xent``, its value and its grad.
* On a 1x1 mesh (one rank, every collective skipped) the
  tensor-parallel design is the plain trainer bit for bit: reduced
  internlm2 with EF-int8 and kimi-k2 with Adafactor.

The bounds are the grad tests' (``test_torch_grad.py``): the split
products add in another order, about 1e-6 of a leaf's scale.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4
ADAFACTOR_RTOL = 1e-2    # torch_dist_ranks.ADAFACTOR_UPDATE_RTOL


def launch(name, world, tmp):
    done = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"), name,
         str(world), str(tmp)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert done.returncode == 0, (done.stdout[-2000:], done.stderr[-4000:])
    line = [x for x in done.stdout.splitlines() if x.startswith("{")][-1]
    return json.loads(line)


TRAIN_CASES = [("internlm2", "1x4"), ("internlm2", "2x2"),
               ("granite_ep", "1x4"), ("granite_ep", "2x2"),
               ("yi_fsdp", "1x4"), ("yi_fsdp", "2x2"),
               ("kimi", "2x2"), ("granite", "1x4"),
               ("guard", "1x4"), ("kv_index", "2x2")]


@pytest.mark.parametrize("cell,mesh", TRAIN_CASES,
                         ids=[f"{c}-{m}" for c, m in TRAIN_CASES])
def test_tensor_parallel_training_equals_one_process(cell, mesh, tmp_path):
    out = launch(f"tp_training:{cell}:{mesh}", 4, tmp_path)
    assert out["loss_rel_err"] <= RTOL
    assert out["grad_max_rel_err"] <= RTOL
    assert out["step_loss_rel_err"] <= RTOL
    assert out["gnorm_rel_err"] <= RTOL
    assert out["state_max_rel_err"] <= RTOL
    assert out["adafactor_rel_err"] <= ADAFACTOR_RTOL


DECODE_CASES = [("internlm2", "2x2"), ("granite_ep", "2x2"),
                ("yi_fsdp", "2x2"), ("guard", "1x4"), ("kv_index", "1x4")]


@pytest.mark.parametrize("cell,mesh", DECODE_CASES,
                         ids=[f"{c}-{m}" for c, m in DECODE_CASES])
def test_tensor_parallel_prefill_and_decode_equal_one_process(cell, mesh,
                                                              tmp_path):
    out = launch(f"tp_decode:{cell}:{mesh}", 4, tmp_path)
    assert out["rel_err"] <= RTOL


def test_vocab_parallel_xent_equals_softmax_xent(tmp_path):
    out = launch("tp_xent", 4, tmp_path)
    assert out["loss_rel_err"] <= RTOL
    assert out["grad_max_rel_err"] <= RTOL
    # every shard holds some of the labels
    assert min(out["labels_per_shard"]) > 0


def test_one_rank_mesh_is_the_plain_step_bit_for_bit(tmp_path):
    out = launch("tp_one_rank", 1, tmp_path)
    assert set(out) == {"internlm2", "kimi"}
    assert all(v["leaves"] > 0 for v in out.values())
