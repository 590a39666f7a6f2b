"""Tensor parallelism for the other four families over
``torch.distributed``: ``gloo`` ranks on the CPU, one process a rank
(the rank programs are in tests/torch_dist_ranks.py, which imports no
JAX; each test runs one subprocess that spawns its ranks under a time
limit).

Under a mesh the trainer runs internvl2, whisper, zamba and xLSTM on
each rank's shards (``dist.partitioning.TensorParallel``), as GSPMD
runs the reference's jitted step: the vocab-parallel embedding, logits
and loss; attention heads and "ffn" columns; Mamba-2's SSM heads; the
mLSTM's per-head cell (or, where the guard keeps its heads whole, the
whole cell between its split up- and down-projections) and the sLSTM's
heads.

* Reduced internvl2, whisper, zamba and xLSTM (8 blocks, so block 7 is
  the sLSTM) in f32 on ``conditioned`` params, on (1, 4) and (2, 2)
  meshes (zamba and xLSTM with FSDP on (2, 2)), and two guard configs
  whose heads a "model" axis of 4 keeps whole (whisper with 6, xLSTM
  with 3), one subprocess a case (``tp_case`` in torch_dist_ranks.py):
  the loss and every grad shard of a masked batch within 1e-4 of one
  process; two ``Trainer`` steps' losses and gnorms within 1e-4, or
  within twice the one process's own spread when its f32 params move by
  one ulp where that is larger (the xLSTM: its first AdamW update moves
  each component of the zero-initialised gate projections by ``lr``
  with a sign the grads' rounding decides, and the exponential input
  gate carries that into the second step: its own spread is 6e-4-3e-3);
  every leaf of the state after the steps, placed by its spec, within
  1e-4 of one process's on its scale, or within twice that one
  process's own spread of the leaf when that is larger (the same AdamW
  sign moves set a zero-initialised leaf's own scale: xLSTM's reach
  2e-2 of it); a prefill and two decode steps (the enc-dec: the loss
  with labels = tokens, then two steps on drawn caches; the recurrent
  families: the prompt through ``decode_fn``) on the rank's rows and
  cache shards, each rank's logits columns and cache shards within 1e-4
  of one process's.
* zamba's one-row decode (as long_500k) on (2, 2) and (4, 1): the
  long-context rule splits the shared block's KV cache on its sequence
  over "data", and each rank attends over its own positions (the hook's
  ``kv_seq``), with heads split over "model" (2, 2) and whole (4, 1):
  logits and cache shards within 1e-4 of one process's.
* On a 1x1 mesh (one rank, every collective skipped) the
  tensor-parallel design is the plain trainer bit for bit, for each
  family, bf16 as drawn.
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
        capture_output=True, text=True, cwd=ROOT, timeout=180,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert done.returncode == 0, (done.stdout[-2000:], done.stderr[-4000:])
    line = [x for x in done.stdout.splitlines() if x.startswith("{")][-1]
    return json.loads(line)


CASES = [("internvl2", "1x4"), ("internvl2", "2x2"),
         ("whisper", "1x4"), ("whisper", "2x2"),
         ("zamba", "1x4"), ("zamba_fsdp", "2x2"),
         ("xlstm", "1x4"), ("xlstm_fsdp", "2x2"),
         ("whisper_guard", "1x4"), ("xlstm_guard", "1x4")]
# the caches the guard keeps whole: the guard cells' heads on 4, and
# internvl2's 2 KV heads on 4
WHOLE_CACHES = {("whisper_guard", "1x4"), ("xlstm_guard", "1x4"),
                ("internvl2", "1x4")}


@pytest.mark.parametrize("cell,mesh", CASES,
                         ids=[f"{c}-{m}" for c, m in CASES])
def test_family_trains_and_serves_as_one_process(cell, mesh, tmp_path):
    out = launch(f"tp_case:{cell}:{mesh}", 4, tmp_path)
    assert out["loss_rel_err"] <= RTOL
    assert out["grad_max_rel_err"] <= RTOL
    step_tol = max(RTOL, 2 * out["step_ulp_spread"])
    assert out["step_loss_rel_err"] <= step_tol
    assert out["gnorm_rel_err"] <= step_tol
    assert out["state_excess"] <= 1, out["state_worst_rank0"]
    assert out["rel_err"] <= RTOL
    assert out["vocab_split"]
    assert (out["cache_leaves_split"] == 0) == ((cell, mesh) in WHOLE_CACHES)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_split_sequence_cache_decodes_as_one_process(mesh, tmp_path):
    out = launch(f"tp_long_decode:zamba:{mesh}", 4, tmp_path)
    assert out["kv_seq"] == ["data"]
    assert out["rel_err"] <= RTOL


def test_one_rank_mesh_is_the_plain_step_bit_for_bit(tmp_path):
    out = launch("tp_families_one_rank", 1, tmp_path)
    assert set(out) == {"internvl2", "whisper", "zamba", "xlstm"}
    assert all(v["leaves"] > 0 for v in out.values())
