"""The port's dry run (``repro_torch.launch.{dryrun,roofline,extrapolate}``)
against the reference's on the CPU.

* ``applicable``, ``param_count`` / ``active_param_count`` equal the
  reference's for every arch and shape.
* The meta count equals a real run of the same step: ``FlopCounterMode``
  over a real CPU step equals ``count_step`` on ``meta`` tensors (train,
  prefill, decode on reduced configs), exactly; c10d op names map onto
  the reference's five collective kinds.
* ``roofline`` and ``extrapolate`` equal the reference's on the
  reference tests' records when the reference's constants are the
  port's.
* The ``abstract=True`` inits equal the reference's trees in shape and
  dtype.
* The CLI writes the reference's records (``tests/
  test_dryrun_integration.py``'s cells), and importing the module starts
  no process group and leaves the environment as it was.

The per-device argument shards against the reference's shardings are
in ``test_torch_dryrun_shards.py``; the collectives of a real ``gloo``
step against the ``fake``-group count in ``test_torch_dryrun_dist.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.models import build_model as r_build_model
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, reduced
from repro_torch.launch import dryrun, extrapolate, roofline
from repro_torch.models import build_model
from repro_torch.tree import leaf_paths

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def _ref_dryrun():
    # importing the reference's dryrun sets XLA_FLAGS (its line 2); JAX
    # is already initialised here, so the variable is put back
    prev = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as dr
    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    return dr


def test_applicable_equals_the_reference_for_every_cell():
    ref = _ref_dryrun()
    cells = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]
    assert len(cells) == 40
    for a, s in cells:
        assert dryrun.applicable(ARCHS[a], SHAPES[s]) == ref.applicable(
            R_ARCHS[a], R_SHAPES[s]), (a, s)
    assert sum(not dryrun.applicable(ARCHS[a], SHAPES[s])
               for a, s in cells) == 8


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_the_reference_at_full_size(arch):
    port, ref = build_model(ARCHS[arch]), r_build_model(R_ARCHS[arch])
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


# ---------------------------------------------------------------------------
# the meta count against a real run of the same step
# ---------------------------------------------------------------------------

SMALL = {"train": ShapeConfig("train_small", 32, 2, "train"),
         "prefill": ShapeConfig("prefill_small", 32, 2, "prefill"),
         "decode": ShapeConfig("decode_small", 48, 2, "decode")}


@pytest.mark.parametrize("arch,kind", [
    ("internlm2-1.8b", "train"), ("granite-moe-1b-a400m", "train"),
    ("kimi-k2-1t-a32b", "train"), ("internvl2-2b", "prefill"),
    ("whisper-base", "prefill"), ("internlm2-1.8b", "decode"),
    ("zamba2-1.2b", "decode"), ("xlstm-125m", "decode")])
def test_meta_flops_equal_a_real_cpu_step(arch, kind):
    from torch.utils.flop_counter import FlopCounterMode
    model = build_model(dataclasses.replace(reduced(ARCHS[arch]),
                                            remat="full"))
    shape = SMALL[kind]
    step, args = dryrun.build_step(model, shape, None)
    counted = dryrun.count_step(step, args)
    real_step, real_args = dryrun.build_step(model, shape, None,
                                             device="cpu", seed=3)
    with FlopCounterMode(display=False) as flops:
        out = real_step(*real_args)
    assert counted["flops_per_device"] > 0
    assert float(flops.get_total_flops()) == counted["flops_per_device"]
    assert counted["collective_ops"] == 0
    assert counted["peak_bytes"] >= counted["argument_size_in_bytes"] > 0
    assert counted["alias_size_in_bytes"] == dryrun._nbytes(
        [args[i] for i in step.donate_argnums])
    # the real step's result holds numbers
    first = out["loss"] if kind == "train" else out[0]
    assert bool(torch.isfinite(first).all())


def test_collective_bytes_maps_c10d_ops_onto_the_five_kinds():
    total, per_kind, count = dryrun.collective_bytes([
        ("c10d.allreduce_", 8), ("_c10d_functional.all_reduce", 4),
        ("_c10d_functional.all_gather_into_tensor", 32),
        ("c10d.allgather_", 16), ("c10d._reduce_scatter_base_", 2),
        ("_c10d_functional.reduce_scatter_tensor", 2),
        ("c10d.alltoall_base_", 64),
        ("_c10d_functional_autograd.all_to_all_single", 64),
        ("c10d.send", 1)])
    assert per_kind == {"all-reduce": 12, "all-gather": 48,
                        "reduce-scatter": 4, "all-to-all": 128,
                        "collective-permute": 1}
    assert count == 9 and total == 193
    with pytest.raises(ValueError, match="no HLO kind"):
        dryrun.collective_bytes([("c10d.broadcast_", 4)])


# ---------------------------------------------------------------------------
# roofline and extrapolate against the reference's
# ---------------------------------------------------------------------------

RECORDS = [
    {"arch": "yi-9b", "shape": "train_4k", "mesh": "pod16x16",
     "tag": "baseline", "status": "ok", "n_devices": 256,
     "flops_per_device": 1.97e14, "bytes_per_device": 8.19e11,
     "collective_bytes_per_device": 5e10,
     "params": 8.8e9, "active_params": 8.8e9},
    {"arch": "kimi-k2-1t-a32b", "shape": "decode_32k",
     "mesh": "pod2x16x16", "tag": "baseline", "status": "ok",
     "n_devices": 512, "flops_per_device": 3.1e12,
     "bytes_per_device": 2.2e12, "collective_bytes_per_device": 9.9e11,
     "params": 1.04e12, "active_params": 3.3e10,
     "collectives": {"all-gather": 9.9e11}},
    {"arch": "yi-9b", "shape": "long_500k", "mesh": "pod16x16",
     "tag": "baseline", "status": "n/a",
     "reason": "long_500k requires sub-quadratic attention"},
]


def test_roofline_equals_the_reference_at_the_ports_constants(
        monkeypatch, tmp_path):
    import repro.launch.roofline as ref
    monkeypatch.setattr(ref, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref, "ICI_BW", roofline.LINK_BW)
    for i, rec in enumerate(RECORDS):
        (tmp_path / f"cell{i}.json").write_text(json.dumps(rec))
        if rec["status"] == "ok":
            assert roofline.analyze_cell(rec) == ref.analyze_cell(rec)
    for tag in ("baseline", None):
        got = roofline.load_cells(str(tmp_path), tag=tag)
        assert got == ref.load_cells(str(tmp_path), tag=tag)
        assert len(got) == 3
        assert roofline.to_markdown(got) == ref.to_markdown(got)
    # the H100's terms: 1 s of each at its peaks
    c = roofline.analyze_cell({**RECORDS[0],
                               "flops_per_device": 989e12,
                               "bytes_per_device": 3.35e12,
                               "collective_bytes_per_device": 50e9})
    assert c["t_compute_s"] == c["t_memory_s"] == c["t_collective_s"] == 1.0


def test_extrapolate_equals_the_reference_field_for_field(tmp_path):
    prev = os.environ.get("XLA_FLAGS")
    from repro.launch.extrapolate import extrapolate as ref
    out = {}
    for side, fn in (("port", extrapolate.extrapolate), ("ref", ref)):
        d = tmp_path / side
        d.mkdir()
        for tag, L in (("L4", 4), ("L8", 8)):
            rec = {"arch": "internlm2-1.8b", "shape": "train_4k",
                   "mesh": "pod16x16", "tag": tag, "status": "ok",
                   "layers_used": L, "n_devices": 256,
                   "flops_per_device": 100 + 10 * L,
                   "bytes_per_device": 7 + 3 * L,
                   "collective_bytes_per_device": 5 * L,
                   "collective_ops": 2 * L,
                   "collectives": {"all-reduce": 5 * L}}
            (d / f"internlm2-1.8b__train_4k__pod16x16__{tag}.json"
             ).write_text(json.dumps(rec))
        fn(str(d), "internlm2-1.8b", "train_4k", "pod16x16", 4, 8)
        out[side] = json.loads(
            (d / "internlm2-1.8b__train_4k__pod16x16.json").read_text())
    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    assert out["port"] == out["ref"]
    assert out["port"]["flops_per_device"] == 100 + 10 * 24
    assert "peak_bytes" in extrapolate.LINEAR_FIELDS
    law = extrapolate.at_depth({"peak_bytes": 10.0}, {"peak_bytes": 14.0},
                               2, 4, 24, fields=("peak_bytes",))
    assert law == {"peak_bytes": 54.0}


# ---------------------------------------------------------------------------
# the abstract inits
# ---------------------------------------------------------------------------

def _shapes(tree_paths):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for _, t in tree_paths]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b"])
def test_abstract_inits_equal_the_references(arch):
    from repro.optim import OPTIMIZERS as R_OPT
    from repro.optim.compress import residual_init as r_residual
    from repro_torch.optim import OPTIMIZERS
    from repro_torch.optim.compress import residual_init
    port = build_model(reduced(ARCHS[arch])).abstract_params()
    ref = r_build_model(reduced(R_ARCHS[arch])).abstract_params()
    for name in ("adamw", "adafactor"):
        got = leaf_paths(OPTIMIZERS[name][0](port, abstract=True))
        want = jax.tree_util.tree_flatten_with_path(
            R_OPT[name][0](ref, abstract=True))[0]
        assert _shapes(got) == [(tuple(s.shape), str(s.dtype))
                                for _, s in want]
        assert {t.device.type for _, t in got} == {"meta"}
        step = dict(got)[("step",)]
        assert step.shape == () and step.dtype == torch.int32
    got = leaf_paths(residual_init(port, abstract=True))
    want = jax.tree_util.tree_flatten_with_path(r_residual(ref,
                                                           abstract=True))[0]
    assert _shapes(got) == [(tuple(s.shape), str(s.dtype)) for _, s in want]
    assert {t.device.type for _, t in got} == {"meta"}


# ---------------------------------------------------------------------------
# the CLI and the import
# ---------------------------------------------------------------------------

def _cli(*argv, timeout=300):
    env = dict(ENV)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_cli_counts_a_cell_on_both_meshes(tmp_path):
    r = _cli("--arch", "whisper-base", "--shape", "decode_32k", "--mesh",
             "both", "--out", str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for mesh, n in (("pod16x16", 256), ("pod2x16x16", 512)):
        cell = json.loads(
            (tmp_path / f"whisper-base__decode_32k__{mesh}.json").read_text())
        assert cell["status"] == "ok"
        assert cell["n_devices"] == n
        assert cell["flops_per_device"] > 0
        assert cell["bytes_per_device"] > 0
        assert cell["collective_ops"] >= 0
        assert "collectives" in cell
        assert cell["design"] == "tensor-parallel"
        assert cell["fits"] is True
        assert cell["peak_bytes"] == (cell["argument_size_in_bytes"]
                                      + cell["temp_size_in_bytes"])
    table = _cli("--table", str(tmp_path))
    assert table.returncode == 0
    # one row a cell, each mesh's value where they differ
    row = [x for x in table.stdout.splitlines()
           if x.startswith("| whisper-base | decode_32k |")]
    assert len(row) == 1 and " / " in row[0]


def test_cli_records_a_cell_that_is_na_by_design(tmp_path):
    r = _cli("--arch", "yi-9b", "--shape", "long_500k", "--mesh", "single",
             "--out", str(tmp_path))
    assert r.returncode == 0
    cell = json.loads((tmp_path / "yi-9b__long_500k__pod16x16.json"
                       ).read_text())
    assert cell["status"] == "n/a"
    assert "sub-quadratic" in cell["reason"]


def test_import_starts_no_group_and_leaves_the_environment():
    code = ("import os, json\n"
            "before = dict(os.environ)\n"
            "import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.launch.extrapolate\n"
            "import sys\n"
            "print(json.dumps([dist.is_initialized(),"
            " dict(os.environ) == before,"
            " 'torch.testing._internal.distributed.fake_pg' in sys.modules]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120, env=ENV)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [False, True,
                                                             False]
