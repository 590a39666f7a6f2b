"""The four other families' tensor-parallel step counted
(``launch.dryrun.count_step`` in a ``fake`` process group) against the
reference's compiled step.

* The reference's ``dryrun.build_step`` for reduced internvl2-2b,
  whisper-base, zamba2-1.2b and xlstm-125m train (8 x 128 tokens),
  jitted over an 8-device CPU mesh with Auto axes (a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``), (8, 1) and
  (2, 4) data x model, and the port's count of the same step in a
  ``fake`` group of 8.  ``FlopCounterMode`` counts the products
  (``mm``, ``bmm``, ...) of every iteration; XLA's ``cost_analysis()``
  counts elementwise work too, which GSPMD may leave whole on every
  rank, and a loop body once.  So the port's (2, 4) / (8, 1) FLOP ratio
  is held, within ``RATIO_RTOL`` = 10%, to the ratio of the reference's
  compiled products, as ``test_torch_tp_count.py`` holds the LM's:
  ``hlo_dots.dot_flops``, every ``dot`` in its partitioned HLO a device,
  a loop body times its trip count (1.075, 1.000, 1.176, 1.000).
  ``cost_analysis()``'s ratio is printed beside it (1.133, 1.075,
  1.384, 1.150): xlstm's dots are split exactly (the same 165,675,008
  FLOPs a device on both meshes) while its ``cost_analysis()`` rises
  1.150 times.  The same step under gather-at-use (the model's
  ``tensor_parallel`` off) rises 4 times.
* No step of the four (train, prefill, decode; zamba with FSDP too,
  and zamba's one-row decode, whose KV sequence the long-context rule
  splits over "data") calls ``full_tensor`` or ``redistribute`` on a
  DTensor while it runs, and each reduces over "model".
* The dry run's whisper-base x train_4k on pod16x16 (256 ranks) runs
  the tensor-parallel design and counts fewer FLOPs a device and fewer
  peak bytes than gather-at-use did (44.9 TFLOP, 69.6 GB: PERF.md §6).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RATIO_RTOL = 0.10
ARCHS = ("internvl2-2b", "whisper-base", "zamba2-1.2b", "xlstm-125m")
WHISPER_GATHER_AT_USE = {"tflop": 44.9, "peak_gb": 69.6}   # PERF.md §6

REFERENCE = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "tests")
from hlo_dots import dot_flops
import jax
jax.devices()
from jax.sharding import AxisType
from repro.configs import ARCHS, reduced
from repro.configs.base import ShapeConfig
from repro.models import build_model
import repro.launch.dryrun as dr

shape = ShapeConfig("probe", 128, 8, "train")
out = {}
for arch in sys.argv[1:]:
    model = build_model(reduced(ARCHS[arch]))
    for ms in ((8, 1), (2, 4)):
        mesh = jax.make_mesh(ms, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        fn, args = dr.build_step(model, shape, mesh)
        compiled = fn.lower(*args).compile()
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        key = arch + ":" + "x".join(map(str, ms))
        out[key] = {"cost": ca["flops"], "dots": dot_flops(compiled.as_text())}
print(json.dumps(out))
"""

PORT = r"""
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import build_model
shape = ShapeConfig("probe", 128, 8, "train")
out = {}
with dryrun.fake_group(8):
    for arch in sys.argv[1:]:
        model = build_model(reduced(ARCHS[arch]))
        for ms in ((8, 1), (2, 4)):
            mesh = init_device_mesh("cpu", ms,
                                    mesh_dim_names=("data", "model"))
            for m in (model,
                      dataclasses.replace(model, tensor_parallel=False)):
                step, args = dryrun.build_step(m, shape, mesh)
                c = dryrun.count_step(step, args)
                out[arch + ":" + step.design + ":"
                    + "x".join(map(str, ms))] = c["flops_per_device"]
print(json.dumps(out))
"""

NO_GATHER = r"""
import dataclasses, json
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import build_model

SHAPES = {"train": ShapeConfig("t", 32, 4, "train"),
          "prefill": ShapeConfig("p", 32, 32, "prefill"),
          "decode": ShapeConfig("d", 48, 32, "decode")}
CELLS = {"internvl2": ("internvl2-2b", {}),
         "whisper": ("whisper-base", {}),
         "zamba": ("zamba2-1.2b", {}),
         "zamba_fsdp": ("zamba2-1.2b", {"fsdp": True}),
         "xlstm": ("xlstm-125m", {"n_layers": 8})}


def refuse(*a, **k):
    raise AssertionError("a DTensor was gathered or redistributed")


def counts(model, shape, mesh):
    step, args = dryrun.build_step(model, shape, mesh)
    saved = DTensor.full_tensor, DTensor.redistribute
    DTensor.full_tensor = DTensor.redistribute = refuse
    try:
        with CommDebugMode() as comm:
            dryrun.count_step(step, args)
    finally:
        DTensor.full_tensor, DTensor.redistribute = saved
    return {"design": step.design,
            **{str(k).split(".")[-1]: v
               for k, v in comm.get_comm_counts().items()}}


out = {}
with dryrun.fake_group(4):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name, (arch, kw) in CELLS.items():
        cfg = dataclasses.replace(reduced(ARCHS[arch]), remat="full", **kw)
        model = build_model(cfg)
        for kind, shape in SHAPES.items():
            out[f"{name}:{kind}"] = counts(model, shape, mesh)
    # one row, as long_500k: the KV sequence split over "data"
    model = build_model(dataclasses.replace(reduced(ARCHS["zamba2-1.2b"]),
                                            remat="full"))
    out["zamba:long"] = counts(model, ShapeConfig("l", 48, 1, "decode"),
                               mesh)
print(json.dumps(out))
"""

CELL = r"""
import json, sys, tempfile
from repro_torch.launch import dryrun, roofline
with tempfile.TemporaryDirectory() as tmp:
    rec = dryrun.run_cell("whisper-base", "train_4k", False, tmp)
print(json.dumps({**rec, **roofline.analyze_cell(rec)}))
"""


def _run(code, env, *argv, timeout=300):
    r = subprocess.run([sys.executable, "-c", code, *argv],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=timeout, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _env():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def counts():
    return (_run(REFERENCE, _env(), *ARCHS, timeout=600),
            _run(PORT, _env(), *ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_flop_ratio_over_model_matches_the_references_compiled_ratio(
        arch, counts):
    ref, port = counts
    dot_ratio = ref[f"{arch}:2x4"]["dots"] / ref[f"{arch}:8x1"]["dots"]
    cost_ratio = ref[f"{arch}:2x4"]["cost"] / ref[f"{arch}:8x1"]["cost"]
    tp_ratio = (port[f"{arch}:tensor-parallel:2x4"]
                / port[f"{arch}:tensor-parallel:8x1"])
    gau_ratio = (port[f"{arch}:gather-at-use:2x4"]
                 / port[f"{arch}:gather-at-use:8x1"])
    print(json.dumps({"arch": arch,
                      "reference": {m: ref[f"{arch}:{m}"] for m in
                                    ("8x1", "2x4")},
                      "port": {m: port[f"{arch}:tensor-parallel:{m}"] for m
                               in ("8x1", "2x4")},
                      "reference_dot_ratio": dot_ratio,
                      "reference_cost_ratio": cost_ratio,
                      "tensor_parallel_ratio": tp_ratio,
                      "gather_at_use_ratio": gau_ratio}))
    assert abs(tp_ratio / dot_ratio - 1) <= RATIO_RTOL
    # the (2, 4) rank's 4 rows through the whole model
    assert gau_ratio > 3.5


def test_family_steps_gather_no_param_whole():
    got = _run(NO_GATHER, _env())
    for name in ("internvl2", "whisper", "zamba", "zamba_fsdp", "xlstm"):
        for kind in ("train", "prefill", "decode"):
            c = got[f"{name}:{kind}"]
            assert c["design"] == "tensor-parallel", (name, kind)
            assert c.get("allreduce_", 0) > 0, (name, kind)
    # without FSDP a train step gathers only activations over "model":
    # the mLSTM's up-projection and the sLSTM's heads (xlstm), the conv
    # window's channels in a zamba decode
    for kind in ("train", "prefill", "decode"):
        for name in ("internvl2", "whisper"):
            c = got[f"{name}:{kind}"]
            assert "all_gather_into_tensor" not in c, (name, kind, c)
            assert "reduce_scatter_tensor" not in c, (name, kind, c)
    assert got["zamba_fsdp:train"].get("reduce_scatter_tensor", 0) > 0
    # a one-row decode attends over the rank's positions: the softmax's
    # max and sum and the values' product add all-reduces over "data",
    # and nothing more is gathered than the conv window's channels
    long, short = got["zamba:long"], got["zamba:decode"]
    assert long["design"] == "tensor-parallel"
    assert long["allreduce_"] > short["allreduce_"], (long, short)
    assert long.get("all_gather_into_tensor", 0) == short.get(
        "all_gather_into_tensor", 0), (long, short)


def test_dryrun_whisper_train_4k_runs_the_tensor_parallel_design():
    rec = _run(CELL, _env(), timeout=600)
    assert rec["status"] == "ok" and rec["design"] == "tensor-parallel"
    assert rec["n_devices"] == 256
    assert rec["flops_per_device"] < WHISPER_GATHER_AT_USE["tflop"] * 1e12
    assert rec["peak_bytes"] < WHISPER_GATHER_AT_USE["peak_gb"] * 1e9
    assert rec["fits"] is True
