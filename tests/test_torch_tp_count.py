"""The tensor-parallel step's counts (``launch.dryrun.count_step`` in a
``fake`` process group) against the reference's compiled step.

* The reference's ``dryrun.build_step`` for reduced internlm2-1.8b
  train (8 x 128 tokens), jitted over an 8-device CPU mesh with Auto
  axes (a subprocess with ``XLA_FLAGS=--xla_force_host_platform_
  device_count=8``), (8, 1) and (2, 4) data x model: the FLOPs of its
  products a device (``hlo_dots.dot_flops``: every ``dot`` of its
  partitioned HLO, a loop body times its trip count) rise 1.067 times
  from (8, 1) to (2, 4), where a (2, 4) rank holds 4 rows to the (8, 1)
  rank's 1: the reference splits the work over "model".  The port's
  ``FlopCounterMode`` count of the same step in a ``fake`` group of 8
  (the products too, every iteration) rises by a ratio within
  ``RATIO_RTOL`` = 10% of the reference's.  ``cost_analysis()``'s ratio
  (1.115: it adds elementwise work and counts a loop body once) is
  printed beside it.  The same step under gather-at-use (the model's
  ``tensor_parallel`` off) rises about 4 times.
* No LM-family step (train, prefill, decode; dense with FSDP, and the
  MoE both ways) calls ``full_tensor`` or ``redistribute`` on a DTensor
  while it runs; the train step's collectives are the "model"
  all-reduces and, under FSDP, one all-gather a "data"-split leaf a
  layer in the forward and again in the remat recompute, one
  reduce-scatter a leaf a layer in the backward.
* The dry run's internlm2-1.8b x train_4k on pod16x16 (256 ranks):
  at most a fifth of the 1,024.6 TFLOP a device that gather-at-use
  counted, and a useful share of at least 30%.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RATIO_RTOL = 0.10
GATHER_AT_USE_TFLOP = 1024.6     # the gather-at-use count (PERF.md §6)

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
model = build_model(reduced(ARCHS["internlm2-1.8b"]))
shape = ShapeConfig("probe", 128, 8, "train")
out = {}
for ms in ((8, 1), (2, 4)):
    mesh = jax.make_mesh(ms, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fn, args = dr.build_step(model, shape, mesh)
    compiled = fn.lower(*args).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    out["x".join(map(str, ms))] = {"cost": ca["flops"],
                                   "dots": dot_flops(compiled.as_text())}
print(json.dumps(out))
"""

PORT = r"""
import dataclasses, json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import build_model
model = build_model(reduced(ARCHS["internlm2-1.8b"]))
shape = ShapeConfig("probe", 128, 8, "train")
out = {}
with dryrun.fake_group(8):
    for ms in ((8, 1), (2, 4)):
        mesh = init_device_mesh("cpu", ms, mesh_dim_names=("data", "model"))
        for m in (model, dataclasses.replace(model, tensor_parallel=False)):
            step, args = dryrun.build_step(m, shape, mesh)
            c = dryrun.count_step(step, args)
            out[step.design + ":" + "x".join(map(str, ms))] = \
                c["flops_per_device"]
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
from repro_torch.tree import leaf_paths

SHAPES = {"train": ShapeConfig("t", 32, 4, "train"),
          "prefill": ShapeConfig("p", 32, 32, "prefill"),
          "decode": ShapeConfig("d", 48, 32, "decode")}
CELLS = {"internlm2": ("internlm2-1.8b", {}),
         "yi_fsdp": ("yi-9b", {}),
         "granite": ("granite-moe-1b-a400m", {}),
         "granite_ep": ("granite-moe-1b-a400m", {"moe_impl": "ep"}),
         "kimi": ("kimi-k2-1t-a32b", {})}


def refuse(*a, **k):
    raise AssertionError("a DTensor was gathered or redistributed")


out = {}
with dryrun.fake_group(4):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name, (arch, kw) in CELLS.items():
        cfg = dataclasses.replace(reduced(ARCHS[arch]), remat="full", **kw)
        model = build_model(cfg)
        for kind, shape in SHAPES.items():
            step, args = dryrun.build_step(model, shape, mesh)
            saved = DTensor.full_tensor, DTensor.redistribute
            DTensor.full_tensor = DTensor.redistribute = refuse
            try:
                with CommDebugMode() as comm:
                    dryrun.count_step(step, args)
            finally:
                DTensor.full_tensor, DTensor.redistribute = saved
            out[f"{name}:{kind}"] = {
                "design": step.design,
                **{str(k).split(".")[-1]: v
                   for k, v in comm.get_comm_counts().items()}}
        axes = leaf_paths(model.logical_axes())
        out[name] = {
            "fsdp": cfg.fsdp, "layers": cfg.n_layers,
            "layer_leaves": sum(1 for p, ax in axes
                                if p[0] == "layers" and "embed" in ax),
            "other_leaves": sum(1 for p, ax in axes
                                if p[0] != "layers" and "embed" in ax)}
print(json.dumps(out))
"""

CELL = r"""
import json, sys, tempfile
from repro_torch.launch import dryrun, roofline
with tempfile.TemporaryDirectory() as tmp:
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", False, tmp)
print(json.dumps({**rec, **roofline.analyze_cell(rec)}))
"""


def _run(code, env, timeout=300):
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=timeout, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _env():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    return env


def test_flop_ratio_over_model_matches_the_references_compiled_ratio():
    ref = _run(REFERENCE, _env())
    port = _run(PORT, _env())
    ref_ratio = ref["2x4"]["dots"] / ref["8x1"]["dots"]
    cost_ratio = ref["2x4"]["cost"] / ref["8x1"]["cost"]
    tp_ratio = port["tensor-parallel:2x4"] / port["tensor-parallel:8x1"]
    gau_ratio = port["gather-at-use:2x4"] / port["gather-at-use:8x1"]
    print(json.dumps({"reference": ref, "port": port,
                      "reference_dot_ratio": ref_ratio,
                      "reference_cost_ratio": cost_ratio,
                      "tensor_parallel_ratio": tp_ratio,
                      "gather_at_use_ratio": gau_ratio}))
    assert abs(tp_ratio / ref_ratio - 1) <= RATIO_RTOL
    # the (2, 4) rank's 4 rows through the whole model
    assert gau_ratio > 3.5


def test_lm_steps_gather_no_param_whole():
    got = _run(NO_GATHER, _env())
    for name in ("internlm2", "yi_fsdp", "granite", "granite_ep", "kimi"):
        for kind in ("train", "prefill", "decode"):
            c = got[f"{name}:{kind}"]
            assert c["design"] == "tensor-parallel", (name, kind)
            assert c.get("allreduce_", 0) > 0, (name, kind)
    # dense without FSDP: no gather at all, in any step
    for kind in ("train", "prefill", "decode"):
        c = got[f"internlm2:{kind}"]
        assert "all_gather_into_tensor" not in c and \
            "reduce_scatter_tensor" not in c, (kind, c)
    # FSDP: a gather a "data"-split leaf a layer, in the forward and
    # again in the remat recompute, and the embedding, the head and the
    # final norm's once; one reduce-scatter each in the backward
    for name in ("yi_fsdp", "kimi"):
        n = got[name]
        assert n["fsdp"], name
        train = got[f"{name}:train"]
        per_layer = n["layer_leaves"] * n["layers"]
        routers = 0
        if name == "kimi":   # the router, gathered over "model" too
            routers = n["layers"]
        assert train["all_gather_into_tensor"] == (2 * per_layer + routers * 2
                                             + n["other_leaves"]), train
        assert train["reduce_scatter_tensor"] == (per_layer + routers
                                                  + n["other_leaves"]), train


def test_dryrun_internlm2_train_4k_splits_the_work_over_model():
    rec = _run(CELL, _env(), timeout=600)
    assert rec["status"] == "ok" and rec["design"] == "tensor-parallel"
    assert rec["n_devices"] == 256
    assert rec["flops_per_device"] <= GATHER_AT_USE_TFLOP * 1e12 / 5
    assert rec["useful_compute_ratio"] >= 0.30
    assert rec["fits"] is True
