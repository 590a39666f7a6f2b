"""The port's partitioning rules and abstract model shapes against the
reference's, in one process: ``pspec_for_axes`` / ``param_pspecs``
entry for entry for every config's ``logical_axes`` (with and without
``fsdp``, with and without the divisibility guard from
``abstract_params``) on duck-typed 16x16, 2x16x16 and small meshes;
``abstract_params``, ``input_specs`` and ``cache_specs`` shape and
dtype leaf for leaf; ``Sharding.placements``, ``input_shardings`` and
the constrainer.  The meshes themselves (``make_production_mesh``,
``make_mesh_for``) are built in subprocesses: the port's on a
``fake``-backend process group of 256 / 512 ranks, the reference's
over forced host devices."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
from repro.dist import partitioning as ref_part
from repro.models import build_model as ref_build
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.dist import partitioning as part
from repro_torch.models import build_model
from repro_torch.tree import leaf_paths

ROOT = Path(__file__).resolve().parents[1]


def duck_mesh(shape, names):
    """The reference tests' stand-in: ``axis_names`` + ``devices.shape``."""
    class Mesh:
        axis_names = names

        class devices:
            pass
    Mesh.devices.shape = shape
    return Mesh


MESHES = {
    "16x16": duck_mesh((16, 16), ("data", "model")),
    "2x16x16": duck_mesh((2, 16, 16), ("pod", "data", "model")),
    "2x4": duck_mesh((2, 4), ("data", "model")),
    "4x2": duck_mesh((4, 2), ("data", "model")),
    "1x1": duck_mesh((1, 1), ("data", "model")),
}


def dict_leaves(tree, path=()):
    """``[(path, leaf)]`` of a nested dict in key order (a logical-axes
    tuple, a spec or a sharding is a leaf)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(dict_leaves(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def ref_leaves(tree):
    """The reference's tree in JAX's order with tuple leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) or x is None
        or isinstance(x, jax.sharding.PartitionSpec))
    return [(tuple(_key(k) for k in p), v) for p, v in flat]


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return k


def ref_array_leaves(tree):
    """``[(path, ShapeDtypeStruct)]`` of a reference tree of arrays."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(_key(k) for k in p), v) for p, v in flat]


def dtype_name(d):
    return str(d).removeprefix("torch.")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logical_axes_and_abstract_params_equal_the_references(arch):
    ref, port = ref_build(REF_ARCHS[arch]), build_model(ARCHS[arch])
    assert ref_leaves(ref.logical_axes()) == dict_leaves(port.logical_axes())
    want = [(p, tuple(s.shape), str(s.dtype))
            for p, s in ref_leaves(ref.abstract_params())]
    got = [(p, tuple(t.shape), dtype_name(t.dtype))
           for p, t in dict_leaves(port.abstract_params())]
    assert got == want
    assert all(t.device.type == "meta"
               for _, t in dict_leaves(port.abstract_params()))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
def test_param_pspecs_equal_the_references_for_every_config(mesh, fsdp):
    m = MESHES[mesh]
    for arch in sorted(ARCHS):
        ref, port = ref_build(REF_ARCHS[arch]), build_model(ARCHS[arch])
        for guard in (False, True):
            kw = {"fsdp": fsdp}
            want = ref_part.param_pspecs(
                ref.logical_axes(), m,
                abstract_tree=ref.abstract_params() if guard else None, **kw)
            got = part.param_pspecs(
                port.logical_axes(), m,
                abstract_tree=port.abstract_params() if guard else None, **kw)
            w, g = ref_leaves(want), dict_leaves(got)
            assert [p for p, _ in w] == [p for p, _ in g], arch
            for (p, ws), (_, gs) in zip(w, g):
                assert isinstance(gs, part.PS)
                assert tuple(ws) == tuple(gs), (arch, p, guard)


AXES = [("embed", "heads", None), ("vocab", "embed"),
        ("experts", "embed", "ffn"), ("batch", None, "embed"),
        ("batch", None, "vocab"), ("layers", "embed", "kv", None),
        ("heads",), ("embed", "ffn"), (None, "batch"), ("batch",),
        ("experts", None, "ffn"), ("layers", "ffn", "embed")]
SHAPE_SETS = [None, (36, 64, 48), (64, 64, 64), (2, 30, 16), (512, 7, 32)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pspec_for_axes_equals_the_references(mesh):
    """The rules one tuple at a time, with the guard on shapes that do
    and do not divide, ``fsdp`` and the sequence axis."""
    m = MESHES[mesh]
    for axes in AXES:
        for shp in SHAPE_SETS:
            shape = None if shp is None else (shp * 2)[:len(axes)]
            for fsdp in (False, True):
                for seq in (None, "model"):
                    kw = dict(fsdp=fsdp, shape=shape, seq_axis=seq)
                    want = ref_part.pspec_for_axes(axes, m, **kw)
                    got = part.pspec_for_axes(axes, m, **kw)
                    assert tuple(want) == tuple(got), (axes, kw)


def test_reference_rule_cases_hold_on_the_port():
    """``tests/test_dist.py``'s rule cases, spelled for the port."""
    m11, m16 = MESHES["1x1"], MESHES["16x16"]
    assert part.pspec_for_axes(("embed", "heads", None), m11) == \
        (None, "model", None)
    assert part.pspec_for_axes(("experts", "embed", "ffn"), m11) == \
        ("model", None, None)
    assert part.pspec_for_axes(("embed", "ffn"), m11, fsdp=True) == \
        ("data", "model")
    assert part.pspec_for_axes(("heads",), m16, shape=(36,)) == (None,)
    assert part.pspec_for_axes(("heads",), m16, shape=(64,)) == ("model",)
    assert repr(part.PS(None, "model")) == "PS(None, 'model')"


def _shape_cases():
    return sorted(SHAPES)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_specs_equal_the_references(arch):
    ref, port = ref_build(REF_ARCHS[arch]), build_model(ARCHS[arch])
    for name in _shape_cases():
        want = ref.input_specs(REF_SHAPES[name])
        got = port.input_specs(SHAPES[name])
        assert sorted(want) == sorted(got)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert dtype_name(got[k].dtype) == str(want[k].dtype)
            assert got[k].device.type == "meta"
    want = ref_array_leaves(ref.cache_specs(3, 40))
    flat = [(p, tuple(t.shape), dtype_name(t.dtype), t.device.type)
            for p, t in leaf_paths(port.cache_specs(3, 40))]
    assert [(p, s, d) for p, s, d, _ in flat] == [
        (p, tuple(s.shape), str(s.dtype)) for p, s in want]
    assert {dev for *_, dev in flat} == {"meta"}


def test_input_shardings_shard_the_batch_dim_when_it_divides():
    m = MESHES["2x16x16"]
    specs = build_model(ARCHS["internvl2-2b"]).input_specs(SHAPES[
        sorted(SHAPES)[0]])
    out = part.input_shardings(specs, m)
    for k, t in specs.items():
        axes = ("batch",) + (None,) * (t.dim() - 1)
        want = ref_part.pspec_for_axes(axes, m, shape=tuple(t.shape))
        assert tuple(out[k].spec) == tuple(want)
        assert out[k].mesh is m


def test_placements_and_the_constrainer():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    s = part.Sharding(m, part.PS(("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    s = part.Sharding(m, part.PS(None, "data"))
    assert s.placements == (Replicate(), Shard(1), Replicate())
    constrain = part.activation_constrainer(m, fsdp=True)
    x = torch.ones(4, 8, 16)
    assert constrain(x, ("batch", None, "embed")) is x
    assert constrain.mesh is m


SUBPROCESS_PORT = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh
from repro_torch.dist.partitioning import batch_shard
out = {}
for world in (256, 512):
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)
    if world == 512:
        try:
            make_production_mesh(multi_pod=False, device="cpu")
        except Exception as e:
            out["extra_ranks"] = type(e).__name__
        m = make_production_mesh(multi_pod=True, device="cpu")
        out["multi"] = [list(m.shape), list(m.mesh_dim_names),
                        m.device_type, list(batch_shard(m))]
    else:
        m = make_production_mesh(device="cpu")
        out["single"] = [list(m.shape), list(m.mesh_dim_names),
                         m.device_type, list(batch_shard(m))]
        try:
            make_production_mesh(multi_pod=True, device="cpu")
        except ValueError as e:
            out["too_few"] = str(e)
    for n, mp in ((world, 1), (world, 16), (world, 7), (world, 1000)):
        m = make_mesh_for(n, mp, device="cpu")
        out[f"for_{n}_{mp}"] = [list(m.shape), list(m.mesh_dim_names)]
    dist.destroy_process_group()
try:
    make_mesh_for(4, 2, device="cpu")
except ValueError as e:
    out["no_group"] = str(e)
print(json.dumps(out))
"""

SUBPROCESS_REF = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.launch.mesh import make_mesh_for, make_production_mesh
out = {}
m = make_production_mesh(multi_pod=False)
out["single"] = [list(m.devices.shape), list(m.axis_names)]
m = make_production_mesh(multi_pod=True)
out["multi"] = [list(m.devices.shape), list(m.axis_names)]
for n in (256, 512):
    for mp in (1, 16, 7, 1000):
        m = make_mesh_for(n, mp)
        out[f"for_{n}_{mp}"] = [list(m.devices.shape), list(m.axis_names)]
print(json.dumps(out))
"""


def _run(code, env=None):
    done = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", **(env or {})})
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_meshes_have_the_references_shapes():
    port = _run(SUBPROCESS_PORT)
    ref = _run(SUBPROCESS_REF)
    assert port["single"][:2] == ref["single"] == [[16, 16],
                                                   ["data", "model"]]
    assert port["multi"][:2] == ref["multi"] == [
        [2, 16, 16], ["pod", "data", "model"]]
    assert port["single"][2] == port["multi"][2] == "cpu"
    # the last rank's rows: data coordinate 15 of 16; pod 1 data 15 of 32
    assert port["single"][3] == [15, 16]
    assert port["multi"][3] == [31, 32]
    for key, shape in ref.items():
        if key.startswith("for_"):
            assert port[key] == shape, key
    assert "512" in port["too_few"] and "256" in port["too_few"]
    assert "1" in port["no_group"] and "4" in port["no_group"]
