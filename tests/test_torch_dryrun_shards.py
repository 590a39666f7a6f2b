"""The port's dry run holds the reference's per-device shards.

One subprocess forces 512 host devices (as ``tests/test_moe_ep.py``
does) and prints, leaf by leaf, ``NamedSharding.shard_shape`` of the
reference's own shardings: ``param_shardings``, ``input_shardings``,
``launch.dryrun._cache_shardings`` and the optimizer mirror of
``src/repro/launch/dryrun.py:125-149`` (copied below), without lowering
anything.  Another runs ``repro_torch.launch.dryrun.build_step`` in a
``fake`` group of 256 / 512 ranks and prints the local shape of every
argument leaf a rank holds.  Six cells on both meshes: whisper-base x
decode_32k, internlm2-1.8b x train_4k (AdamW), kimi-k2-1t-a32b x
train_4k (Adafactor, FSDP), qwen1.5-32b x prefill_32k, zamba2-1.2b x
long_500k (the long-context path: the cache's sequence over "data") and
internvl2-2b x prefill_32k (the cache's length plus the frontend).

Params, batch, caches, AdamW's ``m`` / ``v`` and Adafactor's ``m``,
1-d ``v`` and factored ``vr`` / ``vc`` are equal leaf for leaf: the
factored moments are sharded by their param's spec less the dim each
drops (``optim.FACTORED_SLOTS``), as the reference's dry run places
them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("whisper-base", "decode_32k"), ("internlm2-1.8b", "train_4k"),
         ("kimi-k2-1t-a32b", "train_4k"), ("qwen1.5-32b", "prefill_32k"),
         ("zamba2-1.2b", "long_500k"), ("internvl2-2b", "prefill_32k")]

REFERENCE = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.configs import ARCHS, SHAPES
from repro.dist import input_shardings, param_pspecs, param_shardings
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.optim import OPTIMIZERS


def shards(tree, shardings):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sh = jax.tree.leaves(shardings,
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(flat) == len(sh)
    return [[jax.tree_util.keystr(p), list(leaf.shape),
             list(s.shard_shape(leaf.shape)), leaf.dtype.itemsize]
            for (p, leaf), s in zip(flat, sh)]


out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    repl = NamedSharding(mesh, PS())
    for arch, shape_name in json.loads(sys.argv[1]):
        cfg, shape = ARCHS[arch], SHAPES[shape_name]
        model = build_model(cfg)
        laxes = model.logical_axes()
        aparams = model.abstract_params()
        rec = {"params": shards(aparams, param_shardings(
            laxes, mesh, fsdp=cfg.fsdp, abstract_tree=aparams))}
        binput = model.input_specs(shape)
        rec["batch"] = shards(binput, input_shardings(binput, mesh))
        if shape.kind == "train":
            # src/repro/launch/dryrun.py:125-149
            pshard_flat = param_pspecs(laxes, mesh, fsdp=cfg.fsdp,
                                       abstract_tree=aparams)
            def mirror(tree):
                return jax.tree.map(
                    lambda ps: NamedSharding(mesh, ps), tree,
                    is_leaf=lambda x: isinstance(x, PS))
            if cfg.optimizer == "adamw":
                oshard = {"m": mirror(pshard_flat), "v": mirror(pshard_flat),
                          "step": repl}
            else:
                def slot_shard(ps, sds):
                    if len(sds.shape) >= 2:
                        t = tuple(ps) + (None,) * (len(sds.shape)
                                                   - len(tuple(ps)))
                        return {
                            "vr": NamedSharding(mesh, PS(*t[:-1])),
                            "vc": NamedSharding(mesh, PS(*t[:-2], t[-1])),
                            "m": NamedSharding(mesh, ps),
                        }
                    return {"v": NamedSharding(mesh, ps),
                            "m": NamedSharding(mesh, ps)}
                oshard = {
                    "slots": jax.tree.map(slot_shard, pshard_flat, aparams,
                                          is_leaf=lambda x: isinstance(x, PS)),
                    "step": repl,
                }
            aopt = OPTIMIZERS[cfg.optimizer][0](aparams, abstract=True)
            rec["opt"] = shards(aopt, oshard)
        else:
            acache = model.cache_specs(shape.global_batch,
                                       dryrun._cache_len(cfg, shape))
            rec["cache"] = shards(acache, dryrun._cache_shardings(
                acache, mesh, cfg, shape))
        out[f"{arch}|{shape_name}|{int(multi)}"] = rec
print(json.dumps(out))
"""

PORT = r"""
import json, sys
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.dist.partitioning import local_shard
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.tree import leaf_paths


def local(tree):
    return [["/".join(map(str, p)), list(t.shape),
             list(local_shard(t).shape), t.element_size()]
            for p, t in leaf_paths(tree)]


out = {}
for multi in (False, True):
    with dryrun.fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        for arch, shape_name in json.loads(sys.argv[1]):
            shape = SHAPES[shape_name]
            model = build_model(ARCHS[arch])
            step, args = dryrun.build_step(model, shape, mesh)
            whole = model.input_specs(shape)
            if shape.kind == "train":
                state, batch = args
                rec = {"params": local(state["params"]),
                       "opt": local(state["opt"])}
            else:
                batch = args[1]
                rec = {"params": local(args[0]), "cache": local(args[2])}
            # the rank's rows beside the whole batch's shape
            rec["batch"] = [[k, list(whole[k].shape), list(batch[k].shape),
                             batch[k].element_size()] for k in sorted(batch)]
            out[f"{arch}|{shape_name}|{int(multi)}"] = rec
print(json.dumps(out))
"""


def _run(code, env):
    r = subprocess.run([sys.executable, "-c", code, json.dumps(CELLS)],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    return _run(PORT, env), _run(REFERENCE, env)


def _bytes(shape, itemsize):
    return int(np.prod(shape)) * itemsize


@pytest.mark.parametrize("multi", [0, 1], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("cell", CELLS, ids=["|".join(c) for c in CELLS])
def test_argument_shards_equal_the_references(both, cell, multi):
    port, ref = both
    key = f"{cell[0]}|{cell[1]}|{multi}"
    got, want = port[key], ref[key]
    assert sorted(got) == sorted(want)
    for tree in want:
        assert len(got[tree]) == len(want[tree]), tree
        for (p, shape, local, _), (q, rshape, rlocal, _) in zip(
                got[tree], want[tree]):
            assert shape == rshape, (tree, p, q)
            assert local == rlocal, (tree, p, q)
    sharded = sum(_bytes(local, n) for t in got.values()
                  for _, _, local, n in t)
    assert 0 < sharded


def test_adafactor_factored_moments_kept_whole(both):
    """kimi-k2's factored moments on both meshes: every ``vr`` / ``vc``
    shard equals the reference's, so a rank holds no byte of them beyond
    the reference's shards (kept whole they were 3,351,524,640 bytes
    more a rank), and each is split where its param is."""
    port, ref = both
    extra = {}
    for multi in (0, 1):
        key = f"kimi-k2-1t-a32b|train_4k|{multi}"
        got = dict((p, (local, n)) for p, _, local, n in port[key]["opt"])
        diff, factored, split = 0, 0, 0
        for (p, shape, local, n), (_, _, rlocal, _) in zip(
                port[key]["opt"], ref[key]["opt"]):
            if p.endswith("/vr") or p.endswith("/vc"):
                assert local == rlocal, p
                diff += _bytes(local, n) - _bytes(rlocal, n)
                factored += 1
                split += local != shape
        assert got and factored > 0
        assert diff == 0
        # each of them split but the stacked norms' row moments
        # (``ln_attn`` / ``ln_mlp`` are (layers, embed): ``vr`` drops
        # the one split dim and is the whole (61,))
        assert split == factored - 2
        extra[multi] = diff
    print(json.dumps({"kimi_vr_vc_extra_bytes": extra}))
