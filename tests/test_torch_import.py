"""The port stands alone: ``import repro_torch`` loads neither JAX nor
the reference package, no port file imports them, and the default
device is CUDA — without it the entry points raise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.convert, repro_torch.kernels.delta\n"
        "import repro_torch.kernels.gap_place, repro_torch.kernels.ops_gap\n"
        "import repro_torch.serving, repro_torch.robustness\n"
        "import repro_torch.train, repro_torch.core.tuning\n"
        "import repro_torch.dist.sharded, repro_torch.kernels.shard_fanout\n"
        "import repro_torch.data, repro_torch.serving.kv_cache\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.train.train_loop\n"
        "import repro_torch.train.fault, repro_torch.train.checkpoint\n"
        "import repro_torch.dist, repro_torch.dist.partitioning\n"
        "import repro_torch.launch.mesh, repro_torch.train.elastic\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "import repro_torch.launch.extrapolate\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[p.relative_to(ROOT).as_posix()
                              for p in PORT_FILES])
def test_no_port_file_imports_jax_or_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import Index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Index.build(np.arange(100, dtype=np.float64), gap_rho=0.1)
    assert resolve_device("cpu").type == "cpu"


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """``fused_lookup`` picks the plain version only for CPU tensors:
    anything else goes to the kernel launch (or raises)."""
    from repro_torch.kernels import lookup as lk
    called = []
    monkeypatch.setattr(lk, "fused_lookup_plain",
                        lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(lk, "_launch",
                        lambda *a, **k: called.append("kernel"))
    monkeypatch.setattr(lk, "_check", lambda *a, **k: torch.device("cuda"))
    lk.fused_lookup(*([torch.zeros(1)] * 18), q_tile=32, w_tile=2048,
                    flat_w=8, max_chain=0, n_slots=10, key_wide=False,
                    wide=False)
    assert called == ["kernel"]


@pytest.mark.parametrize("wrapper", ["gap_place", "lookup_kernel"])
def test_cuda_tensor_never_reaches_the_new_plain_versions(monkeypatch,
                                                          wrapper):
    """The Eq. 3 and legacy-lookup wrappers take their plain versions
    only for CPU tensors: a CUDA tensor goes to the kernel's build and
    launch, which raises here (no nvcc), and the count stays."""
    from repro_torch.kernels import _build, gap_place as gp, lookup as lk
    mod, check = ((gp, "_check_gap") if wrapper == "gap_place"
                  else (lk, "_check_legacy"))
    fn = getattr(mod, wrapper)
    called = []
    monkeypatch.setattr(mod, f"{wrapper}_plain",
                        lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(mod, check, lambda *a, **k: torch.device("cuda"))

    def no_build(name):
        called.append(name)
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(_build, "load", no_build)
    launches = fn.launches
    n_args = 5 if wrapper == "gap_place" else 6
    with pytest.raises(RuntimeError, match="no nvcc"):
        fn(*([torch.zeros(1)] * n_args))
    assert called == [wrapper] and fn.launches == launches


def test_dry_run_imports_the_fake_backend_only_inside_functions():
    """``launch/dryrun.py`` starts its ``fake`` group in its CLI and
    ``run_cell``: no module-level import reaches ``torch.testing``."""
    path = ROOT / "src" / "repro_torch" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import)
             for a in n.names] + [n.module or "" for n in top
                                  if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.startswith("torch.testing")
                or m.startswith("torch.distributed")]
    inner = [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n not in top]
    assert "torch.testing._internal.distributed.fake_pg" in inner
