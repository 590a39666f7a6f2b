"""Build, load and launch the hand-written CUDA kernels (nvcc +
ctypes).

Each ``csrc/<name>.cu`` has a plain C entry point ``<name>_launch``.
It is compiled at first use into ``build/repro_torch/`` at the
repository root, into a file named by a hash of its source and flags,
and loaded with ``ctypes``.  Only sources in the repository are built.
``build()`` starts one ``nvcc`` per source, all at once, and waits for
them.

The wrappers' per-call host path goes through three helpers kept lean
because a small batch's kernel takes less time than its launch:
``check_1d`` (device, dtype, rank and contiguity of every tensor
argument), ``entry`` (the entry point with its ctypes signature, set
once) and ``launch`` (the call on the tensors' device and its current
stream, entering a device context only when that device is not the
current one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

__all__ = ["NVCC_FLAGS", "SOURCES", "build", "check_1d", "entry", "launch",
           "load", "ptxas_report"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

SOURCES = ("fused_lookup", "ingest_place", "gap_place", "lookup_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}
_reports: Dict[str, str] = {}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (all by default) that are not built
    yet, in parallel.  Returns ``{name: shared library path}``; raises
    ``RuntimeError`` with nvcc's output when a build fails."""
    names = tuple(SOURCES if names is None else names)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, tgt in targets.items():
        if tgt.exists():
            continue
        tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        _reports[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` output from this process's build of
    ``name`` ('' when the library was already built)."""
    return _reports.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def entry(name: str, signature: str, symbol: Optional[str] = None):
    """``<name>_launch`` (or ``symbol``) from ``csrc/<name>.cu`` with its
    argument types set once: ``signature`` has one letter per argument
    before the trailing stream (``p`` pointer, ``i`` int, ``f`` float);
    it returns the CUDA error code as an int."""
    symbol = symbol or f"{name}_launch"
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in signature] + [ctypes.c_void_p]
        _entries[symbol] = fn
    return fn


def launch(fn, dev: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``dev``'s current stream, inside a
    device context only when ``dev`` is not the current device;
    returns the entry point's CUDA error code."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    if idx == cur:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch.cuda.current_stream(idx).cuda_stream)


def check_1d(args: Sequence, names: Sequence[str],
             dtypes: Sequence[torch.dtype], first: str) -> torch.device:
    """The device of ``args[0]``; raises unless every argument is a 1-D
    contiguous tensor of its dtype on that device.  CUDA arguments take
    one combined test per tensor (``is_cuda`` and the device index name
    the device exactly); a failure, and any other device, goes through
    the test that names the fault."""
    t0 = args[0]
    if isinstance(t0, torch.Tensor) and t0.is_cuda:
        d = t0.get_device()
        for t, want in zip(args, dtypes):
            if not (isinstance(t, torch.Tensor) and t.dtype is want
                    and t.is_cuda and t.get_device() == d
                    and t.dim() == 1 and t.is_contiguous()):
                break
        else:
            return t0.device
    if not isinstance(t0, torch.Tensor):
        raise TypeError(f"{names[0]} must be a tensor")
    dev = t0.device
    for name, t, want in zip(names, args, dtypes):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {first} on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous")
    return dev
