"""One run of one cell of ``BENCHMARK.json``.

The cell names a configuration and a traffic mix; the configuration's
file names its driver (``portbench/drivers/<driver>.py``), the mix is
``portbench/mixes/<traffic>.json`` and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Nothing here names a cell, a
configuration or a per-layer metric: a later cell, mix or metric is new
files and new entries.

A driver module has ``setup(run)`` (inputs from the seed, the system
built and warmed), ``window(run)`` (the measured window: it sets
``run.t_open``, ``run.attempted``, ``run.failed`` and the end-to-end
values it measures in ``run.e2e``; the harness adds ``setup_s`` and
``device_memory_peak_gb``), ``release(run)`` (the program's state
freed, its threads stopped) and ``check(run)`` (the comparison
with the plain reference: ``{name: (number, limit)}``).  A metric
module has ``read(run)``, which returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Optional

from . import trace as _trace

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The run's cards are not there."""


class Leaked(RuntimeError):
    """A forbidden package was loaded in the run's process."""


def load_module(path: Path):
    """A module of the benchmark found by file name (names hold dots)."""
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in str(path.relative_to(PB)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_entry(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric entry names ``cell`` (no ``workloads``: all)."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(man: dict, cell: str):
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in man["end_to_end"] if reports(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def leaked_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Run:
    """What one run knows: its cell, configuration, mix, seed, device,
    the drivers' records and the trace.  Drivers and metric readers
    share it."""

    def __init__(self, workload, config, mix, seed, seconds, trace,
                 device, control, t_start):
        self.workload = workload
        self.config = config
        self.mix = mix
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.control = control
        self.t_start = t_start
        self.tracer = _trace.Tracer(self.trace)
        self.span = self.tracer.span
        self.e2e = {}
        self.setup = {}       # set-up readings (build, freeze)
        self.layer = {}       # window readings the metric readers use
        self.attempted = 0
        self.failed = 0
        self.t_open = None

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")

    @property
    def events(self):
        return self.tracer.events


class Reservoir:
    """A uniform sample of at most ``capacity`` items from a stream of
    unknown length, drawn from ``rng`` (the answers a run checks)."""

    def __init__(self, capacity: int, rng):
        self.capacity = max(1, int(capacity))
        self.rng = rng
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.capacity:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.capacity:
            self.items[j] = item


def host_usage(t0: float, cpu0: float) -> dict:
    """This process's CPU seconds per second of the window, and its
    threads: the interpreter's, torch's intra-op pool's."""
    import threading
    import torch
    cpu = sum(os.times()[:2]) - cpu0
    return {"process_cores": cpu / max(time.perf_counter() - t0, 1e-9),
            "python_threads": threading.active_count(),
            "torch_threads": torch.get_num_threads()}


def host_probe() -> dict:
    """Seconds that fixed host work takes now: a Python loop and random
    reads of a 64 MB array (a reading of this machine's speed at the
    run's time, beside its numbers)."""
    import numpy as np
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i
    t1 = time.perf_counter()
    a = np.arange(1 << 23, dtype=np.float64)
    idx = np.random.default_rng(0).integers(0, a.size, 1 << 21)
    t2 = time.perf_counter()
    a[idx].sum()
    t3 = time.perf_counter()
    return {"probe_python_s": t1 - t0, "probe_gather_s": t3 - t2}


def memory_peak_gb(card_peak: int) -> float:
    """The run's peak memory on its device in GB: the card's (the CUDA
    allocator's peak over set-up and window), or, in a run on the CPU,
    the process's peak resident set."""
    if card_peak:
        return card_peak / 1e9
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def per_second(ends, t_open, seconds, weights=None) -> list:
    """Work completed in each second of the window (the last part-second
    left out): a reading of how steady the window ran."""
    n = int(seconds)
    out = [0] * n
    for k, t in enumerate(ends):
        i = int(t - t_open)
        if 0 <= i < n:
            out[i] += 1 if weights is None else weights[k]
    return out


def p95(values) -> Optional[float]:
    vals = sorted(values)
    if len(vals) < 20:
        return None
    return statistics.quantiles(vals, n=20, method="inclusive")[-1]


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", control: bool = False,
            overrides: Optional[dict] = None,
            after_setup: Optional[Callable] = None,
            t_start: Optional[float] = None, log=None) -> dict:
    """Run one cell once and return the result line's object.

    ``device="cpu"``, ``overrides`` (``{"config": {...}, "mix": {...}}``
    merged over the files) and ``after_setup`` (called with the run
    before the window, to plant a fault) serve the tests; ``control``
    puts the reference at float32 in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    man = manifest()
    cell = cell_entry(man, workload)
    cfg_entry = config_entry(man, cell["config"])
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(PB / "mixes" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    for part, base in (("config", config), ("mix", mix)):
        base.update((overrides or {}).get(part, {}))
    import torch
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise NoDevice(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {cell['chips']}")
    driver = load_module(PB / "drivers" / f"{config['driver']}.py")
    run = Run(workload, config, mix, seed, seconds, trace, device,
              control, t_start)
    if run.on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        driver.setup(run)
        if after_setup is not None:
            after_setup(run)
        h0 = (time.perf_counter(), sum(os.times()[:2]))
        with run.tracer:
            with run.span(_trace.WINDOW_SPAN):
                driver.window(run)
        run.layer.setdefault("info", {})["host"] = dict(
            host_usage(*h0), **host_probe())
        setup_s = run.t_open - t_start
        leaked = leaked_modules()
        if leaked:
            raise Leaked(f"loaded in the run's process: {leaked}")
        peak = torch.cuda.max_memory_allocated() if run.on_card else 0
        e2e, layer = cell_metrics(man, workload)
        metrics = {}
        if trace:
            for m in layer:
                reader = load_module(PB / "metrics" / f"{m['name']}.py")
                value = reader.read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
        else:
            values = dict(run.e2e, setup_s=setup_s,
                          device_memory_peak_gb=memory_peak_gb(peak))
            for m in e2e:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    finally:
        driver.release(run)
    checks = driver.check(run)
    correct = (run.attempted > 0 and run.failed == 0
               and all(v <= lim for v, lim in checks.values()))
    dev = {"platform": "gpu" if run.on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if run.on_card
                    else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.events is not None:
        ev = run.events
        dev["busy_s"] = ev.busy_us() / 1e6
        dev["window_s"] = ev.window_us / 1e6
        t0 = time.perf_counter()
        out["breakdown"] = {"device_ops": ev.top_device_ops(),
                            "idle_gaps": ev.idle_gaps()}
        run.tracer.seconds["reduce_s"] = time.perf_counter() - t0
    out["info"] = {"setup": run.setup, "window": run.layer.get("info", {}),
                   "trace": run.tracer.seconds}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    return out
