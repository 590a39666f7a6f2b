"""Time the trainer's step on the card, for one package tree or two.

chip_smoke.py phase 15's model and step (internlm2-1.8b at full width
and depth, bf16 draws, AdamW, ``remat="full"``, 8 x 512 tokens), on
random tokens instead of the learned-index data path, so no kernel is
built.  Each step is timed with CUDA events: the whole ``train_step``
and its optimizer part (from the end of ``loss_and_grads`` to the end
of the step).  ``--src`` picks the directory whose ``repro_torch`` is
imported, so two trees can be timed on one card in one call:

    python scripts/train_step_time.py --src build/parent/src
    python scripts/train_step_time.py --src src --steps 12

Prints one JSON line: the tree, the card (``nvidia-smi``'s name and
power limit), each step's ms, optimizer ms and loss (one seed: two
trees with the same arithmetic give the same losses), the caching
allocator's retries and device allocations, and the medians of the
times over the steps after the first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ARCH = "internlm2-1.8b"     # chip_smoke.py's TRAIN_ARCH
BATCH, SEQ = 8, 512         # chip_smoke.py's TRAIN_BATCH, TRAIN_SEQ
SEED = 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    cfg = ARCHS[ARCH]
    model = build_model(cfg)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix="train_step_time_") as tmp:
        tr = Trainer(model, TrainConfig(total_steps=args.steps,
                                        warmup_steps=2, ckpt_dir=tmp),
                     None, device="cuda")
        state = tr.init_state(SEED)
        lg = tr.loss_and_grads
        marks = []

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def loss_and_grads(*a, **kw):
            out = lg(*a, **kw)
            marks.append(event())
            return out

        tr.loss_and_grads = loss_and_grads
        step_ms, opt_ms, losses = [], [], []
        for _ in range(args.steps):
            shape = (BATCH, SEQ)
            batch = tr.device_batch({
                "tokens": rng.integers(0, cfg.vocab, shape),
                "labels": rng.integers(0, cfg.vocab, shape),
                "mask": np.ones(shape, np.float32)})
            torch.cuda.synchronize()
            start = event()
            m = tr.train_step(state, batch)
            end = event()
            torch.cuda.synchronize()
            losses.append(float(m["loss"]))
            step_ms.append(start.elapsed_time(end))
            opt_ms.append(marks[-1].elapsed_time(end))
        tr.watchdog.close()
    print(json.dumps({
        "src": args.src, "card": smi, "arch": cfg.name,
        "tokens_per_step": BATCH * SEQ, "step_ms": step_ms,
        "optimizer_ms": opt_ms, "losses": losses,
        # the caching allocator's retries and cudaMalloc calls over the run
        "allocator": {k: torch.cuda.memory_stats().get(k) for k in (
            "num_alloc_retries", "num_device_alloc", "num_device_free")},
        "step_ms_p50": statistics.median(step_ms[1:]),
        "optimizer_ms_p50": statistics.median(opt_ms[1:])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
