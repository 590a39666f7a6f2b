"""Roofline analysis over dry-run cell records: the counterpart of
``repro.launch.roofline`` at one NVIDIA H100 SXM's constants.

Three terms per (arch × shape × mesh), all in seconds-per-step:

    compute    = FLOPs_per_device / peak_FLOPs              (989 TF bf16)
    memory     = bytes_per_device / HBM_bw                  (3.35 TB/s)
    collective = collective_bytes_per_device / link_bw      (50 GB/s IB)

The records are ``repro_torch.launch.dryrun``'s (one rank's counts of
the port's step on meta tensors) or the reference's (XLA's per-shard
cost analysis); the fields are the same.  MODEL_FLOPS uses 6·N·D
(train) / 2·N·D (inference) with N = active params (MoE-aware), giving
the useful-compute ratio that catches remat/redundancy waste.

Usage: python -m repro_torch.launch.roofline [--dir results/dryrun]
       [--md out.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

# NVIDIA H100 SXM data sheet
PEAK_FLOPS = 989e12     # bf16 dense (PERF.md's mfu uses the same)
HBM_BW = 3.35e12        # bytes/s, HBM3
# one 400 Gb/s NDR InfiniBand port per GPU, as in a DGX H100: each
# 16-wide mesh axis spans two or more 8-GPU nodes, so the inter-node
# link binds
LINK_BW = 50e9          # bytes/s per link
# the card's capacity for the dry run's ``fits``: what
# torch.cuda.get_device_properties(0).total_memory reads on an
# H100 80GB HBM3 (chip_smoke.py phase 17 asserts the two are equal)
HBM_BYTES = 85_017_493_504

SHAPE_TOKENS = {  # global tokens processed per step
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 1 * 128,
    "long_500k": 1 * 1,
}


def analyze_cell(rec: Dict) -> Dict:
    n_dev = rec.get("n_devices", 256)
    flops = rec.get("flops_per_device", 0.0)
    bytes_ = rec.get("bytes_per_device", 0.0)
    cbytes = rec.get("collective_bytes_per_device", 0)

    t_comp = flops / PEAK_FLOPS
    t_mem = bytes_ / HBM_BW
    t_coll = cbytes / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())

    tokens = SHAPE_TOKENS.get(rec["shape"], 0)
    n_active = rec.get("active_params", rec.get("params", 0))
    mult = 6 if rec["shape"].startswith("train") else 2
    model_flops_per_dev = mult * n_active * tokens / max(n_dev, 1)
    useful = model_flops_per_dev / flops if flops > 0 else 0.0
    # roofline fraction: useful work / time if running at the binding roof
    frac = (model_flops_per_dev / PEAK_FLOPS) / bound if bound > 0 else 0.0

    hints = {
        "compute": "compute-bound: raise MFU via larger per-device tiles "
                   "or reduced remat recompute",
        "memory": "memory-bound: cut bytes via fusion/remat policy, bf16 "
                  "intermediates, or KV/page layout",
        "collective": "collective-bound: reshard to cut all-gathers, "
                      "overlap comm/compute, or shard_map the MoE "
                      "dispatch into pure all-to-all",
    }
    return {
        **{k: rec.get(k) for k in ("arch", "shape", "mesh", "tag", "status")},
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_dev": model_flops_per_dev,
        "useful_compute_ratio": useful,
        "roofline_fraction": frac,
        "hint": hints[dominant],
        "collectives": rec.get("collectives", {}),
        "compile_s": rec.get("compile_s"),
    }


def load_cells(d: str, tag: str = None) -> List[Dict]:
    cells = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            rec = json.load(f)
        if rec.get("status") == "ok" and (tag is None or rec.get("tag") == tag):
            cells.append(analyze_cell(rec))
        elif rec.get("status") == "n/a":
            cells.append({**{k: rec.get(k) for k in
                             ("arch", "shape", "mesh", "tag", "status")},
                          "reason": rec.get("reason", "")})
    return cells


def to_markdown(cells: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful % | roofline % |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for c in cells:
        if c.get("status") == "n/a":
            rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                        f"— | — | — | N/A by design | — | — |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {c['t_compute_s']:.3e} | {c['t_memory_s']:.3e} "
            f"| {c['t_collective_s']:.3e} | **{c['dominant']}** "
            f"| {100*c['useful_compute_ratio']:.1f} "
            f"| {100*c['roofline_fraction']:.1f} |")
    return hdr + "\n".join(rows) + "\n"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--md", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    cells = load_cells(args.dir, tag=args.tag)
    md = to_markdown(cells)
    print(md)
    # summary: most interesting hillclimb candidates
    ok = [c for c in cells if c.get("status") != "n/a"
          and c.get("mesh") == "pod16x16"]
    if ok:
        worst = min(ok, key=lambda c: c["roofline_fraction"])
        coll = max(ok, key=lambda c: c["t_collective_s"])
        print(f"worst roofline fraction : {worst['arch']} x {worst['shape']}"
              f" ({100*worst['roofline_fraction']:.1f}%)")
        print(f"most collective-bound   : {coll['arch']} x {coll['shape']}"
              f" ({coll['t_collective_s']:.3e}s)")
    if args.md:
        with open(args.md, "w") as f:
            f.write(md)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(cells, f, indent=1)


if __name__ == "__main__":
    main()
