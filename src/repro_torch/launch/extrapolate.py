"""Per-layer cost extrapolation: the counterpart of
``repro.launch.extrapolate`` over the port's dry-run records (and over
measured times and peaks of reduced-depth runs on the card).

Costs of a homogeneous layer stack are affine in depth:
    cost(L) = outside + L * per_layer
Two reduced-depth counts (tags ``L<a>``/``L<b>``) pin the line; the
full-depth record is synthesized exactly (``extrapolated`` flag set,
both probe points kept for audit).

Usage:
  python -m repro_torch.launch.extrapolate --arch qwen1.5-32b \\
      --shape train_4k --mesh pod16x16 --a 4 --b 8 [--dir results/dryrun]
"""

from __future__ import annotations

import argparse
import json
import os

LINEAR_FIELDS = (
    "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
    "collective_ops", "temp_size_in_bytes", "argument_size_in_bytes",
    "output_size_in_bytes", "alias_size_in_bytes", "peak_bytes",
)


def at_depth(ra, rb, a: int, b: int, L: int, fields=LINEAR_FIELDS):
    """The affine law through ``ra`` (depth ``a``) and ``rb`` (depth
    ``b``) at depth ``L``, for each of ``fields`` both records hold."""
    out = {}
    for f in fields:
        if f not in ra or f not in rb:
            continue
        per_layer = (rb[f] - ra[f]) / (b - a)
        outside = ra[f] - a * per_layer
        out[f] = outside + L * per_layer
    return out


def extrapolate(d: str, arch: str, shape: str, mesh: str, a: int, b: int,
                prefix: str = ""):
    def load(tag):
        path = os.path.join(d, f"{arch}__{shape}__{mesh}__{tag}.json")
        with open(path) as f:
            rec = json.load(f)
        assert rec["status"] == "ok", (path, rec.get("error"))
        return rec

    ra, rb = load(f"{prefix}L{a}"), load(f"{prefix}L{b}")
    from repro_torch.configs import ARCHS
    L = ARCHS[arch].n_layers

    out = dict(rb)
    out["tag"] = prefix.rstrip("_") if prefix else "baseline"
    out["layers_used"] = L
    out["extrapolated"] = True
    out["probe_layers"] = [a, b]
    out.update(at_depth(ra, rb, a, b, L))
    cd = {}
    for k in set(ra.get("collectives", {})) | set(rb.get("collectives", {})):
        va, vb = ra["collectives"].get(k, 0), rb["collectives"].get(k, 0)
        per_layer = (vb - va) / (b - a)
        cd[k] = va - a * per_layer + L * per_layer
    out["collectives"] = cd
    # param counts from the full model
    from repro_torch.models import build_model
    m = build_model(ARCHS[arch])
    out["params"] = m.param_count()
    out["active_params"] = m.active_param_count()

    suffix = f"__{prefix.rstrip('_')}" if prefix else ""
    path = os.path.join(d, f"{arch}__{shape}__{mesh}{suffix}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[extrapolate] {arch} x {shape} x {mesh}: "
          f"flops/dev={out['flops_per_device']:.3e} "
          f"coll/dev={out['collective_bytes_per_device']:.3e} "
          f"(from L={a},{b} -> L={L})")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--a", type=int, default=4)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--prefix", default="",
                    help="probe-tag prefix, e.g. 'ep_' for ep_L4/ep_L8")
    args = ap.parse_args()
    extrapolate(args.dir, args.arch, args.shape, args.mesh, args.a, args.b,
                prefix=args.prefix)


if __name__ == "__main__":
    main()
