"""Serving launcher: batched requests through the paged-KV engine whose
block table is the gapped learned index.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --requests 8 --max-new 16

runs on the card (any config with a decode path: the dense and MoE
LMs, the VLM and enc-dec, ``zamba2-1.2b``, ``xlstm-125m``);
``--device cpu --reduced`` runs a small same-family config on the CPU.
Params are random, from ``--seed``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, reduced as reduce_cfg
from ..device import resolve_device
from ..models import build_model
from ..serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg)
    if model.decode_fn is None:
        raise SystemExit(f"{cfg.name} has no decode path")

    dev = resolve_device(args.device)
    engine = ServingEngine(model, max_batch=args.max_batch,
                           max_len=args.max_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    engine.load(model.init_params(gen, dev))

    rng = np.random.default_rng(args.seed)
    for rid in range(1, args.requests + 1):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 24),
                              dtype=np.int32)
        engine.submit(Request(request_id=rid, prompt=prompt,
                              max_new_tokens=args.max_new))
    stats = engine.run_until_done()
    stats.update(engine.kv_pages.insert_path_stats())
    print(f"[serve] decoded={stats['decoded_tokens']} tokens in "
          f"{stats['rounds']} rounds ({stats['wall_s']:.2f}s); "
          f"page_lookups={stats['page_lookups']} "
          f"kv_util={engine.kv_pages.utilization:.2f} on {dev}")
    return stats


if __name__ == "__main__":
    main()
