"""Training launcher: the counterpart of ``repro.launch.train``.

An end-to-end run (real data pipeline + learned index + checkpoints +
watchdog) on the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --steps 20 --global-batch 8 --seq-len 512

``--device cpu --reduced`` runs a small same-family config on the CPU.
Every sample is resolved by key through the learned index
(``IndexedTokenDataset`` -> ``Index.lookup``).

``--mesh single|multi`` builds the reference's production mesh
(``launch/mesh.py``: (16, 16) or (2, 16, 16) ranks) and its activation
constrainer, and the trainer shards its state over it; each rank loads
its rows of every global batch.  Start one process a rank with the
process group's address, world size and rank in the environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``, as ``torchrun`` sets them); a group with fewer ranks
than the mesh raises the mesh's ``ValueError``.  Rank 0 alone writes
the checkpoints and every rank reads them: ``--ckpt-dir`` must then lie
on a filesystem every rank can read (the default lies under each
process's ``TMPDIR``: that holds only for ranks of one host sharing it).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..configs import ARCHS, reduced as reduce_cfg
from ..data import IndexedTokenDataset, PackedTokenStore, ShardedLoader
from ..device import resolve_device
from ..dist import activation_constrainer
from ..dist.partitioning import batch_shard
from ..launch.mesh import make_production_mesh
from ..models import build_model
from ..train import FailureInjector, TrainConfig, Trainer


def _init_process_group(dev) -> None:
    """Join the process group the environment describes (``env://``),
    one process a rank on its own card."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="yi-9b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU end-to-end)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-docs", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--ckpt-dir", default=TrainConfig().ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--index-method", default="pgm")
    ap.add_argument("--index-sample-rate", type=float, default=0.1)
    ap.add_argument("--index-gap-rho", type=float, default=0.15)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--inject-crash-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg)
    print(f"[train] arch={cfg.name} params={model.param_count():,}")

    # data: packed store + learned-index lookup (sampling + gaps per paper)
    store = PackedTokenStore.synthetic(
        args.n_docs, mean_len=args.seq_len + 1, vocab=cfg.vocab,
        seed=args.seed)
    dataset = IndexedTokenDataset.build(
        store, method=args.index_method,
        sample_rate=args.index_sample_rate, gap_rho=args.index_gap_rho,
        device=dev)
    print(f"[train] index: {args.index_method} "
          f"segments={dataset.index.mech.plm.n_segments} "
          f"build={dataset.index.build_seconds*1e3:.1f}ms")
    constrain, shard_id, n_shards = None, 0, 1
    if args.mesh != "none":
        _init_process_group(dev)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=dev)
        constrain = activation_constrainer(mesh, fsdp=cfg.fsdp)
        shard_id, n_shards = batch_shard(mesh)
    loader = ShardedLoader(dataset, global_batch=args.global_batch,
                           seq_len=args.seq_len, seed=args.seed,
                           shard_id=shard_id, n_shards=n_shards)

    injector = FailureInjector(
        {args.inject_crash_at: "crash"} if args.inject_crash_at >= 0 else {})
    tcfg = TrainConfig(
        total_steps=args.steps, peak_lr=args.lr, schedule=args.schedule,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        grad_compress=args.grad_compress,
        warmup_steps=max(2, args.steps // 20))
    trainer = Trainer(model, tcfg, loader, constrain=constrain,
                      failure_injector=injector, device=dev)
    out = trainer.run(seed=args.seed, resume=not args.no_resume)
    losses = [m["loss"] for m in out["metrics"]]
    print(f"[train] done: first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} "
          f"stragglers={len(out['straggler_events'])} on {dev}")
    return out


if __name__ == "__main__":
    main()
