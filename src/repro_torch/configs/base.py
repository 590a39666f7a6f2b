"""Config dataclasses + the assigned input-shape sets."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: str                  # lm | encdec | zamba | xlstm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    remat: str = "full"        # none | full | dots
    scan_layers: bool = True
    # modality frontends (STUBS per assignment: precomputed embeddings)
    frontend: Optional[str] = None       # "vit" | "audio"
    n_frontend_tokens: int = 0
    d_frontend: int = 0
    # encoder (enc-dec archs)
    n_enc_layers: int = 0
    # hybrid (zamba)
    attn_every: int = 6
    # distribution hints
    fsdp: bool = False         # shard params/opt-state over the data axis
    optimizer: str = "adamw"   # adamw | adafactor
    moe_impl: str = "gspmd"    # gspmd | ep (shard_map all_to_all; §Perf)
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 4) * 4 // max(cfg.n_heads, 1)) or 2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        scan_layers=cfg.scan_layers,
        remat="none",
    )
    kw["n_kv"] = 2 if cfg.n_kv < cfg.n_heads else 4
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32)
    if cfg.arch == "encdec":
        kw["n_enc_layers"] = 2
    if cfg.frontend:
        kw["n_frontend_tokens"] = 8
        kw["d_frontend"] = 32
    if cfg.ssm_state:
        kw["ssm_state"] = 16
    if cfg.arch == "zamba":
        kw["attn_every"] = 1  # exercise the shared block even at 2 layers
    return dataclasses.replace(cfg, **kw)
