"""kimi-k2-1t-a32b — trillion-param MoE (paper-table config).
[arXiv:2501.kimi2; unverified]
1T params do not fit one 256-chip v5e pod with fp32 Adam; config selects
Adafactor + FSDP (see DESIGN.md §4) and targets the 512-chip 2-pod mesh."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch="lm",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048, vocab=163_840,
    head_dim=112,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048),
    fsdp=True, optimizer="adafactor",
)
