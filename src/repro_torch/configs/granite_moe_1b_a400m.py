"""granite-moe-1b-a400m — 32 experts top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", arch="lm",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49_155,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
)
