"""zamba2-1.2b — Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch="zamba",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192, vocab=32_000,
    ssm_state=64, attn_every=6, subquadratic=True,
)
