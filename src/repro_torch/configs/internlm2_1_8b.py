"""internlm2-1.8b — GQA dense. [arXiv:2403.17297; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", arch="lm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92_544,
)
