"""yi-9b — llama-arch GQA dense. [arXiv:2403.04652; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", arch="lm",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_ff=11_008, vocab=64_000,
    fsdp=True,
)
