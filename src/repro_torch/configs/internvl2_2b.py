"""internvl2-2b — InternViT (STUB frontend: precomputed patch embeddings)
+ InternLM2-2B backbone. [arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", arch="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_ff=8192, vocab=92_553,
    frontend="vit", n_frontend_tokens=256, d_frontend=1024,
)
