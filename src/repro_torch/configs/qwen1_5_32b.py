"""qwen1.5-32b — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", arch="lm",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27_392, vocab=152_064,
    qkv_bias=True, fsdp=True,
)
