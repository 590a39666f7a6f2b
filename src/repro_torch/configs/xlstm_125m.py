"""xlstm-125m — sLSTM + mLSTM blocks (7:1 ratio). [arXiv:2405.04517]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", arch="xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50_304,
    subquadratic=True,
)
