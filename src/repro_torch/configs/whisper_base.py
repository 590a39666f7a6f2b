"""whisper-base — enc-dec; conv/audio frontend is a STUB per assignment
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", arch="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
    vocab=51_865, frontend="audio", n_frontend_tokens=1500, d_frontend=512,
)
