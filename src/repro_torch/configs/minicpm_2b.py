"""minicpm-2b — WSD schedule, llama-like arch, tied embeddings.
[arXiv:2404.06395; hf].  36 heads (not divisible by the 16-way model
axis — GSPMD pads; see EXPERIMENTS.md roofline note)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", arch="lm",
    n_layers=40, d_model=2304, n_heads=36, n_kv=36, d_ff=5760, vocab=122_753,
    tie_embeddings=True,
)
