"""Model substrate of the port: the decode paths of the reference's
``repro.models`` in torch.

base.py      param specs + the shared layers (GQA, RoPE, MLP, norms)
moe.py       top-k capacity MoE (the scatter-dispatch implementation)
lm.py        decoder-only LM (dense/MoE) over stacked layers + KV cache
vlm.py       InternVL2 (stub ViT frontend) over the LM backbone
encdec.py    whisper-style encoder-decoder (stub audio frontend)
api.py       the ``Model`` facade the serving engine drives

The zamba (Mamba-2) and xLSTM families wait for ROADMAP A13b.
"""

from .api import Model, build_model

__all__ = ["Model", "build_model"]
