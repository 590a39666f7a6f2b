"""Model substrate of the port: the reference's ``repro.models`` in
torch, the training losses (differentiable by autograd, under the
remat policies of ``base.remat``) and the decode paths.

base.py      param specs + the shared layers (GQA, RoPE, MLP, norms)
moe.py       top-k capacity MoE (the scatter-dispatch implementation)
lm.py        decoder-only LM (dense/MoE) over stacked layers + KV cache
vlm.py       InternVL2 (stub ViT frontend) over the LM backbone
encdec.py    whisper-style encoder-decoder (stub audio frontend)
ssm.py       Mamba-2 (SSD) block: chunked form + decode recurrence
zamba.py     Zamba2 hybrid: Mamba-2 backbone + one shared attention block
xlstm.py     xLSTM cells: mLSTM (chunked + recurrent) and sLSTM
xlstm_lm.py  xLSTM-125M language model (7:1 mLSTM:sLSTM)
api.py       the ``Model`` facade the trainer and serving engine drive
"""

from .api import Model, build_model

__all__ = ["Model", "build_model"]
