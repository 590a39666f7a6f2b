"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM 2404.06395).

The counterpart of ``repro.optim.schedules``, op for op in f32.  The
step may be a Python int or a 0-d tensor (the optimizer's ``step``);
the result is a 0-d f32 tensor on the step's device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "wsd_schedule"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    final_frac=0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def wsd_schedule(step, *, peak_lr, warmup_steps, stable_steps, decay_steps,
                 final_frac=0.01):
    """Warmup -> Stable (constant) -> Decay (exponential-ish cosine tail)."""
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    in_decay = step > warmup_steps + stable_steps
    prog = torch.clamp((step - warmup_steps - stable_steps)
                       / max(decay_steps, 1), 0.0, 1.0)
    decay = peak_lr * torch.pow(torch.tensor(final_frac, dtype=torch.float32,
                                             device=step.device), prog)
    out = torch.where(step < warmup_steps, warm,
                      torch.full_like(step, peak_lr))
    return torch.where(in_decay, decay, out)
