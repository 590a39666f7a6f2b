"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on ``cuda`` unless the
caller asks for the CPU by name.  Without CUDA the default raises: no
entry point carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` / ``"cuda[:i]"`` as given;
    ``"meta"`` (shapes and dtypes without data: the models' abstract
    params and cache specs) as given.

    Raises ``RuntimeError`` when a CUDA device is wanted (the default
    included) and ``torch.cuda.is_available()`` is False.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
