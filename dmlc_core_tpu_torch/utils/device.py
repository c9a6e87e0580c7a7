"""Device resolution for the port's entry points.

The card is the default: an entry point called without ``device`` runs
on ``cuda`` and raises when no card is present.  The CPU is used only
when the caller asks for it by name (the CPU tests do).  No JAX
counterpart: JAX picks its backend globally.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .logging import DMLCError

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DMLCError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DMLCError(f"unsupported device {dev}")
    return dev
