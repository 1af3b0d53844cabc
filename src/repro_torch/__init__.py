"""PyTorch/CUDA port of the RAGO serving stack (``repro``'s counterpart).

The port imports torch, numpy and the standard library -- never ``jax``
and nothing of the ``repro`` package.  Module paths mirror ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
