"""PyTorch/CUDA port of the DAS rollout engine (``repro``'s JAX package
is the reference it is tested against).

Module paths and public names follow ``repro`` so each counterpart is easy
to find. Entry points take an explicit ``device``: CUDA unless the caller
asks for the CPU, where every hand-written kernel's wrapper runs its plain
PyTorch version instead.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default. Raises when
    CUDA is asked for (explicitly or by default) and no card is visible —
    nothing silently moves to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' (or --device "
                "cpu) to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:  # "cuda" -> "cuda:N", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
