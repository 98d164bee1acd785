"""Where the port's tensors live.

Every entry point that makes tensors (``make_state``, ``make_initial_fields``,
``convert.state_from_numpy``, the driver) runs on the card unless the caller
asks for the CPU, and resolves its device here: a CUDA device that is not
there is an error, never a silent switch to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    torch sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' (--device cpu) to run "
                           "on the CPU")
    return dev
