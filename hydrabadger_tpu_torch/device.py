"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point's `device` argument.

    Raises RuntimeError when CUDA is asked for and this process has no
    usable card: the port never carries on on the CPU by itself.  The CPU
    runs only where the caller passes device="cpu" (the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false (no CUDA build of torch or no visible card); pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
