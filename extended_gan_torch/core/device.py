"""Where the port's tensors live.

The port is written for an NVIDIA GPU: every entry point defaults to the
CUDA card and raises when there is none, so a run that was meant for the
card never slips onto the CPU unnoticed. The CPU is used only when the
caller asks for it (the CPU tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for (the default) but torch sees none; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
