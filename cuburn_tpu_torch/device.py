"""Explicit device resolution.

The port runs on a CUDA device unless the caller asks for the CPU by
name.  Nothing here, or anywhere in the package, moves work to the CPU
because a GPU is missing: `require_cuda` raises instead.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when PyTorch sees no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False.  "
            "Pass device='cpu' to run the plain PyTorch path on the CPU.")
    return torch.device("cuda")


def resolve_device(device: torch.device | str | None = None
                   ) -> torch.device:
    """`None` and any CUDA device require a GPU; "cpu" is the CPU.
    Other device types are refused."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
