"""The explicit device rule: ``cuda`` or ``cpu``, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device`` ('cuda', 'cuda:N', 'cpu' or a
    ``torch.device``).  Asking for CUDA without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested, but torch sees no CUDA "
                "device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(use 'cuda' or 'cpu')")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU): the end of a timed section."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
