"""Explicit device selection: CUDA by default, the CPU only by name."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu").

    A CUDA device that is not there raises instead of falling back: a
    run that silently moved to the CPU would report CPU numbers under a
    GPU's name."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but no CUDA device is available "
                "(torch.cuda.is_available() is False); pass --device cpu "
                "to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use cuda or cpu)")
    return dev
