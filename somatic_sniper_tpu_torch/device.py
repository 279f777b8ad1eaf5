"""Explicit device selection: CUDA by default, the CPU only by name.

The module imports torch inside ``resolve_device``: the CLI imports it
to catch ``DeviceUnavailable``, and an all-host exact run never resolves
a device at all.
"""

from __future__ import annotations


class DeviceUnavailable(RuntimeError):
    """A CUDA device was named and none is present."""


def resolve_device(name):
    """``torch.device`` for ``name`` ("cuda", "cuda:N", "cpu", or a
    ``torch.device``).

    A CUDA device that is not there raises instead of falling back: a
    run that silently moved to the CPU would report CPU numbers under a
    GPU's name.  Callers resolve at the first point a path needs a
    device, so a run that needs none (exact precision scored by the
    native host layer) starts on a machine without a card."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                f"device {str(name)!r} requested but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "--device cpu to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (use cuda or cpu)")
    return dev
