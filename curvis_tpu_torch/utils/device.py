"""Device checks shared by the factories and the render entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device a factory builds on: ``device`` when given, else the
    current CUDA device.  Without a card and without an explicit device
    this raises: nothing is quietly built on the CPU (pass
    ``device='cpu'`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def common_device(*items) -> torch.device:
    """The one device of ``items`` (tensors, metrics, cameras, images: any
    object with a ``device``; a metric without parameters has None and is
    skipped).  Raises ValueError when they lie on different devices."""
    devices = {torch.device(d) for d in (getattr(x, "device", None)
                                         for x in items) if d is not None}
    if len(devices) != 1:
        raise ValueError("inputs must lie on one device, got "
                         f"{sorted(str(d) for d in devices) or 'none'}")
    return devices.pop()
