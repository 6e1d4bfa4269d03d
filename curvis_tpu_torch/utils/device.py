"""Device checks shared by the render entry points."""
from __future__ import annotations

import torch


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
