"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the host (or for
``"meta"``, which builds a model's parameters as shapes only): a
``"cuda"`` request needs a Hopper-class device (compute capability 9.0 or
newer, the sm_90a target the kernels are built for) and raises otherwise;
there is no silent fallback to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

MIN_CAPABILITY = (9, 0)


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(name)
    if dev.type in ("cpu", "meta"):   # meta: shapes only, nothing to run
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' (--device cpu) to run "
                           "on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(f"{torch.cuda.get_device_name(dev)} has compute "
                           f"capability {cap}; the port's kernels need "
                           f">= {MIN_CAPABILITY} (Hopper)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, which runs
    eagerly).  Timed regions end on this so they measure device time, not
    launch time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device: torch.device) -> str:
    """Name of what a measurement ran on, printed beside every number."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "host CPU"
