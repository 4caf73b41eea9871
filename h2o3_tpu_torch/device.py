"""Which device the port's entry points run on.

The card by default. A caller asks for another device explicitly, per call
(``device=``) or per process (:func:`set_device`, which the CPU tests call
in a fixture). There is no silent fallback: with no card and no request,
:func:`resolve_device` raises.
"""

from __future__ import annotations

import torch

_default: torch.device | None = None


def set_device(device: str | torch.device | None) -> None:
    """Set the process-wide default device (``None`` restores the card)."""
    global _default
    _default = None if device is None else torch.device(device)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    :func:`set_device` default, else the CUDA card — which must exist."""
    if device is not None:
        return torch.device(device)
    if _default is not None:
        return _default
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' or call "
            "h2o3_tpu_torch.set_device('cpu') to run on the CPU")
    return torch.device("cuda")
