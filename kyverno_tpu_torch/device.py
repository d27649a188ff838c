"""Device selection for the port's entry points.

Every entry point (``BatchScanner``, ``build_evaluator``) runs on the
CUDA card unless the caller names another device; there is no silent
fall back to the CPU, so a run that was meant for the card and finds no
card fails instead of measuring the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``torch.device`` for ``device``; ``None`` means the current CUDA
    card and raises ``RuntimeError`` when CUDA is unavailable.  No CUDA
    context is created here, so a caller may still fork worker
    processes afterwards."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'kyverno_tpu_torch runs on a CUDA device by default and '
                'torch.cuda.is_available() is False; pass device="cpu" '
                'to run on the host')
        return torch.device('cuda')
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {dev} requested but CUDA is unavailable')
    return dev
