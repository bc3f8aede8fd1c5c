"""Device selection for the port's entry points.

`device=None` means the card. Without one an entry point raises: it never
falls back to the CPU. Callers that want the plain versions on the CPU ask
for `device="cpu"`, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions")
    return dev
