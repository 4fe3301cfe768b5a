"""Device resolution for the port.

No argument (or ``"cuda"``) means the CUDA card, and a machine without
one raises: no code path of the port carries on on the CPU when it finds
no GPU.  Only an explicit ``device="cpu"`` runs on the CPU (the tests do
that).  This is also the one place that pins float32 matmuls to full
precision: the rack-feasibility product of the pre-balance
(analyzer/prebalance.py) must stay exact.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """torch.device for `device`; None or "cuda" is the card, and raises
    RuntimeError when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cruise_control_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
