"""Replica-count distribution bounds (port of the `_count_bounds` helper
of cruise_control_tpu/analyzer/goals/count_distribution.py; the count
goals themselves belong to a later slice of the port)."""
from __future__ import annotations

import torch


def _count_bounds(avg: torch.Tensor, pct_margin: float):
    """Limits avg*(1±margin), at least one replica away from the
    average: (lower, upper)."""
    upper = torch.ceil(torch.maximum(avg * (1 + pct_margin), avg + 1))
    lower = torch.floor(torch.minimum(avg * (1 - pct_margin), avg - 1))
    return torch.clamp_min(lower, 0.0), upper
