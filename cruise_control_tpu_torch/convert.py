"""Carrying state across: numpy <-> the port's tensor records.

The port's counterpart of "weights carried across": the reference's
ClusterState, OptimizationContext and RoundCache are pytrees of arrays;
a caller turns one into a dict of numpy arrays (``np.asarray(getattr(obj,
f))`` per field) and builds the port's record from it here.  This module
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.context import (CACHE_FIELDS,
                                                       CONTEXT_FIELDS,
                                                       OptimizationContext,
                                                       RoundCache)
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.state import STATE_FIELDS, ClusterState

#: static (non-tensor) fields of OptimizationContext
CONTEXT_STATIC = ("max_replicas_per_broker", "rf_max",
                  "fix_offline_replicas_only", "table_slots", "fast_mode",
                  "prebalance")


def _tensors(fields: Dict[str, np.ndarray], names, device) -> dict:
    dev = resolve_device(device)
    return {f: torch.from_numpy(np.array(fields[f], order="C")).to(dev)
            for f in names}


def _numpy(obj, names) -> Dict[str, np.ndarray]:
    return {f: getattr(obj, f).detach().cpu().numpy() for f in names}


def state_from_numpy(fields: Dict[str, np.ndarray], *, num_racks: int,
                     num_hosts: int, num_topics: int,
                     device=None) -> ClusterState:
    """ClusterState from a dict of numpy arrays named like its fields."""
    return ClusterState(**_tensors(fields, STATE_FIELDS, device),
                        num_racks=num_racks, num_hosts=num_hosts,
                        num_topics=num_topics)


def state_to_numpy(state: ClusterState) -> Dict[str, np.ndarray]:
    return _numpy(state, STATE_FIELDS)


def context_from_numpy(fields: Dict[str, np.ndarray], *, device=None,
                       **static) -> OptimizationContext:
    """OptimizationContext from numpy arrays plus its static fields
    (CONTEXT_STATIC) as keyword arguments."""
    unknown = set(static) - set(CONTEXT_STATIC)
    if unknown:
        raise TypeError(f"unknown context fields {sorted(unknown)}")
    return OptimizationContext(**_tensors(fields, CONTEXT_FIELDS, device),
                               **static)


def context_to_numpy(ctx: OptimizationContext) -> Dict[str, np.ndarray]:
    return _numpy(ctx, CONTEXT_FIELDS)


def cache_from_numpy(fields: Dict[str, np.ndarray],
                     device=None) -> RoundCache:
    return RoundCache(**_tensors(fields, CACHE_FIELDS, device))


def cache_to_numpy(cache: RoundCache) -> Dict[str, np.ndarray]:
    return _numpy(cache, CACHE_FIELDS)
