"""TTL-cached cluster metadata (port of
cruise_control_tpu/cluster/metadata.py): `ClusterSnapshot`s from a
`ClusterAdminClient`, refreshed when stale, each carrying the cluster's
generation.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from cruise_control_tpu_torch.cluster.admin import ClusterAdminClient
from cruise_control_tpu_torch.cluster.types import ClusterSnapshot


class MetadataClient:
    """Caches `ClusterSnapshot`s from a `ClusterAdminClient` with a TTL."""

    def __init__(self, admin: ClusterAdminClient,
                 metadata_ttl_ms: float = 5_000.0,
                 time_fn: Callable[[], float] = time.time):
        self._admin = admin
        self._ttl_s = metadata_ttl_ms / 1000.0
        self._time_fn = time_fn
        self._lock = threading.Lock()
        self._snapshot: Optional[ClusterSnapshot] = None
        self._fetched_at = -float("inf")

    def cluster(self) -> ClusterSnapshot:
        """Possibly-stale snapshot (refreshes if past TTL)."""
        with self._lock:
            if (self._snapshot is None
                    or self._time_fn() - self._fetched_at > self._ttl_s):
                self._refresh_locked()
            return self._snapshot

    def refresh_metadata(self) -> ClusterSnapshot:
        """Force a refresh (reference MetadataClient.refreshMetadata)."""
        with self._lock:
            self._refresh_locked()
            return self._snapshot

    @property
    def cluster_generation(self) -> int:
        return self.cluster().generation

    def _refresh_locked(self) -> None:
        self._snapshot = self._admin.describe_cluster()
        self._fetched_at = self._time_fn()
