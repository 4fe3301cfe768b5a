"""SampleStore: durable metric samples reloaded at start-up (port of
cruise_control_tpu/monitor/sampling/sample_store.py).

A restarted instance recovers its load history from the store instead of
waiting num_windows x window_ms (Cruise Control's SampleStore.java).
`FileSampleStore` keeps a pair of append-only local files of
length-prefixed binary sample records (holder.py), compacted to the
retention on a cadence; its files are byte for byte the JAX package's,
so a store written by either package loads in the other.
"""
from __future__ import annotations

import abc
import logging
import os
import struct
import threading
import time as _time
from typing import Iterable, Optional

from cruise_control_tpu_torch.monitor.sampling.holder import (
    BrokerMetricSample, PartitionMetricSample)
from cruise_control_tpu_torch.monitor.sampling.sampler import Samples
from cruise_control_tpu_torch.utils import persist

LOG = logging.getLogger(__name__)

_LEN = struct.Struct("<I")


class SampleLoader(abc.ABC):
    """Callback receiving reloaded samples (reference
    SampleStore.SampleLoader)."""

    @abc.abstractmethod
    def load_samples(self, samples: Samples) -> None:
        ...


class SampleStore(abc.ABC):
    """reference SampleStore.java:1-91"""

    def configure(self, configs) -> None:  # pragma: no cover - plugin hook
        pass

    @abc.abstractmethod
    def store_samples(self, samples: Samples) -> None:
        ...

    @abc.abstractmethod
    def load_samples(self, loader: SampleLoader) -> None:
        ...

    def evict_samples_before(self, timestamp_ms: float) -> None:
        """Optional retention hook."""

    def close(self) -> None:  # pragma: no cover
        pass


class NoopSampleStore(SampleStore):
    """reference NoopSampleStore"""

    def store_samples(self, samples: Samples) -> None:
        pass

    def load_samples(self, loader: SampleLoader) -> None:
        pass


class FileSampleStore(SampleStore):
    """Length-prefixed binary record log per sample kind.

    Two files mirror the reference's two store topics
    (partition.metric.sample.store.topic / broker.metric.sample.store.topic,
    KafkaSampleStore.java:117-118).
    """

    PARTITION_FILE = "partition-samples.bin"
    BROKER_FILE = "broker-samples.bin"

    def __init__(self, directory: Optional[str] = None,
                 partition_retention_ms: Optional[float] = None,
                 broker_retention_ms: Optional[float] = None,
                 fsync: bool = False,
                 compaction_interval_ms: Optional[float] = None,
                 time_fn=None):
        #: directory may instead come from config via configure()
        #: (reference sample.store.* keys); files open lazily
        self._dir = directory
        self._partition_retention_ms = partition_retention_ms
        self._broker_retention_ms = broker_retention_ms
        #: fsync-on-store for journal-grade deployments (config key
        #: sample.store.fsync): samples survive a host crash, at the
        #: cost of one fsync per store call
        self._fsync = fsync
        #: how often store_samples applies retention ON DISK.  Without
        #: compaction the two files grow unbounded (retention used to
        #: be applied only at load); default: a quarter of the shortest
        #: configured retention
        self._compaction_interval_ms = compaction_interval_ms
        self._last_compaction_ms: Optional[float] = None
        self.compactions = 0
        self.evicted_samples = 0
        self._time = time_fn or _time.time
        self._lock = threading.Lock()
        self._pf = self._bf = None
        if directory:
            self._open()

    def configure(self, configs) -> None:
        """Plugin-style config hook (reference KafkaSampleStore.configure):
        reads sample.store.directory, the two *.sample.retention.ms
        keys, and sample.store.fsync when the store was instantiated
        via config."""
        if self._dir is None:
            self._dir = configs.get("sample.store.directory") or "cc-samples"
        for attr, key in (("_partition_retention_ms",
                           "partition.sample.retention.ms"),
                          ("_broker_retention_ms",
                           "broker.sample.retention.ms")):
            if getattr(self, attr) is None and configs.get(key):
                setattr(self, attr, float(configs[key]))
        if str(configs.get("sample.store.fsync", "")).lower() == "true":
            self._fsync = True
        if configs.get("sample.store.compaction.interval.ms"):
            self._compaction_interval_ms = float(
                configs["sample.store.compaction.interval.ms"])
        if self._pf is None:
            self._open()

    def _open(self) -> None:
        os.makedirs(self._dir, exist_ok=True)
        self._pf = open(os.path.join(self._dir, self.PARTITION_FILE), "ab")
        self._bf = open(os.path.join(self._dir, self.BROKER_FILE), "ab")

    def store_samples(self, samples: Samples) -> None:
        with self._lock:
            for s in samples.partition_samples:
                rec = s.to_bytes()
                self._pf.write(_LEN.pack(len(rec)) + rec)
            for s in samples.broker_samples:
                rec = s.to_bytes()
                self._bf.write(_LEN.pack(len(rec)) + rec)
            self._pf.flush()
            self._bf.flush()
            if self._fsync:
                os.fsync(self._pf.fileno())
                os.fsync(self._bf.fileno())
            self._maybe_compact_locked()

    @staticmethod
    def _read_records(path: str) -> Iterable[bytes]:
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                head = f.read(_LEN.size)
                if len(head) < _LEN.size:
                    return
                (n,) = _LEN.unpack(head)
                rec = f.read(n)
                if len(rec) < n:
                    LOG.warning("truncated sample record in %s; stopping "
                                "load", path)
                    return
                yield rec

    # ------------------------------------------------------------------
    # retention compaction (durability fix): retention used to apply
    # only at LOAD, so a long-lived process grew both files unbounded —
    # now store_samples compacts on the retention cadence via
    # rewrite-temp-then-rename (utils/persist.py), keeping the on-disk
    # footprint proportional to the retention window
    # ------------------------------------------------------------------
    def _maybe_compact_locked(self) -> None:
        retentions = [r for r in (self._partition_retention_ms,
                                  self._broker_retention_ms)
                      if r is not None]
        if not retentions:
            return
        interval = (self._compaction_interval_ms
                    if self._compaction_interval_ms is not None
                    and self._compaction_interval_ms > 0
                    else min(retentions) / 4.0)
        now_ms = self._time() * 1000.0
        if self._last_compaction_ms is not None \
                and now_ms - self._last_compaction_ms < interval:
            return
        self._last_compaction_ms = now_ms
        if self._partition_retention_ms is not None:
            self._compact_locked(
                self.PARTITION_FILE, PartitionMetricSample,
                now_ms - self._partition_retention_ms)
        if self._broker_retention_ms is not None:
            self._compact_locked(
                self.BROKER_FILE, BrokerMetricSample,
                now_ms - self._broker_retention_ms)

    def evict_samples_before(self, timestamp_ms: float) -> None:
        """Retention SPI hook: drop stored samples older than
        `timestamp_ms` from BOTH files, on disk, immediately."""
        with self._lock:
            if self._pf is None:
                return
            self._compact_locked(self.PARTITION_FILE,
                                 PartitionMetricSample, timestamp_ms)
            self._compact_locked(self.BROKER_FILE, BrokerMetricSample,
                                 timestamp_ms)

    def _compact_locked(self, filename: str, sample_cls,
                        cutoff_ms: float) -> None:
        """Rewrite one record log keeping only samples at/after the
        cutoff (and dropping unreadable records): stream old -> temp,
        atomic rename, reopen the append handle.  A crash at any point
        leaves either the old complete file or the new complete file."""
        path = os.path.join(self._dir, filename)
        handle_attr = ("_pf" if filename == self.PARTITION_FILE
                       else "_bf")
        kept = dropped = 0

        def surviving_chunks():
            nonlocal kept, dropped
            for rec in self._read_records(path):
                try:
                    sample = sample_cls.from_bytes(rec)
                except (ValueError, struct.error):
                    dropped += 1
                    continue
                if sample.sample_time_ms < cutoff_ms:
                    dropped += 1
                    continue
                kept += 1
                yield _LEN.pack(len(rec)) + rec

        old = getattr(self, handle_attr)
        old.flush()
        try:
            persist.atomic_rewrite(path, surviving_chunks(),
                                   fsync=self._fsync)
        except OSError as exc:
            LOG.warning("sample-store compaction of %s failed (%s); "
                        "keeping the uncompacted file", path, exc)
            return
        old.close()
        setattr(self, handle_attr, open(path, "ab"))
        if dropped:
            self.evicted_samples += dropped
            LOG.info("sample store: compacted %s (%d kept, %d "
                     "evicted)", filename, kept, dropped)
        self.compactions += 1

    def load_samples(self, loader: SampleLoader) -> None:
        batch = Samples()
        n_bad = 0
        n_expired = 0
        now_ms = self._time() * 1000.0
        p_cut = (now_ms - self._partition_retention_ms
                 if self._partition_retention_ms else None)
        b_cut = (now_ms - self._broker_retention_ms
                 if self._broker_retention_ms else None)
        for rec in self._read_records(
                os.path.join(self._dir, self.PARTITION_FILE)):
            try:
                sample = PartitionMetricSample.from_bytes(rec)
            except (ValueError, struct.error):
                n_bad += 1
                continue
            if p_cut is not None and sample.sample_time_ms < p_cut:
                n_expired += 1
                continue
            batch.partition_samples.append(sample)
        for rec in self._read_records(
                os.path.join(self._dir, self.BROKER_FILE)):
            try:
                sample = BrokerMetricSample.from_bytes(rec)
            except (ValueError, struct.error):
                n_bad += 1
                continue
            if b_cut is not None and sample.sample_time_ms < b_cut:
                n_expired += 1
                continue
            batch.broker_samples.append(sample)
        if n_bad:
            LOG.warning("skipped %d unreadable stored samples", n_bad)
        if n_expired:
            LOG.info("dropped %d stored samples past retention", n_expired)
        loader.load_samples(batch)
        LOG.info("loaded %d partition + %d broker samples from %s",
                 len(batch.partition_samples), len(batch.broker_samples),
                 self._dir)

    def close(self) -> None:
        with self._lock:
            if self._pf is not None:
                self._pf.close()
                self._bf.close()
