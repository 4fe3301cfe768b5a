"""Durable executor journal (port of cruise_control_tpu/executor/journal.py):
a crash-safe write-ahead log of execution state.

An append-only, CRC-framed, fsync-on-commit JSONL log plus a small
atomically rewritten history file, both under one journal directory.

Write path (single writer: the caller thread of `execute_proposals` and
the executor's runnable append, never at once):

* `start`   — uuid, reason, full proposals, caps, strategy chain,
  removed/demoted brokers, throttle; rotates to a fresh segment and
  deletes the settled older segments (the start record is
  self-contained).
* `task`    — every task state transition, keyed by the task's stable
  key, with its re-execution count.
* `phase`   — executor phase changes.
* `throttle` / `throttle-clear` — replication-throttle application and
  removal.
* `finish`  — the terminal record; with it there is nothing to recover.

A journal write or fsync failure never fails the rebalance: the journal
marks itself broken, counts the error, fires `on_error` once and the
execution carries on journal-less.  Sites `executor.journal.write` and
`executor.journal.fsync` make such failures scriptable (utils/faults.py).

Replay (`ExecutionJournal.replay`) reads every segment in order,
truncates a torn tail at the first bad record, and returns the last
execution's journaled state for executor/recovery.py to reconcile
against live cluster metadata.  Records are byte for byte the JAX
package's, so either package replays the other's journal.
"""
from __future__ import annotations

import dataclasses
import glob
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.proposals import (ExecutionProposal,
                                                         ReplicaPlacement)
from cruise_control_tpu_torch.model.topology import PartitionId
from cruise_control_tpu_torch.utils import faults, persist

LOG = logging.getLogger(__name__)

_SEGMENT_PREFIX = "journal-"
_SEGMENT_SUFFIX = ".jsonl"
_HISTORY_FILE = "history.json"
DEFAULT_SEGMENT_MAX_BYTES = 4 * 1024 * 1024


def proposal_record(p: ExecutionProposal) -> dict:
    """Full round-trippable serialization of one proposal (`to_json`
    drops logdirs and sizes, which resume needs)."""
    return {
        "topic": p.partition.topic,
        "partition": p.partition.partition,
        "oldLeader": p.old_leader,
        "old": [[r.broker_id, r.logdir] for r in p.old_replicas],
        "new": [[r.broker_id, r.logdir] for r in p.new_replicas],
        "size": p.partition_size,
    }


def proposal_from_record(d: dict) -> ExecutionProposal:
    return ExecutionProposal(
        partition=PartitionId(d["topic"], d["partition"]),
        old_leader=d["oldLeader"],
        old_replicas=tuple(ReplicaPlacement(b, ld) for b, ld in d["old"]),
        new_replicas=tuple(ReplicaPlacement(b, ld) for b, ld in d["new"]),
        partition_size=d.get("size", 0.0))


@dataclasses.dataclass
class JournalReplay:
    """What the journal says about the LAST execution it recorded."""

    #: the last `start` record (None: journal empty / never executed)
    start: Optional[dict] = None
    #: stable task key -> last `task` record for that key
    tasks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    #: last journaled executor phase
    phase: Optional[str] = None
    #: True when a `finish` record followed the last `start`
    finished: bool = False
    #: brokers with an applied-but-never-cleared replication throttle
    throttle_brokers: List[int] = dataclasses.field(default_factory=list)
    #: a torn tail / corrupt record truncated the replay somewhere
    truncated: bool = False
    #: total records replayed across segments
    records: int = 0
    segments: int = 0

    @property
    def in_flight(self) -> bool:
        """An execution was journaled and never finished."""
        return self.start is not None and not self.finished

    def proposals(self) -> List[ExecutionProposal]:
        if self.start is None:
            return []
        return [proposal_from_record(d)
                for d in self.start.get("proposals", [])]


class ExecutionJournal:
    """See module docstring.  One instance per executor; the directory
    is its scope."""

    def __init__(self, directory: str,
                 segment_max_bytes: int = DEFAULT_SEGMENT_MAX_BYTES,
                 fsync: bool = True,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        import time as _time
        self.directory = directory
        self._segment_max_bytes = max(4096, int(segment_max_bytes))
        self._fsync = fsync
        self._time = time_fn or _time.time
        self._fh = None
        self._segment_path: Optional[str] = None
        self._segment_bytes = 0
        #: degraded: a write failed — journal-less from here on
        self.broken = False
        self.writes = 0
        self.bytes_written = 0
        self.errors = 0
        #: fired once on the first write failure (the facade counts and
        #: keeps it); never raises into the executor
        self.on_error: Optional[Callable[[BaseException], None]] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    # segment management
    # ------------------------------------------------------------------
    def _segment_paths(self) -> List[str]:
        return sorted(glob.glob(os.path.join(
            self.directory, f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}")))

    def _next_segment_path(self) -> str:
        existing = self._segment_paths()
        if existing:
            last = os.path.basename(existing[-1])
            n = int(last[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]) + 1
        else:
            n = 1
        return os.path.join(
            self.directory, f"{_SEGMENT_PREFIX}{n:06d}{_SEGMENT_SUFFIX}")

    def _open_segment(self, path: str) -> None:
        if self._fh is not None:
            self._fh.close()
        self._fh = persist.open_append(path)
        self._segment_path = path
        self._segment_bytes = os.path.getsize(path)
        # the new segment's DIRECTORY ENTRY must be durable too: a
        # record fsync makes the data durable, but after power loss a
        # file whose dir entry never committed does not exist — replay
        # would find only the previous execution's segments
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        if not self._fsync:
            return
        try:
            persist.fsync_dir(self.directory)
        except OSError as exc:
            LOG.warning("journal: directory fsync failed: %s", exc)

    def _rotate(self, drop_older: bool) -> None:
        """Open a fresh segment; with `drop_older`, delete the settled
        previous segments AFTER the new one exists (a crash in between
        leaves both, and replay's last-start-wins handles it).  The
        directory is fsynced after both steps so neither the new
        segment nor the deletions can be lost to power failure."""
        older = self._segment_paths()
        self._open_segment(self._next_segment_path())
        if drop_older:
            for path in older:
                try:
                    os.unlink(path)
                except OSError as exc:
                    LOG.warning("journal: could not drop settled "
                                "segment %s: %s", path, exc)
            self._fsync_dir()

    # ------------------------------------------------------------------
    # the write path
    # ------------------------------------------------------------------
    def _write(self, record: dict) -> None:
        faults.inject("executor.journal.write")
        if self._fh is None or self._segment_bytes >= self._segment_max_bytes:
            if self._fh is None:
                self._open_segment(self._next_segment_path())
            else:
                self._rotate(drop_older=False)
        line = persist.json_frame(record)
        self._fh.write(line)
        self._fh.flush()
        if self._fsync:
            faults.inject("executor.journal.fsync")
            os.fsync(self._fh.fileno())
        self._segment_bytes += len(line)
        self.writes += 1
        self.bytes_written += len(line)

    def _commit(self, record: dict) -> None:
        """Append one record, degrading to journal-less on failure —
        a sick disk must never fail the rebalance it was auditing."""
        if self.broken:
            return
        try:
            self._write(record)
        except Exception as exc:  # noqa: BLE001 - degrade, never fail
            self.broken = True
            self.errors += 1
            LOG.error(
                "executor journal write failed (%s: %s); continuing "
                "JOURNAL-LESS — a crash from here on will not be "
                "recoverable", type(exc).__name__, exc)
            cb = self.on_error
            if cb is not None:
                try:
                    cb(exc)
                except Exception:  # noqa: BLE001 - reporting best-effort
                    LOG.exception("journal on_error callback failed")

    # ------------------------------------------------------------------
    # events
    # ------------------------------------------------------------------
    def log_start(self, uuid: str, reason: str,
                  proposals: Sequence[ExecutionProposal],
                  caps: dict, strategy_names: Sequence[str],
                  removed_brokers: Sequence[int],
                  demoted_brokers: Sequence[int],
                  throttle: Optional[float],
                  resumed: bool = False) -> None:
        if self.broken:
            return
        try:
            # a new start settles everything before it: fresh segment
            # first, then drop the old ones (replay survives a crash
            # between the two)
            self._rotate(drop_older=True)
        except Exception as exc:  # noqa: BLE001 - degrade, never fail
            self.broken = True
            self.errors += 1
            LOG.error("executor journal rotation failed (%s: %s); "
                      "continuing journal-less", type(exc).__name__, exc)
            cb = self.on_error
            if cb is not None:
                try:
                    cb(exc)
                except Exception:  # noqa: BLE001
                    LOG.exception("journal on_error callback failed")
            return
        self._commit({
            "t": "start", "uuid": uuid, "reason": reason,
            "ts": self._time() * 1000.0,
            "proposals": [proposal_record(p) for p in proposals],
            "caps": dict(caps),
            "strategy": list(strategy_names),
            "removed": sorted(removed_brokers),
            "demoted": sorted(demoted_brokers),
            "throttle": throttle,
            "resumed": resumed,
        })

    def log_task(self, uuid: Optional[str], key: str, state: str,
                 now_ms: float, reexecution_count: int = 0) -> None:
        self._commit({"t": "task", "uuid": uuid, "key": key,
                      "state": state, "ts": now_ms,
                      "reexec": reexecution_count})

    def log_phase(self, uuid: Optional[str], phase: str) -> None:
        self._commit({"t": "phase", "uuid": uuid, "phase": phase,
                      "ts": self._time() * 1000.0})

    def log_throttle(self, uuid: Optional[str], brokers: Sequence[int],
                     rate: float) -> None:
        self._commit({"t": "throttle", "uuid": uuid,
                      "brokers": list(brokers), "rate": rate,
                      "ts": self._time() * 1000.0})

    def log_throttle_cleared(self, uuid: Optional[str],
                             brokers: Sequence[int]) -> None:
        self._commit({"t": "throttle-clear", "uuid": uuid,
                      "brokers": list(brokers),
                      "ts": self._time() * 1000.0})

    def log_finish(self, uuid: Optional[str], succeeded: bool,
                   message: str) -> None:
        self._commit({"t": "finish", "uuid": uuid,
                      "succeeded": succeeded, "message": message,
                      "ts": self._time() * 1000.0})

    # ------------------------------------------------------------------
    # removal/demotion history (atomically rewritten, not appended:
    # it is small and latest-wins)
    # ------------------------------------------------------------------
    def save_history(self, removed: Dict[int, float],
                     demoted: Dict[int, float]) -> None:
        try:
            persist.atomic_write_json(
                os.path.join(self.directory, _HISTORY_FILE),
                {"removed": {str(k): v for k, v in removed.items()},
                 "demoted": {str(k): v for k, v in demoted.items()}},
                fsync=self._fsync)
        except Exception as exc:  # noqa: BLE001 - degrade, never fail
            self.errors += 1
            LOG.warning("executor history write failed (%s: %s); "
                        "removal/demotion history will not survive a "
                        "restart", type(exc).__name__, exc)

    def load_history(self) -> tuple:
        import json
        path = os.path.join(self.directory, _HISTORY_FILE)
        try:
            with open(path) as fh:
                doc = json.load(fh)
            return ({int(k): float(v)
                     for k, v in (doc.get("removed") or {}).items()},
                    {int(k): float(v)
                     for k, v in (doc.get("demoted") or {}).items()})
        except FileNotFoundError:
            return {}, {}
        except (OSError, ValueError) as exc:
            LOG.warning("executor history unreadable (%s); starting "
                        "with empty removal/demotion history", exc)
            return {}, {}

    # ------------------------------------------------------------------
    # replay
    # ------------------------------------------------------------------
    def replay(self) -> JournalReplay:
        """Read-only scan of every segment in order (call BEFORE this
        process writes).  Last `start` wins; task records are keyed by
        stable key with the last record per key retained; a torn tail
        truncates the segment it appears in at the first bad record."""
        out = JournalReplay()
        paths = self._segment_paths()
        out.segments = len(paths)
        throttle_brokers: List[int] = []
        for path in paths:
            records, truncated = persist.read_crc_json(path)
            if truncated:
                out.truncated = True
                LOG.warning(
                    "journal segment %s has a torn/corrupt tail; "
                    "replay truncated at record %d", path, len(records))
            for rec in records:
                out.records += 1
                t = rec.get("t")
                if t == "start":
                    out.start = rec
                    out.tasks = {}
                    out.phase = None
                    out.finished = False
                    throttle_brokers = []
                elif out.start is None:
                    continue      # orphan records before any start
                elif rec.get("uuid") != out.start.get("uuid"):
                    continue
                elif t == "task":
                    out.tasks[rec["key"]] = rec
                elif t == "phase":
                    out.phase = rec.get("phase")
                elif t == "throttle":
                    throttle_brokers = list(rec.get("brokers", []))
                elif t == "throttle-clear":
                    throttle_brokers = []
                elif t == "finish":
                    # deliberately does NOT clear throttle_brokers: a
                    # finished execution whose throttle-clear call
                    # failed still leaks throttles, and recovery must
                    # see them
                    out.finished = True
        out.throttle_brokers = throttle_brokers
        return out

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError as exc:
                LOG.warning("journal close failed: %s", exc)
            self._fh = None

    def to_json(self) -> dict:
        return {
            "directory": self.directory,
            "broken": self.broken,
            "writes": self.writes,
            "bytesWritten": self.bytes_written,
            "errors": self.errors,
        }
