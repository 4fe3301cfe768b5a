"""In-process simulated cluster (port of
cruise_control_tpu/cluster/simulated.py).

A full `ClusterAdminClient` whose state changes over time: reassignments
move data at a finite (throttleable) rate, leadership elections occur,
brokers die and return, disks fail.  It plays the role an embedded Kafka
plays in Cruise Control's own tests, so the executor's polling loops run
without external infrastructure.  Time is injectable (`time_fn`); without
one the cluster keeps a virtual clock that `advance()` moves.

Its snapshots and generations are the JAX package's, call for call.  What
differs is the bookkeeping, which keeps a 200,000-partition cluster cheap
to poll: the partitions with a reassignment in flight are indexed, so a
step or a reassignment listing visits only them, `describe_cluster`
keeps each partition's `PartitionInfo`, rebuilds only those that changed
since the last call (all of them after a broker or disk change) and
hands each snapshot a copy of its kept partition index, and
`describe_log_dirs` sums every broker's logdirs in one pass over the
partitions.
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set

from cruise_control_tpu_torch.cluster.admin import (ClusterAdminClient,
                                                    LivenessListener)
from cruise_control_tpu_torch.cluster.types import (BrokerInfo,
                                                    ClusterSnapshot,
                                                    LogDirInfo, PartitionInfo,
                                                    ReassignmentState,
                                                    TopicPartition,
                                                    indexed_snapshot)


class _Partition:
    __slots__ = ("tp", "index", "replicas", "leader", "logdir_by_broker",
                 "size_bytes", "leader_cpu", "nw_in", "nw_out", "target",
                 "moved_bytes", "move_total_bytes")

    def __init__(self, tp: TopicPartition, index: int, replicas: List[int],
                 leader: Optional[int], size_bytes: float):
        self.tp = tp
        #: creation order: the position in every snapshot
        self.index = index
        self.replicas = list(replicas)
        self.leader = leader
        self.logdir_by_broker: Dict[int, str] = {}
        self.size_bytes = size_bytes
        self.leader_cpu = 0.0
        self.nw_in = 0.0
        self.nw_out = 0.0
        # in-flight reassignment
        self.target: Optional[List[int]] = None
        self.moved_bytes = 0.0
        self.move_total_bytes = 0.0


class _Broker:
    __slots__ = ("info_id", "host", "rack", "alive", "logdirs",
                 "offline_logdirs", "throttle")

    def __init__(self, broker_id: int, host: str, rack: Optional[str],
                 logdirs: Sequence[str]):
        self.info_id = broker_id
        self.host = host
        self.rack = rack
        self.alive = True
        self.logdirs = list(logdirs) or ["/data/d0"]
        self.offline_logdirs: Set[str] = set()
        self.throttle: Optional[float] = None


class SimulatedCluster(ClusterAdminClient):
    """Thread-safe simulated cluster with finite-rate data movement."""

    DEFAULT_MOVE_RATE = 100e6  # bytes/s replication rate when unthrottled

    def __init__(self, time_fn: Optional[Callable[[], float]] = None,
                 move_rate_bytes_per_s: float = DEFAULT_MOVE_RATE):
        self._lock = threading.RLock()
        self._brokers: Dict[int, _Broker] = {}
        self._partitions: Dict[TopicPartition, _Partition] = {}
        #: the partitions with a reassignment in flight
        self._moving: Dict[TopicPartition, _Partition] = {}
        self._topic_configs: Dict[str, Dict[str, str]] = {}
        self._listeners: List[LivenessListener] = []
        self._generation = itertools.count(1)
        self._current_generation = 0
        self._move_rate = move_rate_bytes_per_s
        self._virtual_now: Optional[float] = 0.0 if time_fn is None else None
        self._time_fn = time_fn
        self._last_step = self._now()
        #: the partitions in creation order: a snapshot's order
        self._order: List[_Partition] = []
        # describe_cluster's kept answer: one PartitionInfo a partition
        # (in creation order) and the same by tp, the partitions changed
        # since, the brokers
        self._infos: List[Optional[PartitionInfo]] = []
        self._info_index: Dict[TopicPartition, PartitionInfo] = {}
        self._changed: Set[int] = set()
        self._all_changed = False
        self._broker_infos: Optional[tuple] = None

    # ------------------------------------------------------------------
    # time
    # ------------------------------------------------------------------
    def _now(self) -> float:
        if self._time_fn is not None:
            return self._time_fn()
        return self._virtual_now or 0.0

    def now_ms(self) -> float:
        return self._now() * 1000.0

    def advance(self, seconds: float) -> None:
        """Advance the virtual clock (no-op effect when using a real
        time_fn) and progress in-flight work."""
        with self._lock:
            if self._virtual_now is not None:
                self._virtual_now += seconds
        self._step()

    # ------------------------------------------------------------------
    # topology construction (test/demo setup surface)
    # ------------------------------------------------------------------
    def add_broker(self, broker_id: int, rack: Optional[str] = None,
                   host: Optional[str] = None,
                   logdirs: Sequence[str] = ("/data/d0",)) -> None:
        with self._lock:
            self._brokers[broker_id] = _Broker(
                broker_id, host or f"host{broker_id}", rack, logdirs)
            self._brokers_changed()
            self._bump()

    def create_topic(self, topic: str, assignments: Sequence[Sequence[int]],
                     size_bytes: float = 0.0,
                     configs: Optional[Mapping[str, str]] = None) -> None:
        """assignments[p] = replica list (index 0 = preferred leader)."""
        with self._lock:
            for p, replicas in enumerate(assignments):
                tp = TopicPartition(topic, p)
                old = self._partitions.get(tp)
                index = old.index if old is not None else len(self._order)
                part = _Partition(tp, index, list(replicas),
                                  replicas[0] if replicas else None,
                                  size_bytes)
                for b in replicas:
                    broker = self._brokers[b]
                    part.logdir_by_broker[b] = broker.logdirs[0]
                self._partitions[tp] = part
                self._moving.pop(tp, None)
                if old is None:
                    self._order.append(part)
                    self._infos.append(None)
                else:
                    self._order[index] = part
                self._changed.add(index)
            if configs:
                self._topic_configs[topic] = dict(configs)
            self._bump()

    def set_partition_load(self, tp: TopicPartition, *, leader_cpu: float = 0.0,
                           nw_in: float = 0.0, nw_out: float = 0.0,
                           size_bytes: Optional[float] = None) -> None:
        with self._lock:
            part = self._partitions[tp]
            part.leader_cpu = leader_cpu
            part.nw_in = nw_in
            part.nw_out = nw_out
            if size_bytes is not None:
                part.size_bytes = size_bytes

    # ------------------------------------------------------------------
    # fault injection (Cruise Control's executor and broker-failure tests
    # kill embedded brokers)
    # ------------------------------------------------------------------
    def kill_broker(self, broker_id: int) -> None:
        with self._lock:
            self._brokers[broker_id].alive = False
            for part in self._partitions.values():
                if part.leader == broker_id:
                    part.leader = next(
                        (b for b in part.replicas
                         if b != broker_id and self._brokers[b].alive), None)
            self._brokers_changed()
            self._bump()
            alive = {b.info_id for b in self._brokers.values() if b.alive}
            listeners = list(self._listeners)
        for fn in listeners:
            fn(alive)

    def restart_broker(self, broker_id: int) -> None:
        with self._lock:
            self._brokers[broker_id].alive = True
            for part in self._partitions.values():
                if part.leader is None and any(
                        b == broker_id for b in part.replicas):
                    part.leader = broker_id
            self._brokers_changed()
            self._bump()
            alive = {b.info_id for b in self._brokers.values() if b.alive}
            listeners = list(self._listeners)
        for fn in listeners:
            fn(alive)

    def fail_disk(self, broker_id: int, logdir: str) -> None:
        with self._lock:
            self._brokers[broker_id].offline_logdirs.add(logdir)
            self._brokers_changed()
            self._bump()

    # ------------------------------------------------------------------
    # ClusterAdminClient — observe
    # ------------------------------------------------------------------
    def describe_cluster(self) -> ClusterSnapshot:
        self._step()
        with self._lock:
            if self._broker_infos is None:
                self._broker_infos = tuple(
                    BrokerInfo(b.info_id, b.host, b.rack, b.alive,
                               tuple(LogDirInfo(d, offline=d in
                                                b.offline_logdirs)
                                     for d in b.logdirs))
                    for b in sorted(self._brokers.values(),
                                    key=lambda x: x.info_id))
            infos, order = self._infos, self._order
            for i in (range(len(order)) if self._all_changed
                      else self._changed):
                info = infos[i] = self._info(order[i])
                self._info_index[info.tp] = info
            self._changed.clear()
            self._all_changed = False
            alive_ids = sorted(b.info_id for b in self._brokers.values()
                               if b.alive)
            return indexed_snapshot(self._current_generation,
                                    self._broker_infos, tuple(infos),
                                    alive_ids[0] if alive_ids else None,
                                    dict(self._info_index))

    def _info(self, part: _Partition) -> PartitionInfo:
        brokers = self._brokers
        offline = tuple(
            b for b in part.replicas
            if not brokers[b].alive
            or part.logdir_by_broker.get(b) in brokers[b].offline_logdirs)
        in_sync = tuple(b for b in part.replicas if b not in offline)
        return PartitionInfo(part.tp, part.leader, tuple(part.replicas),
                             in_sync, offline, dict(part.logdir_by_broker))

    def describe_log_dirs(self, broker_ids: Sequence[int]
                          ) -> Dict[int, List[LogDirInfo]]:
        with self._lock:
            # one pass over the partitions for every broker: each
            # logdir's sum still adds its partitions in creation order
            used: Dict[int, Dict[str, float]] = {}
            for bid in broker_ids:
                b = self._brokers.get(bid)
                if b is not None and b.alive:
                    used[bid] = {d: 0.0 for d in b.logdirs}
            for part in self._partitions.values():
                for bid, d in part.logdir_by_broker.items():
                    dirs = used.get(bid)
                    if dirs is not None and d in dirs:
                        dirs[d] += part.size_bytes
            out: Dict[int, List[LogDirInfo]] = {}
            for bid in broker_ids:
                if bid in used:
                    b = self._brokers[bid]
                    out[bid] = [LogDirInfo(d, used_bytes=used[bid][d],
                                           offline=d in b.offline_logdirs)
                                for d in b.logdirs]
            return out

    def list_partition_reassignments(self) -> List[ReassignmentState]:
        self._step()
        with self._lock:
            out = []
            for part in sorted(self._moving.values(),
                               key=lambda p: p.index):
                adding = tuple(b for b in part.target
                               if b not in part.replicas)
                removing = tuple(b for b in part.replicas
                                 if b not in part.target)
                out.append(ReassignmentState(part.tp, adding, removing,
                                             tuple(part.target)))
            return out

    def topic_configs(self, topic: str) -> Mapping[str, str]:
        with self._lock:
            return dict(self._topic_configs.get(topic, {}))

    # ------------------------------------------------------------------
    # ClusterAdminClient — act
    # ------------------------------------------------------------------
    def alter_partition_reassignments(
            self, targets: Mapping[TopicPartition,
                                   Optional[Sequence[int]]]) -> None:
        self._step()
        with self._lock:
            for tp, target in targets.items():
                part = self._partitions.get(tp)
                if part is None:
                    raise KeyError(f"unknown partition {tp}")
                if target is None:  # cancel
                    part.target = None
                    part.moved_bytes = part.move_total_bytes = 0.0
                    self._moving.pop(tp, None)
                    continue
                target = list(target)
                unknown = [b for b in target if b not in self._brokers]
                if unknown:
                    raise KeyError(f"unknown brokers {unknown} for {tp}")
                new = [b for b in target if b not in part.replicas]
                part.target = target
                self._moving[tp] = part
                part.moved_bytes = 0.0
                part.move_total_bytes = part.size_bytes * len(new)
                for b in new:
                    part.logdir_by_broker.setdefault(
                        b, self._brokers[b].logdirs[0])
                self._changed.add(part.index)
                if not new:  # pure order change / shrink: instant
                    self._complete_move(part)
            self._bump()

    def elect_preferred_leaders(self, tps: Sequence[TopicPartition]) -> None:
        self._step()
        with self._lock:
            for tp in tps:
                part = self._partitions[tp]
                for b in part.replicas:
                    broker = self._brokers[b]
                    if broker.alive and part.logdir_by_broker.get(b) not in \
                            broker.offline_logdirs:
                        part.leader = b
                        break
                self._changed.add(part.index)
            self._bump()

    def alter_replica_log_dirs(
            self, moves: Mapping[TopicPartition, Mapping[int, str]]) -> None:
        with self._lock:
            for tp, by_broker in moves.items():
                part = self._partitions[tp]
                for bid, logdir in by_broker.items():
                    if logdir not in self._brokers[bid].logdirs:
                        raise ValueError(
                            f"broker {bid} has no logdir {logdir}")
                    part.logdir_by_broker[bid] = logdir
                self._changed.add(part.index)
            self._bump()

    def set_replication_throttle(self, broker_ids: Sequence[int],
                                 rate_bytes_per_s: float) -> None:
        with self._lock:
            for bid in broker_ids:
                self._brokers[bid].throttle = rate_bytes_per_s

    def clear_replication_throttle(self, broker_ids: Sequence[int]) -> None:
        with self._lock:
            for bid in broker_ids:
                self._brokers[bid].throttle = None

    # ------------------------------------------------------------------
    # ClusterAdminClient — watch
    # ------------------------------------------------------------------
    def add_liveness_listener(self, listener: LivenessListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def remove_liveness_listener(self, listener: LivenessListener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    # ------------------------------------------------------------------
    # data-movement simulation
    # ------------------------------------------------------------------
    def _effective_rate(self, part: _Partition) -> float:
        rates = [self._move_rate]
        for b in (part.target or []):
            if b not in part.replicas:
                t = self._brokers[b].throttle
                if t is not None:
                    rates.append(t)
        return min(rates)

    def _complete_move(self, part: _Partition) -> None:
        assert part.target is not None
        part.replicas = list(part.target)
        part.target = None
        self._moving.pop(part.tp, None)
        self._changed.add(part.index)
        part.moved_bytes = part.move_total_bytes = 0.0
        for b in list(part.logdir_by_broker):
            if b not in part.replicas:
                del part.logdir_by_broker[b]
        if part.leader not in part.replicas or part.leader is None or \
                not self._brokers[part.leader].alive:
            part.leader = next(
                (b for b in part.replicas if self._brokers[b].alive), None)

    def _step(self) -> None:
        with self._lock:
            now = self._now()
            dt = max(0.0, now - self._last_step)
            self._last_step = now
            if dt == 0.0:
                return
            changed = False
            for part in list(self._moving.values()):
                # replication to a dead destination makes no progress
                if any(b not in self._brokers or not self._brokers[b].alive
                       for b in part.target if b not in part.replicas):
                    continue
                part.moved_bytes += self._effective_rate(part) * dt
                if part.moved_bytes >= part.move_total_bytes:
                    self._complete_move(part)
                    changed = True
            if changed:
                self._bump()

    def _brokers_changed(self) -> None:
        """A broker's liveness, logdirs or existence changed: every
        partition's offline replicas may have."""
        self._broker_infos = None
        self._all_changed = True

    def _bump(self) -> None:
        self._current_generation = next(self._generation)
