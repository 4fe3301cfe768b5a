"""CPU-side models (port of cruise_control_tpu/model/cpu_model.py): the
trainable linear CPU model and the host-side (numpy) fallback solver, the
bottom rung of the solver degradation ladder.

`LinearRegressionCpuModel` models broker CPU utilization as a linear
function of leader-bytes-in, leader-bytes-out and follower (replication)
bytes-in rates (Cruise Control's LinearRegressionModelParameters.java and
ModelUtils.java); training is one batched least-squares fit over the
sample matrix (`np.linalg.lstsq`, with the JAX package's three-step
refit), and the fitted coefficients then drive the follower-CPU
attribution of the monitor's model build.

`host_fallback_solve` is what the facade falls back to when both device
rungs (the goal pipeline, the eager per-goal driver) are failing: numpy
only, no device work, and scoped to the one thing that must never be
unavailable — relocating offline replicas off dead brokers and broken
disks (analyzer/degradation.py)."""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Optional

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource


@dataclasses.dataclass(frozen=True)
class CpuModelCoefficients:
    """CPU% contributed per byte/s of each traffic kind."""

    leader_bytes_in: float
    leader_bytes_out: float
    follower_bytes_in: float

    def estimate_leader_cpu(self, leader_nw_in: float, leader_nw_out: float
                            ) -> float:
        return (self.leader_bytes_in * leader_nw_in
                + self.leader_bytes_out * leader_nw_out)

    def estimate_follower_cpu(self, follower_nw_in: float) -> float:
        return self.follower_bytes_in * follower_nw_in


class LinearRegressionCpuModel:
    """Accumulates (cpu, leader_in, leader_out, replication_in) training
    rows and fits coefficients on demand."""

    MIN_SAMPLES = 8

    def __init__(self, cpu_util_bucket_size_pct: int = 5,
                 min_num_cpu_util_buckets: int = 5,
                 required_samples_per_bucket: int = 10) -> None:
        self._lock = threading.Lock()
        self._rows: list = []
        self._coefficients: Optional[CpuModelCoefficients] = None
        #: training-readiness knobs (reference
        #: linear.regression.model.cpu.util.bucket.size /
        #: .min.num.cpu.util.buckets / .required.samples.per.bucket:
        #: samples are bucketed by CPU utilization and the fit waits for
        #: coverage, so one load level cannot dominate the coefficients)
        self._bucket_size_pct = max(1, cpu_util_bucket_size_pct)
        self._min_buckets = max(1, min_num_cpu_util_buckets)
        self._required_per_bucket = max(1, required_samples_per_bucket)

    def training_coverage(self) -> tuple:
        """(filled buckets, required buckets) — a bucket counts once it
        holds required_samples_per_bucket samples."""
        from collections import Counter
        with self._lock:
            counts = Counter(int(r[0] // self._bucket_size_pct)
                             for r in self._rows)
        filled = sum(1 for c in counts.values()
                     if c >= self._required_per_bucket)
        return filled, self._min_buckets

    @property
    def ready_to_train(self) -> bool:
        filled, need = self.training_coverage()
        return filled >= need

    # ------------------------------------------------------------------
    def add_sample(self, cpu_pct: float, leader_bytes_in: float,
                   leader_bytes_out: float,
                   replication_bytes_in: float) -> None:
        with self._lock:
            self._rows.append((cpu_pct, leader_bytes_in, leader_bytes_out,
                               replication_bytes_in))

    def clear_samples(self) -> None:
        """Drop accumulated training rows (callers that re-feed the full
        history each training round must clear first, or rows duplicate)."""
        with self._lock:
            self._rows.clear()

    @property
    def num_samples(self) -> int:
        with self._lock:
            return len(self._rows)

    @property
    def trained(self) -> bool:
        with self._lock:
            return self._coefficients is not None

    @property
    def coefficients(self) -> Optional[CpuModelCoefficients]:
        with self._lock:
            return self._coefficients

    # ------------------------------------------------------------------
    def train(self) -> CpuModelCoefficients:
        """Non-negative least squares fit (coefficients are physical rates,
        so negatives are clamped and refit without that feature —
        the reference likewise guards against nonsensical coefficients)."""
        with self._lock:
            rows = np.asarray(self._rows, dtype=np.float64)
        if rows.shape[0] < self.MIN_SAMPLES:
            raise ValueError(
                f"need >= {self.MIN_SAMPLES} training samples, "
                f"have {rows.shape[0]}")
        y = rows[:, 0]
        X = rows[:, 1:4]
        active = [0, 1, 2]
        coef = np.zeros(3)
        for _ in range(3):
            sol, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
            if (sol >= 0).all():
                for i, a in enumerate(active):
                    coef[a] = sol[i]
                break
            # drop the most negative feature and refit
            worst = active[int(np.argmin(sol))]
            active = [a for a in active if a != worst]
            if not active:
                break
        result = CpuModelCoefficients(*coef)
        with self._lock:
            self._coefficients = result
        return result

    def training_error(self) -> Optional[float]:
        """RMS error of the fit over the training rows."""
        with self._lock:
            coefs = self._coefficients
            rows = np.asarray(self._rows, dtype=np.float64)
        if coefs is None or rows.shape[0] == 0:
            return None
        pred = (coefs.leader_bytes_in * rows[:, 1]
                + coefs.leader_bytes_out * rows[:, 2]
                + coefs.follower_bytes_in * rows[:, 3])
        return float(np.sqrt(np.mean((pred - rows[:, 0]) ** 2)))


def _leader_bonus_rows(part, bonus):
    """bonus[part], clamped as device indexing clamps: padding replica
    rows may carry out-of-range partition ids, and a windowless model can
    have no partition."""
    if bonus.shape[0] == 0:
        return np.zeros((part.shape[0], bonus.shape[1]))
    return bonus[np.minimum(part, bonus.shape[0] - 1)]


def _host_stats(valid, part, broker, leader, base_load, bonus, cap, alive,
                topic_of_partition, num_topics, offline):
    """The statistics of model/stats.py over host arrays (float64, each
    rounded to float32 at the end), so a fallback result reports like
    any other."""
    from cruise_control_tpu_torch.model.stats import ClusterModelStats

    num_brokers = cap.shape[0]
    load_r = (base_load + leader[:, None]
              * _leader_bonus_rows(part, bonus)) * valid[:, None]
    bload = np.zeros((num_brokers, NUM_RESOURCES), dtype=np.float64)
    np.add.at(bload, broker[valid], load_r[valid])
    util = bload / np.maximum(cap, 1e-9)

    def masked(values):
        count = max(int(alive.sum()), 1)
        sel = values[alive] if alive.any() else np.zeros(1)
        avg = float(values[alive].sum()) / count if alive.any() else 0.0
        var = float(((sel - avg) ** 2).sum()) / count
        return (np.float32(avg), np.float32(sel.max(initial=-np.inf)),
                np.float32(sel.min(initial=np.inf)),
                np.float32(np.sqrt(var)))

    avg = np.zeros(NUM_RESOURCES, np.float32)
    vmax = np.zeros(NUM_RESOURCES, np.float32)
    vmin = np.zeros(NUM_RESOURCES, np.float32)
    vstd = np.zeros(NUM_RESOURCES, np.float32)
    for res in range(NUM_RESOURCES):
        avg[res], vmax[res], vmin[res], vstd[res] = masked(util[:, res])

    rcount = np.zeros(num_brokers, dtype=np.float64)
    np.add.at(rcount, broker[valid], 1.0)
    lcount = np.zeros(num_brokers, dtype=np.float64)
    np.add.at(lcount, broker[valid & leader], 1.0)
    rc = masked(rcount)
    lc = masked(lcount)

    tcount = np.zeros((num_brokers, max(num_topics, 1)), dtype=np.float64)
    if valid.any() and topic_of_partition.shape[0]:
        topic_rows = topic_of_partition[np.minimum(
            part[valid], topic_of_partition.shape[0] - 1)]
        np.add.at(tcount, (broker[valid], topic_rows), 1.0)
    n_alive = max(int(alive.sum()), 1)
    t_avg = tcount[alive].sum(axis=0) / n_alive
    t_var = ((tcount[alive] - t_avg[None, :]) ** 2).sum(axis=0) / n_alive
    topic_std = np.float32(np.sqrt(t_var).mean())

    pot = np.zeros(num_brokers, dtype=np.float64)
    nw_out_as_leader = ((base_load[:, Resource.NW_OUT]
                         + _leader_bonus_rows(part, bonus)[:,
                                              Resource.NW_OUT]) * valid)
    np.add.at(pot, broker[valid], nw_out_as_leader[valid])
    pot_sel = pot[alive] if alive.any() else np.zeros(1)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype)

    return ClusterModelStats(
        util_avg=t(avg), util_max=t(vmax), util_min=t(vmin),
        util_std=t(vstd),
        replica_count_avg=t(rc[0]), replica_count_max=t(rc[1]),
        replica_count_min=t(rc[2]), replica_count_std=t(rc[3]),
        leader_count_std=t(lc[3]), topic_replica_count_std=t(topic_std),
        potential_nw_out_max=t(np.float32(pot_sel.max(initial=-np.inf))),
        potential_nw_out_total=t(np.float32(float((pot * alive).sum()))),
        num_alive_brokers=t(alive.sum(), torch.int32),
        num_replicas=t(valid.sum(), torch.int32),
        num_offline_replicas=t((valid & offline).sum(), torch.int32))


def host_fallback_solve(state, topology, options=None, time_fn=None):
    """Degraded-mode solve: numpy-only self-healing placement repair.

    Every offline replica (dead broker, broken disk) moves to the least
    disk-utilized alive broker that does not already hold its partition
    and has capacity headroom, leadership travelling with the replica.
    No balance goal runs.  `options` holds at the broker level as in the
    device self-healing pass: destinations exclude
    `excluded_brokers_for_replica_move` and keep to
    `requested_destination_broker_ids`; offline replicas of excluded
    topics still move.

    The state is read through `.cpu().numpy()`; the result is an
    `OptimizerResult` (numpy statistics, no per-goal tables, rounds under
    ``__host_fallback__``) whose final state lies on the state's device.
    """
    from cruise_control_tpu_torch.analyzer.context import \
        partition_replica_index
    from cruise_control_tpu_torch.analyzer.degradation import \
        InvalidModelInputError
    from cruise_control_tpu_torch.analyzer.goals.base import \
        OptimizationFailure
    from cruise_control_tpu_torch.analyzer.optimizer import OptimizerResult
    from cruise_control_tpu_torch.analyzer.proposals import \
        diff_proposals_host

    t0 = (time_fn or _time.time)()

    def host(name, dtype=None):
        x = getattr(state, name).cpu().numpy()
        return x if dtype is None else x.astype(dtype)

    valid = host("replica_valid")
    part = host("replica_partition")
    broker = np.array(host("replica_broker"))
    disk = np.array(host("replica_disk"))
    leader = host("replica_is_leader")
    offline = np.array(host("replica_offline"))
    base_load = host("replica_base_load", np.float64)
    bonus = host("partition_leader_bonus", np.float64)
    alive = host("broker_alive")
    cap = host("broker_capacity", np.float64)
    disk_broker = host("disk_broker")
    disk_alive = host("disk_alive")
    disk_cap = host("disk_capacity", np.float64)
    topic_of_partition = host("partition_topic")

    if not np.isfinite(base_load).all() or (base_load < 0).any() \
            or not np.isfinite(cap).all() or (cap < 0).any():
        raise InvalidModelInputError(
            "cluster model carries NaN/Inf/negative loads or capacities "
            "(host-side validity sweep)")

    stats_before = _host_stats(valid, part, broker, leader, base_load,
                               bonus, cap, alive, topic_of_partition,
                               state.num_topics, offline)

    # broker-level destination policy (make_context's broker_dest_ok):
    # operator exclusions hold in degraded mode too
    broker_ids = np.asarray(topology.broker_ids)
    dest_ok = alive.copy()
    if options is not None:
        excluded = set(options.excluded_brokers_for_replica_move or ())
        requested = set(options.requested_destination_broker_ids or ())
        for i, ext in enumerate(broker_ids.tolist()):
            if ext in excluded or (requested and ext not in requested):
                dest_ok[i] = False

    load_r = (base_load + leader[:, None]
              * _leader_bonus_rows(part, bonus)) * valid[:, None]
    bload = np.zeros_like(cap)
    np.add.at(bload, broker[valid], load_r[valid])
    dload = np.zeros(max(state.num_disks, 1), dtype=np.float64)
    on_disk = valid & (disk >= 0)
    np.add.at(dload, np.maximum(disk[on_disk], 0),
              load_r[on_disk][:, Resource.DISK])

    # partition -> brokers holding it (no two replicas on one broker)
    pr_rows = partition_replica_index(state)
    holders = [set(broker[r] for r in row if r >= 0 and valid[r])
               for row in pr_rows]

    to_heal = np.nonzero(valid & offline)[0]
    moved = 0
    unplaced = 0
    for r in to_heal:
        need = load_r[r]
        p = int(part[r])
        candidates = [b for b in np.nonzero(dest_ok)[0]
                      if b not in holders[p]
                      and np.all(bload[b] + need <= cap[b])]
        if not candidates:
            unplaced += 1
            continue
        dest = min(candidates,
                   key=lambda b: bload[b, Resource.DISK]
                   / max(cap[b, Resource.DISK], 1e-9))
        holders[p].discard(int(broker[r]))
        holders[p].add(int(dest))
        bload[int(broker[r])] -= need
        bload[dest] += need
        broker[r] = dest
        if state.num_disks > 0 and disk[r] >= 0:
            # a logdir-tracked replica lands on the destination's least
            # utilized alive logdir
            dests = [d for d in np.nonzero(disk_alive)[0]
                     if disk_broker[d] == dest]
            if dests:
                best = min(dests, key=lambda d: dload[d]
                           / max(disk_cap[d], 1e-9))
                dload[disk[r]] -= need[Resource.DISK]
                dload[best] += need[Resource.DISK]
                disk[r] = best
        offline[r] = False
        moved += 1
    if unplaced:
        raise OptimizationFailure(
            f"host fallback could not relocate {unplaced} offline "
            f"replicas (insufficient capacity or eligible brokers)")

    dev = state.device
    final_state = state.replace(
        replica_broker=torch.from_numpy(broker.astype(np.int32)).to(dev),
        replica_disk=torch.from_numpy(disk.astype(np.int32)).to(dev),
        replica_offline=torch.from_numpy(offline).to(dev))
    stats_after = _host_stats(valid, part, broker, leader, base_load,
                              bonus, cap, alive, topic_of_partition,
                              state.num_topics, offline)
    keys = dict(replica_broker=host("replica_broker"),
                replica_is_leader=leader, replica_disk=host("replica_disk"))
    proposals = diff_proposals_host(
        keys, dict(keys, replica_broker=broker.astype(np.int32),
                   replica_disk=disk.astype(np.int32)),
        valid, host("replica_base_load")[:, Resource.DISK], part, topology,
        pr_rows)
    return OptimizerResult(
        proposals=proposals,
        stats_before=stats_before,
        stats_after=stats_after,
        stats_by_goal={},
        violated_goals_before=[],
        violated_goals_after=[],
        regressed_goals=[],
        final_state=final_state,
        duration_s=(time_fn or _time.time)() - t0,
        violated_broker_counts={},
        rounds_by_goal={"__host_fallback__": moved},
    )
