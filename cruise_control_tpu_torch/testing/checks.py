"""Result checks of the port: the maintained cache against a fresh
rebuild, and the optimizer-result invariants (the port's own copy of the
reference verifier's checks)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.context import make_round_cache
from cruise_control_tpu_torch.model import state as S
from cruise_control_tpu_torch.model.sanity import sanity_check

_INT_FIELDS = ("replica_count", "leader_count", "partition_rack_count",
               "broker_topic_count")
_FLOAT_FIELDS = ("broker_load", "broker_util", "replica_load",
                 "potential_nw_out", "leader_bytes_in")


def cache_mismatches(state, ctx, cache, rtol: float = 1e-5) -> List[str]:
    """Differences between a maintained RoundCache and a fresh
    `make_round_cache` of `state`: integer aggregates exactly, float
    aggregates within `rtol` relative (incremental float sums drift from
    a rebuild's by rounding), and the broker table by content — each
    row's live ids as a set, every live slot's aux entries, and pad at
    and past each fill pointer."""
    fresh = make_round_cache(state, cache.broker_table.shape[1], ctx)
    errors = []
    for f in _INT_FIELDS:
        if not torch.equal(getattr(cache, f), getattr(fresh, f)):
            errors.append(f)
    for f in _FLOAT_FIELDS:
        a = getattr(cache, f).double()
        b = getattr(fresh, f).double()
        scale = torch.clamp_min(b.abs().max(), 1.0)
        if float((a - b).abs().max()) > rtol * float(scale):
            errors.append(f"{f} (max abs diff {float((a - b).abs().max())})")
    num_r = state.num_replicas
    table = cache.broker_table.cpu().numpy()
    fill = cache.table_fill.cpu().numpy()
    live = table < num_r
    rows_fresh = fresh.broker_table.cpu().numpy()
    for b in range(table.shape[0]):
        got = np.sort(table[b][live[b]])
        want = np.sort(rows_fresh[b][rows_fresh[b] < num_r])
        if not np.array_equal(got, want):
            errors.append(f"broker_table row {b}")
            break
        if live[b, fill[b]:].any():
            errors.append(f"table_fill row {b}")
            break
    ids = torch.from_numpy(np.where(live, table, 0)).long().to(
        cache.broker_table.device)
    live_t = torch.from_numpy(live).to(cache.broker_table.device)
    ok_r = fresh.replica_ok[ids]
    lead_r = state.replica_is_leader[ids]
    bonus_r = state.partition_leader_bonus[state.replica_partition[ids].long()]
    load_r = S.replica_current_load(state)[ids]
    checks = (("table_ok", cache.table_ok, ok_r),
              ("table_leader", cache.table_leader, lead_r),
              ("table_bonus", cache.table_bonus, bonus_r))
    # table_load takes +-bonus at each leadership transfer and is never
    # refreshed (it only ranks candidates), so it drifts like the float
    # aggregates: (base + bonus) - bonus need not round back to base
    diff = torch.where(live_t[..., None],
                       (cache.table_load.double() - load_r.double()).abs(),
                       0.0)
    if diff.numel() and float(diff.max()) > rtol * max(
            float(load_r.double().abs().max()), 1.0):
        errors.append(f"table_load (max abs diff {float(diff.max())})")
    for name, got, want in checks:
        if got.dim() == 3:
            same = torch.all(got == want, -1)
        else:
            same = got == want
        if not bool(torch.all(same | ~live_t)):
            errors.append(name)
    if bool(torch.any(cache.table_ok & ~live_t)):
        errors.append("table_ok set at a non-live slot")
    return errors


def verify_result(initial, result, topology) -> None:
    """The optimizer-result invariants: sanity of the final state,
    nothing on dead brokers or broken disks and no offline replica left
    (self-healing), no regressed goal, each
    proposal's new replica set equal to the final placement and its new
    leader the partition's final leader, and a proposal for every
    partition whose leader changed."""
    final = result.final_state
    sanity_check(final)
    alive = final.broker_alive.cpu().numpy()
    broker = final.replica_broker.cpu().numpy()
    valid = final.replica_valid.cpu().numpy()
    if (~alive[broker] & valid).any():
        raise AssertionError("replica remains on dead broker after optimize")
    disk = final.replica_disk.cpu().numpy()
    disk_alive = final.disk_alive.cpu().numpy()
    on_disk = valid & (disk >= 0)
    if on_disk.any() and (~disk_alive[disk[on_disk]]).any():
        raise AssertionError("replica remains on broken disk after optimize")
    if bool(S.self_healing_eligible(final).any()):
        raise AssertionError("offline replicas remain after optimize")
    if result.regressed_goals:
        raise AssertionError(
            f"goals regressed their statistics: {result.regressed_goals}")
    part = initial.replica_partition.cpu().numpy()
    p_index = topology.partition_index
    b_index = topology.broker_index
    lead = final.replica_is_leader.cpu().numpy() & valid
    lead0 = initial.replica_is_leader.cpu().numpy() & valid
    broker0 = initial.replica_broker.cpu().numpy()
    num_p = initial.num_partitions
    final_leader = np.full(num_p, -1)
    final_leader[part[lead]] = broker[lead]
    first_leader = np.full(num_p, -1)
    first_leader[part[lead0]] = broker0[lead0]
    # valid replica rows grouped by partition, once (not a scan of the
    # replica axis per proposal)
    rows_by_p = np.nonzero(valid)[0]
    rows_by_p = rows_by_p[np.argsort(part[rows_by_p], kind="stable")]
    bounds = np.searchsorted(part[rows_by_p], np.arange(num_p + 1))
    proposed = set()
    for proposal in result.proposals:
        p = p_index[proposal.partition]
        proposed.add(p)
        rows = rows_by_p[bounds[p]:bounds[p + 1]]
        final_set = set(broker[rows].tolist())
        new_set = {b_index[pl.broker_id] for pl in proposal.new_replicas}
        if final_set != new_set:
            raise AssertionError(
                f"proposal for {proposal.partition} inconsistent with "
                f"final state: {sorted(new_set)} vs {sorted(final_set)}")
        if b_index[proposal.new_leader] != final_leader[p]:
            raise AssertionError(
                f"proposal for {proposal.partition} names leader "
                f"{proposal.new_leader}, the final state broker index "
                f"{final_leader[p]}")
    moved = np.nonzero(final_leader != first_leader)[0]
    missing = [int(p) for p in moved if int(p) not in proposed]
    if missing:
        raise AssertionError(f"{len(missing)} partitions changed leader "
                             f"without a proposal, e.g. {missing[:5]}")
