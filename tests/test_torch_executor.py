"""The PyTorch port's executor plane (cruise_control_tpu_torch/executor/,
cluster/simulated.py, cluster/admin.py, cluster/metadata.py,
utils/faults.py) against the JAX package's, on the CPU.  Host code only:
no solve, no device.

Every scenario of the JAX package's tests/test_executor.py (planner,
strategies, end to end, the task state machine, the review regressions,
fault injection) runs once over each package, each on its own
`SimulatedCluster` on a virtual clock with a fixed execution uuid.  Each
run keeps its own assertions and returns an outcome: the final snapshot
(generation, brokers, partitions with replicas, leader, in-sync and
offline replicas and logdirs), each task's state, re-executions and
times by stable key, the executor's counts, the notifier's calls, the
fault injector's counts and the sequence of admin calls with their
arguments (recorded by a wrapping admin client).  The two outcomes must
be equal.  A seeded random execution (40 brokers, 2,000 partitions, 600
proposals made with numpy) is held the same way, with a throttle and the
three phases, and a seeded fault plan fires at the same calls in both.
Also: a snapshot answers `partition` and `broker` as the JAX package's
scan does (None for an unknown id), and the simulated cluster's kept
`describe_cluster` answers equal the JAX package's, call for call.
"""
import dataclasses
import types

import numpy as np
import pytest

import cruise_control_tpu.analyzer.proposals as J_PROP
import cruise_control_tpu.cluster.metadata as J_META
import cruise_control_tpu.cluster.simulated as J_SIM
import cruise_control_tpu.cluster.types as J_TYPES
import cruise_control_tpu.executor as J_EX
import cruise_control_tpu.executor.task as J_TASK
import cruise_control_tpu.model.builder as J_BUILDER
import cruise_control_tpu.utils.faults as J_FAULTS
import cruise_control_tpu_torch.analyzer.proposals as P_PROP
import cruise_control_tpu_torch.cluster.metadata as P_META
import cruise_control_tpu_torch.cluster.simulated as P_SIM
import cruise_control_tpu_torch.cluster.types as P_TYPES
import cruise_control_tpu_torch.executor as P_EX
import cruise_control_tpu_torch.executor.task as P_TASK
import cruise_control_tpu_torch.model.topology as P_TOPO
import cruise_control_tpu_torch.utils.faults as P_FAULTS

UUID = "0f0e0d0c-0000-4000-8000-000000000016"


def kit(jax_side: bool):
    """One package's executor-plane namespace."""
    if jax_side:
        return types.SimpleNamespace(
            name="jax", prop=J_PROP, sim=J_SIM, types=J_TYPES, ex=J_EX,
            task=J_TASK, faults=J_FAULTS, meta=J_META,
            PartitionId=J_BUILDER.PartitionId)
    return types.SimpleNamespace(
        name="port", prop=P_PROP, sim=P_SIM, types=P_TYPES, ex=P_EX,
        task=P_TASK, faults=P_FAULTS, meta=P_META,
        PartitionId=P_TOPO.PartitionId)


KITS = (kit(True), kit(False))


def proposal(k, topic, part, old, new, old_leader=None, size=0.0,
             logdirs_old=None, logdirs_new=None):
    olds = tuple(k.prop.ReplicaPlacement(b, (logdirs_old or {}).get(b))
                 for b in old)
    news = tuple(k.prop.ReplicaPlacement(b, (logdirs_new or {}).get(b))
                 for b in new)
    return k.prop.ExecutionProposal(
        partition=k.PartitionId(topic, part),
        old_leader=old_leader if old_leader is not None else old[0],
        old_replicas=olds, new_replicas=news, partition_size=size)


def make_sim(k, num_brokers=4, logdirs=("/d0",)):
    sim = k.sim.SimulatedCluster()  # virtual clock
    for b in range(num_brokers):
        sim.add_broker(b, rack=f"r{b % 2}", logdirs=logdirs)
    return sim


def norm(x):
    """A package-independent value: records become tuples of their
    fields, mappings lists of pairs in their order."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return [(norm(a), norm(b)) for a, b in x.items()]
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(norm(v) for v in x))
    return x


def snapshot_key(snap):
    """A snapshot, package-independent, logdirs sorted by broker."""
    return (snap.generation, snap.controller_id, norm(snap.brokers),
            tuple((p.tp.topic, p.tp.partition, p.leader, tuple(p.replicas),
                   tuple(p.in_sync), tuple(p.offline_replicas),
                   tuple(sorted(p.logdir_by_broker.items())))
                  for p in snap.partitions))


class RecordingAdmin:
    """Forwards every call to the simulated cluster and records it: the
    operation and its arguments, package-independent, in call order."""

    def __init__(self, sim):
        self._sim = sim
        self.calls = []

    def __getattr__(self, name):
        real = getattr(self._sim, name)
        if not callable(real):
            return real

        def call(*args, **kwargs):
            self.calls.append((name, norm(args), norm(kwargs)))
            return real(*args, **kwargs)
        return call


def make_executor(k, sim, admin=None, **kw):
    kw.setdefault("progress_check_interval_s", 1.0)
    return k.ex.Executor(admin if admin is not None else sim,
                         time_fn=lambda: sim.now_ms() / 1000.0,
                         sleep_fn=sim.advance, **kw)


class Notifier:
    def __init__(self):
        self.calls = []

    def on_execution_finished(self, uuid, ok, msg):
        self.calls.append((uuid, ok, msg))


def tasks_key(ex):
    if ex._manager is None:
        return ()
    return tuple(sorted(
        (t.stable_key, t.task_type.value, t.state.value,
         t.reexecution_count, t.start_time_ms, t.end_time_ms)
        for t in ex._manager._planner.all_tasks()))


def outcome(k, sim, ex, admin=None, notifier=None, injector=None):
    counts = ()
    if ex._manager is not None:
        counts = tuple(norm(ex._manager.counts(t)) for t in k.task.TaskType)
    return dict(
        snapshot=snapshot_key(sim.describe_cluster()),
        reassigning=norm(sim.list_partition_reassignments()),
        throttles=tuple(sorted((b, v.throttle)
                               for b, v in sim._brokers.items())),
        tasks=tasks_key(ex), counts=counts,
        phase=ex.state.phase.value,
        tolerated=ex.num_poll_failures_tolerated,
        removed=tuple(sorted(ex.recently_removed_brokers())),
        demoted=tuple(sorted(ex.recently_demoted_brokers())),
        admin_calls=None if admin is None else tuple(admin.calls),
        notified=None if notifier is None else tuple(notifier.calls),
        faults=None if injector is None else norm(injector.counts()),
        clock=sim.now_ms())


# ---------------------------------------------------------------------------
# the scenarios of tests/test_executor.py, each over one kit
# ---------------------------------------------------------------------------
def planner_decomposition(k):
    planner = k.ex.ExecutionTaskPlanner()
    planner.add_proposals([
        proposal(k, "t", 0, [0, 1], [2, 1]),
        proposal(k, "t", 1, [0, 1], [1, 0]),
        proposal(k, "t", 2, [0, 1], [0, 1],
                 logdirs_old={0: "/d0"}, logdirs_new={0: "/d1"}),
    ])
    assert len(planner.remaining_inter_broker_tasks) == 1
    assert len(planner.remaining_leadership_tasks) == 2
    assert len(planner.remaining_intra_broker_tasks) == 1
    return [t.stable_key for t in planner.all_tasks()]


def planner_replica_and_leader(k):
    planner = k.ex.ExecutionTaskPlanner()
    planner.add_proposals([proposal(k, "t", 0, [0, 1], [2, 1],
                                    old_leader=0)])
    assert len(planner.remaining_inter_broker_tasks) == 1
    assert len(planner.remaining_leadership_tasks) == 1
    return [t.stable_key for t in planner.all_tasks()]


def planner_concurrency_slots(k):
    planner = k.ex.ExecutionTaskPlanner()
    planner.add_proposals([
        proposal(k, "t", 0, [0], [1]),
        proposal(k, "t", 1, [0], [1]),
        proposal(k, "t", 2, [2], [3]),
    ])
    picked = planner.pop_inter_broker_tasks({0: 1, 1: 1, 2: 1, 3: 1})
    tps = [t.proposal.partition.partition for t in picked]
    assert set(tps) == {0, 2}
    return tps


def strategy_ordering(k):
    orders = []
    for cls, want in ((k.ex.PrioritizeSmallReplicaMovementStrategy, [1, 0]),
                      (k.ex.PrioritizeLargeReplicaMovementStrategy, [0, 1])):
        planner = k.ex.ExecutionTaskPlanner(cls())
        planner.add_proposals([
            proposal(k, "t", 0, [0], [1], size=100.0),
            proposal(k, "t", 1, [0], [1], size=1.0),
        ])
        order = [t.proposal.partition.partition
                 for t in planner.remaining_inter_broker_tasks]
        assert order == want
        orders.append(order)
    return orders


def strategy_from_names(k):
    s = k.ex.strategy_from_names(["PrioritizeSmallReplicaMovementStrategy",
                                  "PostponeUrpReplicaMovementStrategy"])
    assert s.name() == "PrioritizeSmallReplicaMovementStrategy"
    with pytest.raises(ValueError):
        k.ex.strategy_from_names(["NoSuchStrategy"])
    return s.chain_names()


def replica_and_leader_movement(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1], [1, 2]], size_bytes=50e6)
    admin, notifier = RecordingAdmin(sim), Notifier()
    ex = make_executor(k, sim, admin, notifier=notifier)
    ex.execute_proposals([
        proposal(k, "t", 0, [0, 1], [2, 1], old_leader=0, size=50e6),
        proposal(k, "t", 1, [1, 2], [2, 1], old_leader=1, size=50e6),
    ], reason="test", uuid=UUID, wait=True)
    snap = sim.describe_cluster()
    p0 = snap.partition(k.types.TopicPartition("t", 0))
    p1 = snap.partition(k.types.TopicPartition("t", 1))
    assert set(p0.replicas) == {1, 2} and p0.leader == 2
    assert set(p1.replicas) == {1, 2} and p1.leader == 2
    assert ex.state.phase == k.ex.ExecutorPhase.NO_TASK_IN_PROGRESS
    assert not ex.has_ongoing_execution
    return outcome(k, sim, ex, admin, notifier)


def progress_counters_and_notifier(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=10e6)
    admin, notifier = RecordingAdmin(sim), Notifier()
    ex = make_executor(k, sim, admin, notifier=notifier)
    uuid = ex.execute_proposals(
        [proposal(k, "t", 0, [0, 1], [2, 1], size=10e6)], uuid=UUID,
        wait=True)
    assert notifier.calls == [(uuid, True, "execution completed")]
    return outcome(k, sim, ex, admin, notifier)


def dead_destination(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=10e6)
    sim.kill_broker(3)
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin)
    ex.execute_proposals([proposal(k, "t", 0, [0, 1], [3, 1], size=10e6)],
                         uuid=UUID, wait=True)
    snap = sim.describe_cluster()
    assert set(snap.partition(
        k.types.TopicPartition("t", 0)).replicas) == {0, 1}
    return outcome(k, sim, ex, admin)


def concurrent_execution_rejected(k):
    """The second execution is refused while the first runs (its thread
    is held at its first sleep, so the refusal is deterministic)."""
    import threading
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=1e12)
    ex = make_executor(k, sim)
    release, held = threading.Event(), threading.Event()
    orig = ex._sleep

    def holding_sleep(s):
        held.set()
        release.wait(30.0)
        orig(s)
    ex._sleep = holding_sleep
    ex.execute_proposals([proposal(k, "t", 0, [0, 1], [2, 1], size=1e12)],
                         uuid=UUID)
    assert held.wait(30.0)
    try:
        with pytest.raises(RuntimeError):
            ex.execute_proposals(
                [proposal(k, "t", 0, [0, 1], [3, 1], size=1e12)])
        ex.stop_execution(force=True)
    finally:
        release.set()
        assert ex.await_completion(timeout=30.0)
    return outcome(k, sim, ex)


def force_stop(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=1e12)
    admin, notifier = RecordingAdmin(sim), Notifier()
    ex = make_executor(k, sim, admin, notifier=notifier)
    calls = []
    orig_sleep = ex._sleep

    def stopping_sleep(s):
        calls.append(s)
        if len(calls) == 1:
            ex.stop_execution(force=True)
        orig_sleep(s)
    ex._sleep = stopping_sleep
    ex.execute_proposals([proposal(k, "t", 0, [0, 1], [2, 1], size=1e12)],
                         uuid=UUID, wait=True)
    assert sim.list_partition_reassignments() == []
    snap = sim.describe_cluster()
    assert set(snap.partition(
        k.types.TopicPartition("t", 0)).replicas) == {0, 1}
    assert ex.state.phase == k.ex.ExecutorPhase.NO_TASK_IN_PROGRESS
    return outcome(k, sim, ex, admin, notifier)


def throttle_applied_and_cleared(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=100e6)
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin, replication_throttle_bytes_per_s=10e6)
    ex.execute_proposals([proposal(k, "t", 0, [0, 1], [2, 1], size=100e6)],
                         uuid=UUID, wait=True)
    snap = sim.describe_cluster()
    assert set(snap.partition(
        k.types.TopicPartition("t", 0)).replicas) == {1, 2}
    assert all(b.throttle is None for b in sim._brokers.values())
    return outcome(k, sim, ex, admin)


def intra_broker_logdir_move(k):
    sim = make_sim(k, logdirs=("/d0", "/d1"))
    sim.create_topic("t", [[0, 1]], size_bytes=10e6)
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin)
    ex.execute_proposals([
        proposal(k, "t", 0, [0, 1], [0, 1], logdirs_old={0: "/d0"},
                 logdirs_new={0: "/d1"}, size=10e6)], uuid=UUID, wait=True)
    snap = sim.describe_cluster()
    assert snap.partition(
        k.types.TopicPartition("t", 0)).logdir_by_broker[0] == "/d1"
    return outcome(k, sim, ex, admin)


def removal_history(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=1e6)
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin)
    ex.execute_proposals([proposal(k, "t", 0, [0, 1], [2, 1], size=1e6)],
                         removed_brokers=[0], demoted_brokers=[1],
                         uuid=UUID, wait=True)
    assert ex.recently_removed_brokers() == {0}
    assert ex.recently_demoted_brokers() == {1}
    ex.drop_recently_removed_brokers([0])
    assert ex.recently_removed_brokers() == set()
    return outcome(k, sim, ex, admin)


def illegal_transition(k):
    t = k.task.ExecutionTask(k.task.ExecutionTask.next_id(),
                             proposal(k, "t", 0, [0], [1]),
                             k.task.TaskType.INTER_BROKER_REPLICA_ACTION)
    with pytest.raises(ValueError):
        t.completed(0.0)
    t.in_progress(0.0)
    t.completed(1.0)
    assert t.done and t.state == k.task.TaskState.COMPLETED
    return (t.state.value, t.start_time_ms, t.end_time_ms, norm(
        t.to_json()["proposal"]))


def _inter_task(k, ex):
    return [t for t in ex._manager._planner.all_tasks()
            if t.task_type == k.task.TaskType.INTER_BROKER_REPLICA_ACTION][0]


def slow_transfer_no_reexecution(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=100e6)
    sim._move_rate = 1e6
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin, max_task_execution_idle_s=5.0)
    ex.execute_proposals([proposal(k, "t", 0, [0, 1], [2, 1], size=100e6)],
                         uuid=UUID, wait=True)
    snap = sim.describe_cluster()
    assert set(snap.partition(
        k.types.TopicPartition("t", 0)).replicas) == {1, 2}
    assert _inter_task(k, ex).reexecution_count == 0
    return outcome(k, sim, ex, admin)


def _sabotage(k, sim, ex):
    """Cancel the reassignment out from under the executor once, from
    inside its own sleep (deterministic under virtual time)."""
    cancelled = []
    orig_sleep = ex._sleep

    def sabotaging_sleep(s):
        orig_sleep(s)
        if not cancelled and sim.list_partition_reassignments():
            sim.alter_partition_reassignments(
                {k.types.TopicPartition("t", 0): None})
            cancelled.append(True)
    ex._sleep = sabotaging_sleep


def lost_reassignment_reexecuted(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=100e6)
    sim._move_rate = 10e6
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin)
    _sabotage(k, sim, ex)
    ex.execute_proposals([proposal(k, "t", 0, [0, 1], [2, 1], size=100e6)],
                         uuid=UUID, wait=True)
    snap = sim.describe_cluster()
    assert set(snap.partition(
        k.types.TopicPartition("t", 0)).replicas) == {1, 2}
    assert _inter_task(k, ex).reexecution_count >= 1
    return outcome(k, sim, ex, admin)


def poll_survives_describe_faults(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=50e6)
    sim._move_rate = 10e6
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin)
    plan = k.faults.FaultPlan().fail_nth(
        "executor.admin.describe_cluster", (3, 4))
    with k.faults.injected(plan) as injector:
        ex.execute_proposals(
            [proposal(k, "t", 0, [0, 1], [2, 1], size=50e6)], uuid=UUID,
            wait=True)
    snap = sim.describe_cluster()
    assert set(snap.partition(
        k.types.TopicPartition("t", 0)).replicas) == {1, 2}
    assert ex.num_poll_failures_tolerated >= 1
    return outcome(k, sim, ex, admin, injector=injector)


def reexecution_survives_failed_resubmit(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=100e6)
    sim._move_rate = 10e6
    admin = RecordingAdmin(sim)
    ex = make_executor(k, sim, admin)
    _sabotage(k, sim, ex)
    plan = k.faults.FaultPlan().fail_nth(
        "executor.admin.alter_partition_reassignments", 2)
    with k.faults.injected(plan) as injector:
        ex.execute_proposals(
            [proposal(k, "t", 0, [0, 1], [2, 1], size=100e6)], uuid=UUID,
            wait=True)
    snap = sim.describe_cluster()
    assert set(snap.partition(
        k.types.TopicPartition("t", 0)).replicas) == {1, 2}
    task = _inter_task(k, ex)
    assert task.state == k.task.TaskState.COMPLETED
    assert task.reexecution_count >= 1
    assert ex.num_poll_failures_tolerated >= 1
    return outcome(k, sim, ex, admin, injector=injector)


def leader_timeout_under_election_faults(k):
    sim = make_sim(k)
    sim.create_topic("t", [[0, 1]], size_bytes=1e6)
    admin, notifier = RecordingAdmin(sim), Notifier()
    ex = make_executor(k, sim, admin, leader_movement_timeout_s=5.0)
    ex._notifier = notifier
    plan = k.faults.FaultPlan().fail_always(
        "executor.admin.elect_preferred_leaders")
    with k.faults.injected(plan) as injector:
        ex.execute_proposals(
            [proposal(k, "t", 0, [0, 1], [1, 0], old_leader=0)], uuid=UUID,
            wait=True)
    snap = sim.describe_cluster()
    assert snap.partition(k.types.TopicPartition("t", 0)).leader == 0
    leader_tasks = [t for t in ex._manager._planner.all_tasks()
                    if t.task_type == k.task.TaskType.LEADER_ACTION]
    assert leader_tasks and all(t.state == k.task.TaskState.DEAD
                                for t in leader_tasks)
    assert notifier.calls == [(UUID, True, "execution completed")]
    assert ex.num_poll_failures_tolerated >= 1
    return outcome(k, sim, ex, admin, notifier, injector)


SCENARIOS = {
    "planner: task decomposition": planner_decomposition,
    "planner: replica move with leader change": planner_replica_and_leader,
    "planner: concurrency slots": planner_concurrency_slots,
    "strategies: ordering": strategy_ordering,
    "strategies: from names": strategy_from_names,
    "end to end: replica and leader movement": replica_and_leader_movement,
    "end to end: counters and notifier": progress_counters_and_notifier,
    "end to end: dead destination": dead_destination,
    "end to end: concurrent execution rejected":
        concurrent_execution_rejected,
    "end to end: force stop": force_stop,
    "end to end: throttle": throttle_applied_and_cleared,
    "end to end: intra-broker logdir move": intra_broker_logdir_move,
    "end to end: removal history": removal_history,
    "task state machine": illegal_transition,
    "regression: slow transfer": slow_transfer_no_reexecution,
    "regression: lost reassignment": lost_reassignment_reexecuted,
    "faults: poll survives describe faults": poll_survives_describe_faults,
    "faults: failed re-submit": reexecution_survives_failed_resubmit,
    "faults: leader timeout": leader_timeout_under_election_faults,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equals_reference(name):
    jax_out, port_out = (SCENARIOS[name](k) for k in KITS)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# a seeded random execution
# ---------------------------------------------------------------------------
RANDOM_BROKERS, RANDOM_PARTITIONS, RANDOM_PROPOSALS = 40, 2000, 600


def random_cluster_and_proposals(seed: int):
    """(topics: [(name, [[replicas]])], sizes, proposals as plain
    tuples): 4 topics of rf 3 over 40 brokers on 4 racks with 2 logdirs
    each; 600 proposals, each moving 0-2 replicas to other brokers,
    changing the leader in a third of them and a surviving replica's
    logdir in a fifth."""
    rng = np.random.default_rng(seed)
    per_topic = RANDOM_PARTITIONS // 4
    topics, sizes, flat = [], {}, []
    for t in range(4):
        rows = [rng.choice(RANDOM_BROKERS, 3, replace=False).tolist()
                for _ in range(per_topic)]
        topics.append((f"topic-{t}", rows))
        for p, row in enumerate(rows):
            sizes[(f"topic-{t}", p)] = float(rng.integers(1, 400)) * 1e6
            flat.append((f"topic-{t}", p, row))
    picks = rng.choice(len(flat), RANDOM_PROPOSALS, replace=False)
    props = []
    for i in sorted(picks.tolist()):
        topic, p, old = flat[i]
        new = list(old)
        n_move = int(rng.integers(0, 3))
        others = [b for b in range(RANDOM_BROKERS) if b not in old]
        for slot, dst in zip(rng.choice(3, n_move, replace=False).tolist(),
                             rng.choice(others, n_move,
                                        replace=False).tolist()):
            new[slot] = dst
        if rng.random() < 1 / 3 or n_move == 0:
            j = int(rng.integers(1, 3))
            new[0], new[j] = new[j], new[0]
        old_dirs = {b: "/d0" for b in old}
        new_dirs = {b: "/d0" for b in new}
        if rng.random() < 0.2:
            kept = [b for b in new if b in old]
            if kept:
                new_dirs[kept[0]] = "/d1"
        props.append((topic, p, old, new, sizes[(topic, p)], old_dirs,
                      new_dirs))
    return topics, sizes, props


def random_execution(k, seed: int, plan_fn=None):
    topics, sizes, props = random_cluster_and_proposals(seed)
    sim = make_sim(k, RANDOM_BROKERS, logdirs=("/d0", "/d1"))
    sim._move_rate = 20e6
    for name, rows in topics:
        sim.create_topic(name, rows)
        for p in range(len(rows)):
            sim.set_partition_load(k.types.TopicPartition(name, p),
                                   size_bytes=sizes[(name, p)])
    admin, notifier = RecordingAdmin(sim), Notifier()
    ex = make_executor(k, sim, admin, notifier=notifier,
                       progress_check_interval_s=5.0,
                       concurrent_leader_movements=100,
                       replication_throttle_bytes_per_s=50e6)
    proposals = [proposal(k, t, p, old, new, size=size, logdirs_old=od,
                          logdirs_new=nd)
                 for t, p, old, new, size, od, nd in props]
    injector = None
    if plan_fn is None:
        ex.execute_proposals(proposals, reason="random", uuid=UUID,
                             removed_brokers=[3], wait=True)
    else:
        with k.faults.injected(plan_fn(k)) as injector:
            ex.execute_proposals(proposals, reason="random", uuid=UUID,
                                 removed_brokers=[3], wait=True)
    return outcome(k, sim, ex, admin, notifier, injector)


def test_random_execution_equals_reference():
    jax_out, port_out = (random_execution(k, seed=16) for k in KITS)
    assert port_out == jax_out
    assert {t[2] for t in port_out["tasks"]} == {"COMPLETED"}
    kinds = {t[1] for t in port_out["tasks"]}
    assert kinds == {"INTER_BROKER_REPLICA_ACTION",
                     "INTRA_BROKER_REPLICA_ACTION", "LEADER_ACTION"}
    assert port_out["notified"] == ((UUID, True, "execution completed"),)


def test_seeded_fault_plan_fires_at_the_same_calls():
    """A seeded plan (describe and reassignment-listing polls failing
    with probability 0.2, one election failing): the same calls fail in
    both packages, and the execution ends the same."""
    def plan(k):
        return (k.faults.FaultPlan(seed=7)
                .fail_probability("executor.admin.describe_cluster", 0.2)
                .fail_probability(
                    "executor.admin.list_partition_reassignments", 0.2)
                .fail_nth("executor.admin.elect_preferred_leaders", 2))
    jax_out, port_out = (random_execution(k, seed=17, plan_fn=plan)
                         for k in KITS)
    assert port_out == jax_out
    assert port_out["faults"] and any(f for _s, (_c, f) in
                                      port_out["faults"])


# ---------------------------------------------------------------------------
# the snapshot's queries and the simulated cluster's kept answers
# ---------------------------------------------------------------------------
def test_snapshot_queries_equal_the_scan():
    results = []
    for k in KITS:
        T = k.types
        parts = (T.PartitionInfo(T.TopicPartition("a", 0), 1, (1, 2)),
                 T.PartitionInfo(T.TopicPartition("b", 0), 2, (2,),
                                 offline_replicas=(2,)),
                 T.PartitionInfo(T.TopicPartition("a", 0), 2, (2, 3)))
        brokers = (T.BrokerInfo(1), T.BrokerInfo(2, rack="r"),
                   T.BrokerInfo(1, host="dup"))
        snap = T.ClusterSnapshot(5, brokers, parts)
        results.append(norm((
            snap.partition(T.TopicPartition("a", 0)),
            snap.partition(T.TopicPartition("b", 0)),
            snap.partition(T.TopicPartition("c", 0)),
            snap.broker(1), snap.broker(2), snap.broker(9),
            sorted(snap.topics), snap.partitions_with_offline_replicas(),
            snap.replica_count(), sorted(snap.alive_broker_ids),
            list(T.partitions_by_index(parts).values()))))
    assert results[1] == results[0]


def sim_story(k):
    """Every mutation of the simulated cluster, a snapshot after each."""
    sim = make_sim(k, 5, logdirs=("/d0", "/d1"))
    meta = k.meta.MetadataClient(sim, time_fn=lambda: sim.now_ms() / 1e3)
    TP = k.types.TopicPartition
    sim.create_topic("x", [[0, 1], [1, 2], [2, 3], [3, 4]], size_bytes=5e6)
    out = [snapshot_key(meta.refresh_metadata())]
    steps = [
        lambda: sim.alter_partition_reassignments({TP("x", 0): [4, 1],
                                                   TP("x", 1): [2, 1]}),
        lambda: sim.advance(0.01),
        lambda: sim.set_replication_throttle([4], 1e6),
        lambda: sim.advance(0.02),
        lambda: sim.elect_preferred_leaders([TP("x", 1)]),
        lambda: sim.alter_replica_log_dirs({TP("x", 2): {3: "/d1"}}),
        lambda: sim.kill_broker(3),
        lambda: sim.fail_disk(2, "/d0"),
        lambda: sim.alter_partition_reassignments({TP("x", 2): [2, 0]}),
        lambda: sim.alter_partition_reassignments({TP("x", 2): None}),
        lambda: sim.restart_broker(3),
        lambda: sim.create_topic("x", [[4, 0]], size_bytes=1e6),
        lambda: sim.advance(10.0),
    ]
    for step in steps:
        step()
        out.append((snapshot_key(sim.describe_cluster()),
                    norm(sim.list_partition_reassignments()),
                    norm(sim.describe_log_dirs([0, 1, 2, 3, 4]))))
    out.append(snapshot_key(meta.cluster()))
    return out


def test_simulated_cluster_answers_equal_reference():
    jax_out, port_out = (sim_story(k) for k in KITS)
    assert port_out == jax_out
