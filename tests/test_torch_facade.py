"""The PyTorch port's facade solve side (cruise_control_tpu_torch/
facade.py) against the JAX reference's `CruiseControl`, on the CPU.

A JAX `CruiseControl` over a `SimulatedCluster` (as tests/
test_incremental.py makes one: sampled windows, the incremental store,
the `INCR_GOALS` stack) serves the same requests as a port
`CruiseControl` over a port `SnapshotLoadMonitor` fed from the JAX monitor's
snapshot, capacities and expected leader loads (converted field by
field, tests/test_torch_monitor.py).  The cluster: 9 brokers on two racks,
broker 8 empty, two topics of rf 2 placed rack-aware with skewed loads,
and the options generator's excluded-topics pattern naming one topic.

In one sequence each request must give the reference's proposals and
final placement, and the store the reference's counters (hits, misses,
fallbacks, delta applies, quarantines, last dirty brokers, last fallback
reason): `optimizations` cold, then its cache hit (the same object), a
delta under the dirty cap (the warm solve restricted to the dirty
brokers) and one over it (unrestricted, one counted fallback),
`rebalance` with self-healing options and with `kafka_assigner`,
`demote_brokers`, `remove_brokers`, `add_brokers` onto the empty broker,
`fix_offline_replicas` with nothing offline (ValueError in both) and
after a broker dies.  After every request the store's resident model and
the warm seed are unchanged bit for bit.  Also: a restricted solve that
fails its verdict is retried as a full sweep in both; the EAGER rung is
the optimizer's eager driver; an invalidated cache solves again; what
the port does not have raises
NotImplementedError (`dryrun=False` without an admin client raises
ValueError); without a card the facade raises unless device="cpu".
"""
import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as JO
from cruise_control_tpu.analyzer.context import \
    OptimizationOptions as JOptions
from cruise_control_tpu.analyzer.goals.base import \
    OptimizationFailure as JFailure
from cruise_control_tpu.analyzer.options_generator import \
    DefaultOptimizationOptionsGenerator as JGenerator
from cruise_control_tpu.cluster.simulated import SimulatedCluster
from cruise_control_tpu.cluster.types import TopicPartition as JTP
from cruise_control_tpu.facade import CruiseControl as JCruiseControl
from cruise_control_tpu.monitor import deltas as JD
from cruise_control_tpu.monitor.sampling.sampler import \
    SimulatedClusterSampler
from cruise_control_tpu_torch import facade as F
from cruise_control_tpu_torch.analyzer import optimizer as PO
from cruise_control_tpu_torch.analyzer.context import OptimizationOptions
from cruise_control_tpu_torch.analyzer.goals.base import OptimizationFailure
from cruise_control_tpu_torch.analyzer.options_generator import \
    DefaultOptimizationOptionsGenerator
from cruise_control_tpu_torch.model.state import STATE_FIELDS
from cruise_control_tpu_torch.monitor.load_monitor import \
    SnapshotLoadMonitor
from test_torch_monitor import monitor_inputs, port_delta, port_snapshot

INCR_GOALS = ["RackAwareGoal", "DiskCapacityGoal",
              "ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
COUNTERS = ("hits", "misses", "fallbacks", "deltaApplies", "quarantines",
            "lastDirtyBrokers", "lastFallbackReason", "resident")
PATTERN = "t1"
HEAL = dict(excluded_brokers_for_leadership=frozenset({0}),
            excluded_brokers_for_replica_move=frozenset({5}),
            is_triggered_by_goal_violation=True)
#: under the cap of 0.5 x 9 brokers: broker 2's capacity and one
#: partition of brokers 6 and 7
NARROW = JD.ModelDelta(
    capacity_overrides={2: {"disk": 1.5e6, "cpu": 150.0}},
    load_updates=(JD.PartitionLoadUpdate("t0", 6, (3.0, 140.0, 400.0,
                                                   3e4)),))
#: over it: partitions of every broker reloaded
WIDE = JD.ModelDelta(load_updates=tuple(
    JD.PartitionLoadUpdate("t0", p, (2.5, 130.0, 350.0, 2.5e4))
    for p in range(0, 16, 2)))


def make_sim():
    sim = SimulatedCluster()
    for b in range(9):
        sim.add_broker(b, rack=f"rack{b % 2}")
    for t, n in (("t0", 16), ("t1", 8)):
        sim.create_topic(t, [[p % 8, (p + 1) % 8] for p in range(n)],
                         size_bytes=1e4)
        for p in range(n):
            hot = 3.0 if p % 8 < 2 else 1.0
            sim.set_partition_load(JTP(t, p), leader_cpu=2.0 * hot,
                                   nw_in=100.0 * hot, nw_out=300.0)
    return sim


def make_pair(goals=tuple(INCR_GOALS), **kwargs):
    """(sim, JAX facade, port monitor, port facade, clock), both facades
    over `goals`."""
    sim = make_sim()
    clock = {"now": 10_000.0}
    jcc = JCruiseControl(
        sim, SimulatedClusterSampler(sim),
        time_fn=lambda: clock["now"],
        sleep_fn=lambda s: (sim.advance(s),
                            clock.__setitem__("now", clock["now"] + s)),
        monitor_kwargs=dict(num_windows=3, window_ms=10_000,
                            min_samples_per_window=1,
                            sampling_interval_ms=5_000),
        executor_kwargs=dict(progress_check_interval_s=1.0),
        auto_warmup=False, goal_names=list(goals),
        options_generator=JGenerator(PATTERN), **kwargs)
    jcc.start_up(do_sampling=False, start_detection=False)
    for _ in range(8):
        jcc.load_monitor.task_runner.sample_once()
        sim.advance(5)
        clock["now"] += 5
    snap, loads, caps = monitor_inputs(jcc.load_monitor,
                                       clock["now"] * 1000.0)
    pmon = SnapshotLoadMonitor(snap, loads, caps, device="cpu")
    pcc = F.CruiseControl(
        load_monitor=pmon, device="cpu", goal_names=list(goals),
        options_generator=DefaultOptimizationOptionsGenerator(PATTERN),
        time_fn=lambda: clock["now"], **kwargs)
    return sim, jcc, pmon, pcc, clock


def proposal_keys(result):
    return sorted((p.partition.topic, p.partition.partition,
                   tuple(r.broker_id for r in p.old_replicas),
                   tuple(r.broker_id for r in p.new_replicas),
                   p.new_leader) for p in result.proposals)


def counters(store_json):
    return {k: store_json[k] for k in COUNTERS}


def _frozen(state):
    return {f: getattr(state, f).clone() for f in STATE_FIELDS}


def _unchanged(before, state) -> bool:
    return all(torch.equal(before[f], getattr(state, f))
               for f in STATE_FIELDS)


class _DirtyLog:
    """Records the dirty_brokers argument of each optimizer solve."""

    def __init__(self, monkeypatch, module):
        self.seen = []
        real = module.GoalOptimizer.optimizations
        log = self

        def wrapped(opt, *args, **kwargs):
            d = kwargs.get("dirty_brokers")
            log.seen.append(None if d is None else int(np.asarray(
                d.cpu() if hasattr(d, "cpu") else d).sum()))
            return real(opt, *args, **kwargs)
        monkeypatch.setattr(module.GoalOptimizer, "optimizations", wrapped)


@pytest.fixture(scope="module")
def served():
    """Every request of the sequence in both facades: {step: (JAX
    answer, port answer, JAX store counters, port store counters, the
    port's resident model and seed unchanged, the dirty counts seen)}."""
    mp = pytest.MonkeyPatch()
    jlog, plog = _DirtyLog(mp, JO), _DirtyLog(mp, PO)
    sim, jcc, pmon, pcc, clock = make_pair()
    out = {}

    def step(name, j_call, p_call):
        store = pcc.model_store
        old_state = store._state
        resident = None if old_state is None else _frozen(old_state)
        old_seed = None if pcc._warm_seed is None else pcc._warm_seed[0]
        seed = None if old_seed is None else _frozen(old_seed)
        jlog.seen.clear()
        plog.seen.clear()
        answers = []
        for call in (j_call, p_call):
            try:
                answers.append(call())
            except (ValueError, JFailure, OptimizationFailure) as exc:
                answers.append(exc)
        # the model resident before the request and the seed are as
        # they were, and the model resident now equals a rebuild
        kept = ((resident is None or _unchanged(resident, old_state))
                and (seed is None or _unchanged(seed, old_seed))
                and _unchanged(_frozen(pmon.cluster_model()[0]),
                               store._state))
        out[name] = (answers[0], answers[1],
                     counters(jcc._model_store.to_json()),
                     counters(store.to_json()), kept,
                     (list(jlog.seen), list(plog.seen)))

    def delta(jd):
        jcc.load_monitor.apply_model_delta(jd)
        pmon.apply_model_delta(port_delta(jd))

    try:
        step("cold", jcc.optimizations, pcc.optimizations)
        step("cache hit", jcc.optimizations, pcc.optimizations)
        delta(NARROW)
        step("narrow delta", jcc.optimizations, pcc.optimizations)
        delta(WIDE)
        step("wide delta", jcc.optimizations, pcc.optimizations)
        step("rebalance, self-healing options",
             lambda: jcc.rebalance(options=JOptions(**HEAL)),
             lambda: pcc.rebalance(options=pcc._self_healing_options(
                 recently_demoted=(0,), recently_removed=(5,))))
        step("rebalance, kafka assigner",
             lambda: jcc.rebalance(kafka_assigner=True),
             lambda: pcc.rebalance(kafka_assigner=True))
        step("demote", lambda: jcc.demote_brokers([0]),
             lambda: pcc.demote_brokers([0]))
        step("remove", lambda: jcc.remove_brokers([1]),
             lambda: pcc.remove_brokers([1]))
        step("add", lambda: jcc.add_brokers([8]),
             lambda: pcc.add_brokers([8]))
        step("fix offline, nothing offline", jcc.fix_offline_replicas,
             pcc.fix_offline_replicas)
        sim.kill_broker(3)
        pmon.update_cluster(port_snapshot(
            jcc.load_monitor.metadata.refresh_metadata()))
        step("fix offline", jcc.fix_offline_replicas,
             pcc.fix_offline_replicas)
        step("after the broker died", jcc.optimizations, pcc.optimizations)
    finally:
        mp.undo()
        jcc.shutdown()
    return out, pcc


STEPS = ("cold", "cache hit", "narrow delta", "wide delta",
         "rebalance, self-healing options", "rebalance, kafka assigner",
         "demote", "remove", "add", "fix offline, nothing offline",
         "fix offline", "after the broker died")


def _result(answer):
    return getattr(answer, "optimizer_result", None) or answer


@pytest.mark.parametrize("name", STEPS)
def test_request_equals_reference(served, name):
    out, _ = served
    j, p, jc, pc, kept, _seen = out[name]
    if isinstance(j, Exception):
        assert type(p).__name__ == type(j).__name__, (j, p)
        assert str(p) == str(j)
    else:
        assert not isinstance(p, Exception), p
        jr, pr = _result(j), _result(p)
        assert proposal_keys(pr) == proposal_keys(jr)
        for f in ("replica_broker", "replica_is_leader", "replica_disk"):
            assert np.array_equal(getattr(pr.final_state, f).numpy(),
                                  np.asarray(getattr(jr.final_state, f))), f
        assert pr.violated_goals_after == jr.violated_goals_after
    assert pc == jc
    assert kept, "the resident model or the warm seed changed"


def test_sequence_took_the_expected_paths(served):
    out, pcc = served
    assert out["cache hit"][1] is out["cold"][1]
    assert out["cache hit"][5] == ([], [])
    # the narrow delta: fast-forward, the warm solve restricted
    (j_seen, p_seen) = out["narrow delta"][5]
    assert p_seen == j_seen and len(p_seen) == 1
    assert 0 < p_seen[0] <= 4
    assert out["narrow delta"][3]["deltaApplies"] == 1
    # the wide delta: fast-forward, unrestricted, one counted fallback
    (j_seen, p_seen) = out["wide delta"][5]
    assert p_seen == j_seen == [None]
    wide = out["wide delta"][3]
    assert wide["deltaApplies"] == 2
    assert wide["lastFallbackReason"].startswith("dirty region too large")
    assert wide["fallbacks"] == out["narrow delta"][3]["fallbacks"] + 1
    assert isinstance(out["fix offline, nothing offline"][1], ValueError)
    assert out["fix offline"][3]["quarantines"] == 0
    assert pcc.incremental_solve_fallbacks == 0


def test_restricted_failure_retries_full_sweep(monkeypatch):
    """A restricted solve that fails its verdict is retried as a full
    sweep in both packages, with the same counters."""
    def failing_when_dirty(module, failure):
        real = module.GoalOptimizer.optimizations

        def wrapped(opt, *args, **kwargs):
            if kwargs.get("dirty_brokers") is not None:
                raise failure("forced verdict of the restricted solve")
            return real(opt, *args, **kwargs)
        monkeypatch.setattr(module.GoalOptimizer, "optimizations", wrapped)

    failing_when_dirty(JO, JFailure)
    failing_when_dirty(PO, OptimizationFailure)
    _sim, jcc, pmon, pcc, _clock = make_pair()
    try:
        for cc in (jcc, pcc):
            cc.optimizations()
        jcc.load_monitor.apply_model_delta(NARROW)
        pmon.apply_model_delta(port_delta(NARROW))
        jr, pr = jcc.optimizations(), pcc.optimizations()
        assert proposal_keys(pr) == proposal_keys(jr)
        assert counters(pcc.model_store.to_json()) == \
            counters(jcc._model_store.to_json())
        assert pcc.model_store.last_fallback_reason == \
            "dirty-region solve verdict; full sweep retry"
        assert pcc.incremental_solve_fallbacks == 1
    finally:
        jcc.shutdown()


def test_invalidated_cache_solves_again():
    """After the cache is invalidated (the reference does so when an
    execution starts), the same request solves again, warm from the
    seed, in both packages."""
    _sim, jcc, _pmon, pcc, _clock = make_pair()
    try:
        first = [cc.optimizations() for cc in (jcc, pcc)]
        for cc in (jcc, pcc):
            cc._invalidate_proposal_cache()
        again = [cc.optimizations() for cc in (jcc, pcc)]
        assert again[1] is not first[1]
        assert proposal_keys(again[1]) == proposal_keys(again[0])
        assert counters(pcc.model_store.to_json()) == \
            counters(jcc._model_store.to_json())
        assert pcc.model_store.hits == 1
    finally:
        jcc.shutdown()


def test_eager_rung_is_the_eager_driver():
    _sim, jcc, _pmon, pcc, _clock = make_pair()
    jcc.shutdown()
    state, topo = pcc._model_for_solve()
    state = F._own_copy(state)
    options = pcc._options_generator.generate(OptimizationOptions(), topo)
    want = pcc.goal_optimizer.optimizations(
        state, topo, options, eager_hard_abort=True, eager_driver=True,
        device="cpu")
    got = pcc._solve_on_rung(F.SolverRung.EAGER, pcc.goal_optimizer,
                             False, None, None, None)
    assert proposal_keys(got) == proposal_keys(want)
    assert got.rounds_by_goal == want.rounds_by_goal


def test_self_healing_options():
    _sim, jcc, pmon, pcc, _clock = make_pair()
    jcc.shutdown()
    assert pcc._self_healing_options() is None
    assert pcc._self_healing_options((0,), (5,)) == OptimizationOptions(
        **HEAL)
    assert pcc._self_healing_options(recently_removed=(5,)) == \
        dataclasses.replace(OptimizationOptions(**HEAL),
                            excluded_brokers_for_leadership=frozenset())


def test_what_the_port_lacks_raises():
    _sim, jcc, pmon, pcc, _clock = make_pair()
    jcc.shutdown()
    # executing needs the cluster's admin client, which this facade lacks
    with pytest.raises(ValueError, match="admin"):
        pcc.rebalance(dryrun=False)
    for call, what in ((lambda: pcc.optimizations(portfolio_width=4),
                        "portfolio"),
                       (lambda: F.CruiseControl(load_monitor=pmon,
                                                device="cpu",
                                                solver_precision="bfloat16"),
                        "precision")):
        with pytest.raises(NotImplementedError, match=what):
            call()


def test_facade_raises_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _sim, jcc, pmon, _pcc, _clock = make_pair()
    jcc.shutdown()
    with pytest.raises(RuntimeError):
        F.CruiseControl(load_monitor=pmon)
