"""The PyTorch port's executor journal and crash recovery
(cruise_control_tpu_torch/executor/journal.py, executor/recovery.py,
utils/persist.py, obs/trace.py) against the JAX package's, on the CPU.
Host code only.

The rig of the JAX package's tests/test_executor_recovery.py: four
brokers with two logdirs, three partitions, proposals of all three
phases, a move rate that takes several polls, an admin proxy that can
"kill the process" before or after its nth call and counts growth
submissions.  Over each package:
- a journaled execution with a fixed uuid writes byte for byte the same
  journal (segments and history file), and each package's replay of
  either journal is the same;
- the kill-at-every-sleep matrix (that file's test at :224), recovered
  in `resume` and in `abort` mode, ends in the same snapshot, report,
  growth counts and throttles, and each package recovers the other's
  journal of the same crash;
- torn-tail and corrupt-record truncation, the CRC framing and the
  double crash give the same results;
- the fault sites `executor.journal.write` and `executor.journal.fsync`
  degrade the journal the same way;
- the trace of a recovery has the same spans (names, tags, parents) and
  events.
"""
import os
import shutil

import pytest

import cruise_control_tpu.obs.trace as J_TRACE
import cruise_control_tpu.utils.persist as J_PERSIST
import cruise_control_tpu_torch.obs.trace as P_TRACE
import cruise_control_tpu_torch.utils.persist as P_PERSIST
from test_torch_executor import KITS, norm, proposal, snapshot_key

UUID = "5e1f0000-0000-4000-8000-00000000beef"
TRACE = {"jax": J_TRACE, "port": P_TRACE}
PERSIST = {"jax": J_PERSIST, "port": P_PERSIST}


def make_sim(k):
    sim = k.sim.SimulatedCluster()  # virtual clock
    sim._move_rate = 20e6           # several poll intervals per move
    for b in range(4):
        sim.add_broker(b, rack=f"r{b % 2}", logdirs=("/d0", "/d1"))
    sim.create_topic("t", [[0, 1], [1, 2], [2, 3]], size_bytes=40e6)
    return sim


def proposals(k):
    """Replica moves, a logdir move and leader moves: all three phases."""
    return [
        proposal(k, "t", 0, [0, 1], [2, 1], old_leader=0, size=40e6),
        proposal(k, "t", 1, [1, 2], [3, 2], old_leader=1, size=40e6),
        proposal(k, "t", 2, [2, 3], [2, 3], old_leader=2, size=40e6,
                 logdirs_old={2: "/d0"}, logdirs_new={2: "/d1"}),
    ]


class Killed(RuntimeError):
    """The simulated SIGKILL."""


class CrashyAdmin:
    """Forwards to the simulated cluster while on; counts growth
    submissions (targets adding brokers a partition does not host); can
    kill the process before or after its nth call."""

    def __init__(self, sim, growth, journal=None, kill_before_call=None,
                 kill_after_call=None):
        self._sim = sim
        self._growth = growth
        self._journal = journal
        self._kill_before = kill_before_call
        self._kill_after = kill_after_call
        self.calls = 0
        self.on = True

    def _die(self):
        self.on = False
        if self._journal is not None:
            self._journal.broken = True
        raise Killed("simulated process kill")

    def __getattr__(self, name):
        real = getattr(self._sim, name)
        if not callable(real):
            return real

        def call(*args, **kwargs):
            if not self.on:
                raise Killed("process is dead")
            self.calls += 1
            if self._kill_before is not None \
                    and self.calls == self._kill_before:
                self._die()
            if name == "alter_partition_reassignments":
                for tp, target in args[0].items():
                    if target is None:
                        continue
                    current = set(self._sim._partitions[tp].replicas)
                    if set(target) - current:
                        key = (tp.topic, tp.partition)
                        self._growth[key] = self._growth.get(key, 0) + 1
            out = real(*args, **kwargs)
            if self._kill_after is not None \
                    and self.calls == self._kill_after:
                self._die()
            return out
        return call


def clock(sim):
    return lambda: sim.now_ms() / 1000.0


def crashed_run(k, jdir, kill_sleep=None, kill_before_call=None,
                kill_after_call=None, throttle=None, removed=()):
    """One process: start the execution and crash it at the chosen
    point.  (sim, growth counts, uuid or None)."""
    sim = make_sim(k)
    growth = {}
    journal = k.ex.ExecutionJournal(jdir, time_fn=clock(sim))
    proxy = CrashyAdmin(sim, growth, journal, kill_before_call,
                        kill_after_call)
    ex = k.ex.Executor(proxy, progress_check_interval_s=1.0,
                       journal=journal,
                       replication_throttle_bytes_per_s=throttle,
                       time_fn=clock(sim))
    sleeps = {"n": 0}

    def sleep(s):
        sleeps["n"] += 1
        if kill_sleep is not None and sleeps["n"] == kill_sleep:
            proxy.on = False
            journal.broken = True
            raise Killed("simulated process kill during sleep")
        sim.advance(s)
    ex._sleep = sleep
    uuid = None
    try:
        uuid = ex.execute_proposals(proposals(k), reason="prod", uuid=UUID,
                                    removed_brokers=list(removed),
                                    wait=True)
    except Killed:
        pass
    journal.close()
    return sim, growth, uuid


def recover(k, sim, jdir, growth, mode="resume"):
    """The restarted process: a fresh executor over the same journal
    directory and the powered-back-on cluster."""
    journal = k.ex.ExecutionJournal(jdir, time_fn=clock(sim))
    ex = k.ex.Executor(CrashyAdmin(sim, growth),
                       progress_check_interval_s=1.0, journal=journal,
                       time_fn=clock(sim), sleep_fn=sim.advance)
    report = ex.recover(mode=mode, wait=True)
    journal.close()
    return ex, report


def settled(sim, ex, report, growth):
    return dict(snapshot=snapshot_key(sim.describe_cluster()),
                reassigning=norm(sim.list_partition_reassignments()),
                throttles=tuple(sorted((b, v.throttle)
                                       for b, v in sim._brokers.items())),
                report=report, growth=tuple(sorted(growth.items())),
                ongoing=ex.has_ongoing_execution,
                removed=tuple(sorted(ex.recently_removed_brokers())),
                clock=sim.now_ms())


def journal_files(jdir):
    return {name: open(os.path.join(jdir, name), "rb").read()
            for name in sorted(os.listdir(jdir))}


def replay_key(k, jdir):
    r = k.ex.ExecutionJournal(jdir).replay()
    return norm((r.start, r.tasks, r.phase, r.finished, r.throttle_brokers,
                 r.truncated, r.records, r.segments,
                 [k.ex.journal.proposal_record(p) for p in r.proposals()]))


def clean_sleeps(k):
    sim = make_sim(k)
    ex = k.ex.Executor(sim, progress_check_interval_s=1.0,
                       time_fn=clock(sim))
    count = {"n": 0}

    def counting_sleep(s):
        count["n"] += 1
        sim.advance(s)
    ex._sleep = counting_sleep
    ex.execute_proposals(proposals(k), reason="count", uuid=UUID,
                         wait=True)
    return count["n"]


# ---------------------------------------------------------------------------
# journals: byte for byte, and each package replays the other's
# ---------------------------------------------------------------------------
def test_journal_bytes_and_replay_equal_reference(tmp_path):
    files, dirs = {}, {}
    for k in KITS:
        sim = make_sim(k)
        jdir = str(tmp_path / k.name)
        journal = k.ex.ExecutionJournal(jdir, time_fn=clock(sim))
        ex = k.ex.Executor(sim, progress_check_interval_s=1.0,
                           journal=journal,
                           replication_throttle_bytes_per_s=30e6,
                           time_fn=clock(sim), sleep_fn=sim.advance)
        ex.execute_proposals(proposals(k), reason="bytes", uuid=UUID,
                             removed_brokers=[3], demoted_brokers=[0],
                             wait=True)
        journal.close()
        files[k.name], dirs[k.name] = journal_files(jdir), jdir
    assert files["port"] == files["jax"]
    assert any(name.startswith("journal-") for name in files["port"])
    replays = {(k.name, src): replay_key(k, dirs[src])
               for k in KITS for src in dirs}
    assert len({repr(v) for v in replays.values()}) == 1
    assert replays[("port", "jax")][3] is True      # finished


@pytest.mark.parametrize("mode", ["resume", "abort"])
def test_kill_at_every_sleep_equals_reference(tmp_path, mode):
    n = {k.name: clean_sleeps(k) for k in KITS}
    assert n["port"] == n["jax"] >= 4
    for step in range(1, n["port"] + 1):
        outs = []
        for k in KITS:
            jdir = str(tmp_path / f"{mode}{step}{k.name}")
            sim, growth, uuid = crashed_run(k, jdir, kill_sleep=step,
                                            throttle=100e6, removed=[3])
            ex, report = recover(k, sim, jdir, growth, mode)
            outs.append((uuid, settled(sim, ex, report, growth)))
        assert outs[1] == outs[0], f"kill at sleep {step}"
        assert all(count <= 1 for _tp, count in outs[1][1]["growth"])


def test_each_package_recovers_the_others_journal(tmp_path):
    """The same crash in both packages, then each recovers with the
    other's journal: the outcome is the one of its own."""
    runs = {}
    for k in KITS:
        jdir = str(tmp_path / f"crash-{k.name}")
        runs[k.name] = (crashed_run(k, jdir, kill_sleep=2, throttle=100e6),
                        jdir)
    assert journal_files(runs["port"][1]) == journal_files(runs["jax"][1])
    outs = {}
    for k, other in zip(KITS, ("port", "jax")):
        (sim, growth, uuid), _ = runs[k.name]
        jdir = str(tmp_path / f"swapped-{k.name}")
        shutil.copytree(runs[other][1], jdir)
        ex, report = recover(k, sim, jdir, growth)
        assert report is not None and report["uuid"] == uuid == UUID
        outs[k.name] = settled(sim, ex, report, growth)
    assert outs["port"] == outs["jax"]


# ---------------------------------------------------------------------------
# truncation, framing, a double crash
# ---------------------------------------------------------------------------
def _last_segment(jdir):
    return os.path.join(jdir, sorted(p for p in os.listdir(jdir)
                                     if p.startswith("journal-"))[-1])


def _torn(path):
    with open(path, "ab") as fh:
        fh.write(b"deadbeef {\"t\":\"garbage")


def _corrupt(path):
    with open(path, "rb") as fh:
        lines = fh.readlines()
    mid = len(lines) // 2
    bad = bytearray(lines[mid])
    bad[12] ^= 0xFF
    lines[mid] = bytes(bad)
    with open(path, "wb") as fh:
        fh.writelines(lines)


@pytest.mark.parametrize("damage,kill_sleep", [(_torn, 2), (_corrupt, 3)],
                         ids=["torn tail", "corrupt record"])
def test_truncation_equals_reference(tmp_path, damage, kill_sleep):
    outs = []
    for k in KITS:
        jdir = str(tmp_path / k.name)
        sim, growth, _uuid = crashed_run(k, jdir, kill_sleep=kill_sleep)
        damage(_last_segment(jdir))
        replay = replay_key(k, jdir)
        ex, report = recover(k, sim, jdir, growth)
        assert report is not None and report["journalTruncated"] is True
        outs.append((replay, settled(sim, ex, report, growth)))
    assert outs[1] == outs[0]


def test_crc_framing_equals_reference(tmp_path):
    out = {}
    for name, persist in PERSIST.items():
        path = str(tmp_path / f"{name}.jsonl")
        with open(path, "ab") as fh:
            fh.write(persist.json_frame({"a": 1, "b": [1.5, None]}))
            fh.write(persist.json_frame({"c": "x"}))
        first = persist.read_crc_json(path)
        with open(path, "ab") as fh:
            fh.write(b"0000000 not-a-frame\n")
            fh.write(persist.json_frame({"d": 3}))
        out[name] = (open(path, "rb").read(), first,
                     persist.read_crc_json(path),
                     persist.parse_crc_frame(b"00000000 x\n"),
                     persist.crc_frame(b"{}"))
    assert out["port"] == out["jax"]
    assert out["port"][2] == ([{"a": 1, "b": [1.5, None]}, {"c": "x"}], True)


def test_double_crash_equals_reference(tmp_path):
    outs = []
    for k in KITS:
        jdir = str(tmp_path / k.name)
        sim, growth, uuid = crashed_run(k, jdir, kill_sleep=3)
        journal2 = k.ex.ExecutionJournal(jdir, time_fn=clock(sim))
        proxy2 = CrashyAdmin(sim, growth, journal=journal2)
        ex2 = k.ex.Executor(proxy2, progress_check_interval_s=1.0,
                            journal=journal2, time_fn=clock(sim))

        def crashing_sleep(s, proxy2=proxy2, journal2=journal2):
            proxy2.on = False
            journal2.broken = True
            raise Killed("second kill")
        ex2._sleep = crashing_sleep
        report2 = ex2.recover(mode="resume", wait=True)
        journal2.close()
        ex3, report3 = recover(k, sim, jdir, growth)
        outs.append((uuid, report2, settled(sim, ex3, report3, growth)))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# the journal's fault sites
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("site,plan", [
    ("executor.journal.write", lambda p: p.fail_always(
        "executor.journal.write")),
    ("executor.journal.write", lambda p: p.fail_nth(
        "executor.journal.write", 5)),
    ("executor.journal.fsync", lambda p: p.fail_nth(
        "executor.journal.fsync", 1))],
    ids=["write always", "write 5th", "fsync 1st"])
def test_journal_fault_sites_equal_reference(tmp_path, site, plan):
    outs = []
    for k in KITS:
        sim = make_sim(k)
        jdir = str(tmp_path / k.name)
        journal = k.ex.ExecutionJournal(jdir, time_fn=clock(sim))
        degraded = []
        journal.on_error = lambda exc: degraded.append(str(exc))
        ex = k.ex.Executor(sim, progress_check_interval_s=1.0,
                           journal=journal, time_fn=clock(sim),
                           sleep_fn=sim.advance)
        with k.faults.injected(plan(k.faults.FaultPlan())) as injector:
            ex.execute_proposals(proposals(k), reason="sick", uuid=UUID,
                                 wait=True)
        journal.close()
        assert journal.broken and len(degraded) == 1
        assert not ex.has_ongoing_execution
        outs.append((settled(sim, ex, None, {}), journal.to_json()["writes"],
                     journal.errors, degraded, norm(injector.counts()),
                     journal_files(jdir)))
    assert outs[1] == outs[0]
    assert outs[1][4] and dict(outs[1][4])[site][1] >= 1


# ---------------------------------------------------------------------------
# the trace of a recovery
# ---------------------------------------------------------------------------
def _shape(node):
    """A trace node without its times and ids: name, tags, events (no
    times) and children, in order."""
    return (node["name"], norm(node.get("tags", {})),
            tuple(norm({k: v for k, v in e.items() if k != "atS"})
                  for e in node.get("events", ())),
            tuple(_shape(c) for c in node.get("children", ())))


def test_recovery_trace_equals_reference(tmp_path):
    outs = []
    for k in KITS:
        tr = TRACE[k.name]
        jdir = str(tmp_path / k.name)
        sim, growth, _uuid = crashed_run(k, jdir, kill_sleep=2,
                                         throttle=100e6)
        journal = k.ex.ExecutionJournal(jdir, time_fn=clock(sim))
        ex = k.ex.Executor(CrashyAdmin(sim, growth),
                           progress_check_interval_s=1.0, journal=journal,
                           time_fn=clock(sim), sleep_fn=sim.advance)
        trace = tr.start("executor.recovery", mode="resume")
        report = ex.recover(mode="resume", wait=True)
        tr.event("recovered", uuid=report["uuid"])
        tr.finish(trace)
        journal.close()
        doc = trace.to_json()
        outs.append((doc["outcome"], doc["numSpans"], doc["droppedSpans"],
                     _shape(doc["root"])))
    assert outs[1] == outs[0]
    names = [c[0] for c in outs[1][3][3]]
    assert names == ["recovery.replay", "recovery.reconcile",
                     "recovery.resume"]
