"""Deterministic fault injection (port of cruise_control_tpu/utils/faults.py).

Named injection sites sit in the hot paths — executor admin calls
(`executor.admin.<op>`), journal writes and fsyncs
(`executor.journal.write`, `executor.journal.fsync`), the model store's
delta application (`store.apply_delta`) — and are inert (one None
check) unless a test installs a `FaultPlan`:

    plan = FaultPlan(seed=7)
    plan.fail_nth("executor.admin.describe_cluster", (2, 3))
    plan.fail_probability("executor.journal.write", 0.25)  # seeded RNG
    plan.fail_always("store.apply_delta", until=4)   # calls 1-4 fail
    plan.hang_nth("executor.admin.elect_preferred_leaders", 1, release)
    with faults.injected(plan):
        ...

A *failure* raises; a *hang* blocks the calling thread for a number of
seconds or until a `threading.Event` the test holds is set.  Every
injected exception is a `FaultError` carrying its `.site`.  Sites
register on their first `inject()`, so `known_sites()` reports the wired
surface; per-site call and failure counts make assertions exact.  The
seeded `random.Random` is drawn exactly as the JAX package draws it, so
one plan fires at the same calls in both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time as _time
from typing import Dict, Iterable, Optional, Tuple, Union

#: every site that executed at least one inject() in this process —
#: the live map of where faults CAN be injected
_KNOWN_SITES: set = set()
_KNOWN_LOCK = threading.Lock()


class FaultError(RuntimeError):
    """An injected fault.  `site` names the injection point so failure
    classification can treat a scripted compile fault exactly like a real
    compiler error."""

    def __init__(self, site: str, message: str = "") -> None:
        super().__init__(message or f"injected fault at {site}")
        self.site = site


@dataclasses.dataclass
class _SiteRule:
    fail_calls: frozenset = frozenset()      # 1-based call numbers
    fail_until: int = 0                      # calls 1..fail_until fail
    probability: float = 0.0
    exc_factory: Optional[object] = None     # callable(site) -> Exception
    hang_calls: frozenset = frozenset()      # 1-based call numbers
    hang_until: int = 0                      # calls 1..hang_until hang
    #: how a triggered hang blocks: float seconds, or a threading.Event
    #: the test sets to release the wedged thread
    hang_on: Optional[object] = None


class FaultPlan:
    """A deterministic script of faults, keyed by site name."""

    def __init__(self, seed: int = 0) -> None:
        self._rules: Dict[str, _SiteRule] = {}
        self._rng = random.Random(seed)

    def _rule(self, site: str) -> _SiteRule:
        return self._rules.setdefault(site, _SiteRule())

    def fail_nth(self, site: str, nth: Union[int, Iterable[int]],
                 exc_factory=None) -> "FaultPlan":
        """Fail the nth call (1-based), or each call in an iterable."""
        calls = frozenset((nth,) if isinstance(nth, int) else nth)
        rule = self._rule(site)
        rule.fail_calls = rule.fail_calls | calls
        if exc_factory is not None:
            rule.exc_factory = exc_factory
        return self

    def fail_always(self, site: str, until: Optional[int] = None,
                    exc_factory=None) -> "FaultPlan":
        """Fail every call, or calls 1..until when `until` is given."""
        rule = self._rule(site)
        rule.fail_until = (2 ** 31 if until is None else int(until))
        if exc_factory is not None:
            rule.exc_factory = exc_factory
        return self

    def fail_probability(self, site: str, p: float,
                         exc_factory=None) -> "FaultPlan":
        """Fail each call with probability p (seeded — reruns of the same
        plan over the same call sequence reproduce the same faults)."""
        rule = self._rule(site)
        rule.probability = float(p)
        if exc_factory is not None:
            rule.exc_factory = exc_factory
        return self

    def hang_nth(self, site: str, nth: Union[int, Iterable[int]],
                 hang_on) -> "FaultPlan":
        """HANG the nth call (1-based), or each call in an iterable:
        the calling thread blocks for `hang_on` seconds (float) or
        until `hang_on` (a threading.Event) is set.  This is the
        chip-loss / wedged-collective injection: the call never raises
        — it simply does not return in time."""
        calls = frozenset((nth,) if isinstance(nth, int) else nth)
        rule = self._rule(site)
        rule.hang_calls = rule.hang_calls | calls
        rule.hang_on = hang_on
        return self

    def hang_always(self, site: str, hang_on,
                    until: Optional[int] = None) -> "FaultPlan":
        """Hang every call, or calls 1..until when `until` is given."""
        rule = self._rule(site)
        rule.hang_until = (2 ** 31 if until is None else int(until))
        rule.hang_on = hang_on
        return self

    def should_hang(self, site: str, call_number: int):
        """The hang spec (seconds or Event) when this call hangs, else
        None."""
        rule = self._rules.get(site)
        if rule is None or rule.hang_on is None:
            return None
        if (call_number in rule.hang_calls
                or call_number <= rule.hang_until):
            return rule.hang_on
        return None

    def should_fail(self, site: str, call_number: int) -> bool:
        rule = self._rules.get(site)
        if rule is None:
            return False
        if call_number in rule.fail_calls or call_number <= rule.fail_until:
            return True
        return rule.probability > 0.0 \
            and self._rng.random() < rule.probability

    def exception_for(self, site: str) -> BaseException:
        rule = self._rules.get(site)
        if rule is not None and rule.exc_factory is not None:
            return rule.exc_factory(site)
        return FaultError(site)


class FaultInjector:
    """An installed plan plus per-site call/failure counters."""

    def __init__(self, plan: FaultPlan) -> None:
        self._plan = plan
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._failures: Dict[str, int] = {}
        self._hangs: Dict[str, int] = {}

    def fire(self, site: str) -> None:
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            fail = self._plan.should_fail(site, n)
            hang = None if fail else self._plan.should_hang(site, n)
            if fail:
                self._failures[site] = self._failures.get(site, 0) + 1
            elif hang is not None:
                self._hangs[site] = self._hangs.get(site, 0) + 1
        if fail:
            raise self._plan.exception_for(site)
        if hang is not None:
            # block OUTSIDE the lock: the wedged thread must not stop
            # other sites (or this site's counters) from firing
            if isinstance(hang, (int, float)):
                _time.sleep(float(hang))
            else:
                hang.wait()

    def call_count(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def failure_count(self, site: str) -> int:
        with self._lock:
            return self._failures.get(site, 0)

    def hang_count(self, site: str) -> int:
        with self._lock:
            return self._hangs.get(site, 0)

    def counts(self) -> Dict[str, Tuple[int, int]]:
        """{site: (calls, failures)} for every site that fired."""
        with self._lock:
            return {s: (c, self._failures.get(s, 0))
                    for s, c in sorted(self._calls.items())}


#: the process-wide active injector (None = harness inert)
_ACTIVE: Optional[FaultInjector] = None


def inject(site: str) -> None:
    """The injection point: a no-op unless a plan is installed.  Called
    from production code; the only cost on the happy path is one global
    read (plus first-call site registration)."""
    if site not in _KNOWN_SITES:
        with _KNOWN_LOCK:
            _KNOWN_SITES.add(site)
    injector = _ACTIVE
    if injector is not None:
        injector.fire(site)


def known_sites() -> set:
    """Sites that executed at least once in this process."""
    with _KNOWN_LOCK:
        return set(_KNOWN_SITES)


def install(plan: FaultPlan) -> FaultInjector:
    """Install a plan process-wide; returns the injector for counters."""
    global _ACTIVE
    injector = FaultInjector(plan)
    _ACTIVE = injector
    return injector


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Scoped installation: `with faults.injected(plan) as injector:`."""
    injector = install(plan)
    try:
        yield injector
    finally:
        uninstall()
