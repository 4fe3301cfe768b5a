"""Solver degradation ladder (port of cruise_control_tpu/analyzer/
degradation.py): failure classification, retry backoff and a circuit
breaker for the goal pipeline.

The ladder's rungs (facade `CruiseControl._solve_on_rung`):

  FUSED  — the goal pipeline on the facade's device, segments of
           `pipeline_segment_size` goals (or the fusion plan).
  EAGER  — one goal a segment with the eager hard-goal abort
           (`GoalOptimizer.optimizations(eager_driver=True)`).
  CPU    — the host-side numpy fallback (model/cpu_model.py
           `host_fallback_solve`): self-healing placement repair only,
           no device work.  Degraded but never unavailable.

MESH sits above FUSED in the reference (the pipeline over a multi-chip
mesh); the port has no mesh, so its ladders top out at FUSED and MESH is
never entered.

Classification drives policy: INVALID_INPUT (NaN/Inf/negative loads)
never retries or descends; COMPILE and RUNTIME retry on the same rung
with backoff, then descend.

One difference from the reference, whose ladders step around any
failure: in the port only an injected fault (utils/faults.FaultError)
and the card running out of memory (torch.cuda.OutOfMemoryError) are
ladder material (`ladder_material`).  Everything else raises through
the ladder: a hand-written kernel that fails to build or load
(`cuda_kernels.KernelBuildError`), to launch or run
(`KernelLaunchError`) or whose wrapper is called outside its contract
(`KernelContractError`), and any other error of the port, so that a
broken kernel or a bug is never hidden behind answers served from a
lower rung.
"""
from __future__ import annotations

import dataclasses
import enum
import logging
import random
import threading
from typing import Callable, Optional

import torch

LOG = logging.getLogger(__name__)


class FailureKind(enum.Enum):
    """What layer a solve failure belongs to (drives retry policy)."""

    INVALID_INPUT = "INVALID_INPUT"   # NaN/Inf/negative model inputs
    COMPILE = "COMPILE"               # an injected fault at a compile site
    RUNTIME = "RUNTIME"               # device execution / everything else


class SolverRung(enum.IntEnum):
    """Degradation ladder rungs, best to most degraded.  MESH (-1) keeps
    the reference's values; the port never enters it (no mesh)."""

    MESH = -1
    FUSED = 0
    EAGER = 1
    CPU = 2


class InvalidModelInputError(ValueError):
    """The cluster model carries NaN/Inf/negative loads or capacities."""


def classify_failure(exc: BaseException) -> FailureKind:
    """Bucket a solve failure by the port's own types: injected faults
    (utils/faults.FaultError) by their site, the typed invalid-input
    verdict, and everything else (the card's out-of-memory error
    included, as the reference reads RESOURCE_EXHAUSTED) RUNTIME."""
    from cruise_control_tpu_torch.utils.faults import FaultError
    if isinstance(exc, InvalidModelInputError):
        return FailureKind.INVALID_INPUT
    if isinstance(exc, FaultError) and ".compile" in exc.site:
        return FailureKind.COMPILE
    return FailureKind.RUNTIME


def ladder_material(exc: BaseException) -> bool:
    """Whether a failed solve may be retried and served from a lower
    rung: an injected fault or the card running out of memory.  Every
    other failure raises through the ladder (see the module docstring)."""
    from cruise_control_tpu_torch.utils.faults import FaultError
    return isinstance(exc, (FaultError, torch.cuda.OutOfMemoryError))


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with deterministic jitter:
    min(base * 2^attempt * (1 + jitter * u), max), u from a seeded RNG."""

    base_s: float = 1.0
    max_s: float = 60.0
    jitter: float = 0.25
    seed: int = 0

    def delays(self):
        """Generator of successive delays (one per solve request)."""
        rng = random.Random(self.seed)
        attempt = 0
        while True:
            d = self.base_s * (2.0 ** attempt) \
                * (1.0 + self.jitter * rng.random())
            yield min(d, self.max_s)
            attempt += 1


class BreakerState(enum.Enum):
    CLOSED = "CLOSED"         # normal service
    OPEN = "OPEN"             # pinned to the degraded rung until cooldown
    HALF_OPEN = "HALF_OPEN"   # cooldown elapsed: probing one rung up


class CircuitBreaker:
    """Consecutive-failure breaker (thread-safe): CLOSED → (N consecutive
    failures) → OPEN → (cooldown) → HALF_OPEN → success closes, failure
    re-opens with a fresh cooldown."""

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 300.0,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        import time as _time
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._time = time_fn or _time.time
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> BreakerState:
        if self._opened_at is None:
            return BreakerState.CLOSED
        if self._time() - self._opened_at >= self.cooldown_s:
            return BreakerState.HALF_OPEN
        return BreakerState.OPEN

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive_failures

    def cooldown_remaining_s(self) -> float:
        with self._lock:
            if self._opened_at is None:
                return 0.0
            return max(0.0,
                       self.cooldown_s - (self._time() - self._opened_at))

    def record_failure(self) -> bool:
        """True when this failure opened a CLOSED breaker."""
        with self._lock:
            self._consecutive_failures += 1
            was_open = self._opened_at is not None
            if self._consecutive_failures >= self.failure_threshold:
                # a failure while OPEN/HALF_OPEN restarts the cooldown
                self._opened_at = self._time()
                return not was_open
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._opened_at = None

    def to_json(self) -> dict:
        with self._lock:
            return {
                "state": self._state_locked().value,
                "consecutiveFailures": self._consecutive_failures,
                "failureThreshold": self.failure_threshold,
                "cooldownRemainingS": round(
                    0.0 if self._opened_at is None else max(
                        0.0, self.cooldown_s
                        - (self._time() - self._opened_at)), 3),
            }


class DegradationLadder:
    """Rung state machine shared by every solve of one facade.

    While the breaker is OPEN the resting rung is pinned (successes there
    do not close it); otherwise a degraded ladder probes one rung up, and
    a successful probe climbs one rung and closes the breaker."""

    def __init__(self, breaker: CircuitBreaker,
                 start_rung: Optional[SolverRung] = None,
                 top_rung: SolverRung = SolverRung.FUSED) -> None:
        self.breaker = breaker
        self._lock = threading.Lock()
        self.top_rung = top_rung
        self._rung = top_rung if start_rung is None else start_rung
        #: lifetime descent count
        self.total_descents = 0

    @property
    def rung(self) -> SolverRung:
        with self._lock:
            return self._rung

    def entry_rung(self) -> SolverRung:
        """The pinned resting rung while the breaker is OPEN, one rung up
        otherwise (the recovery probe; the top rung when healthy)."""
        state = self.breaker.state
        with self._lock:
            if (state is not BreakerState.OPEN
                    and self._rung > self.top_rung):
                return SolverRung(self._rung - 1)
            return self._rung

    def on_failure(self, rung: SolverRung) -> bool:
        """Record a failed attempt at `rung`; True when it tripped the
        breaker."""
        return self.breaker.record_failure()

    def descend(self, from_rung: SolverRung) -> Optional[SolverRung]:
        """Step down one rung; the new rung, or None at the bottom."""
        with self._lock:
            if from_rung >= SolverRung.CPU:
                return None
            nxt = SolverRung(from_rung + 1)
            if nxt > self._rung:
                self._rung = nxt
                self.total_descents += 1
            return nxt

    def on_success(self, rung: SolverRung) -> None:
        """A success above the resting rung (a probe) or at the top rung
        climbs or settles the ladder and closes the breaker; one at a
        degraded resting rung changes nothing."""
        with self._lock:
            probe = rung < self._rung
            if probe:
                self._rung = rung
            top = self.top_rung
        if probe or rung <= top:
            self.breaker.record_success()

    def to_json(self) -> dict:
        with self._lock:
            rung = self._rung
        return {"rung": rung.name, "rungValue": int(rung),
                "totalDescents": self.total_descents,
                "breaker": self.breaker.to_json()}
