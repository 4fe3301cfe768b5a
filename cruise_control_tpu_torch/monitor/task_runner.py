"""The load-monitor task runner: the sampling state machine (port of
cruise_control_tpu/monitor/task_runner.py).

Drives the periodic sampling task and the one-shot bootstrap and load
tasks through the states {NOT_STARTED, RUNNING, SAMPLING, PAUSED,
BOOTSTRAPPING, TRAINING, LOADING} (Cruise Control's
LoadMonitorTaskRunner.java); sampling is paused while an execution runs.
"""
from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Callable, Optional

from cruise_control_tpu_torch.cluster.metadata import MetadataClient
from cruise_control_tpu_torch.monitor.sampling.fetcher import \
    MetricFetcherManager
from cruise_control_tpu_torch.monitor.sampling.sampler import SamplingMode

LOG = logging.getLogger(__name__)


class LoadMonitorTaskRunnerState(enum.Enum):
    """reference LoadMonitorTaskRunner.LoadMonitorTaskRunnerState"""

    NOT_STARTED = "NOT_STARTED"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    TRAINING = "TRAINING"
    LOADING = "LOADING"


class LoadMonitorTaskRunner:
    """Background sampling loop with pause/resume and bootstrap."""

    def __init__(self, metadata: MetadataClient,
                 fetcher: MetricFetcherManager,
                 sampling_interval_ms: float,
                 time_fn: Callable[[], float] = time.time):
        self._metadata = metadata
        self._fetcher = fetcher
        self._interval_s = sampling_interval_ms / 1000.0
        self._time_fn = time_fn
        self._state = LoadMonitorTaskRunnerState.NOT_STARTED
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._shutdown = False
        self._paused_reason: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._last_sample_end_ms = 0.0

    # ------------------------------------------------------------------
    @property
    def state(self) -> LoadMonitorTaskRunnerState:
        with self._lock:
            return self._state

    @property
    def reason_of_pause(self) -> Optional[str]:
        with self._lock:
            return self._paused_reason

    def start(self, do_sampling: bool = True) -> None:
        with self._lock:
            if self._state != LoadMonitorTaskRunnerState.NOT_STARTED:
                raise RuntimeError("task runner already started")
            self._state = LoadMonitorTaskRunnerState.RUNNING
        if do_sampling:
            self._thread = threading.Thread(
                target=self._run, name="load-monitor-task-runner",
                daemon=True)
            self._thread.start()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def pause_sampling(self, reason: str) -> None:
        """reference LoadMonitorTaskRunner.pauseSampling"""
        with self._lock:
            if self._state in (LoadMonitorTaskRunnerState.RUNNING,
                               LoadMonitorTaskRunnerState.SAMPLING):
                self._state = LoadMonitorTaskRunnerState.PAUSED
                self._paused_reason = reason
                LOG.info("metric sampling paused: %s", reason)

    def resume_sampling(self, reason: str) -> None:
        """reference LoadMonitorTaskRunner.resumeSampling"""
        with self._lock:
            if self._state == LoadMonitorTaskRunnerState.PAUSED:
                self._state = LoadMonitorTaskRunnerState.RUNNING
                self._paused_reason = None
                LOG.info("metric sampling resumed: %s", reason)
        self._wake.set()

    # ------------------------------------------------------------------
    def sample_once(self, mode: SamplingMode = SamplingMode.ALL) -> None:
        """One synchronous sampling round (also used by tests and by
        bootstrap)."""
        with self._lock:
            now_ms = self._time_fn() * 1000.0
            start_ms = (self._last_sample_end_ms
                        or now_ms - self._interval_s * 1e3)
        cluster = self._metadata.refresh_metadata()
        self._fetcher.fetch_metrics_for_model(cluster, start_ms, now_ms, mode)
        # window handoff under the lock (the loop thread and bootstrap/
        # test callers share it); only a SUCCESSFUL fetch consumes the
        # window, so the two blocks stay separate
        with self._lock:
            self._last_sample_end_ms = now_ms

    def bootstrap(self, num_rounds: int, advance_fn: Optional[
            Callable[[float], None]] = None) -> None:
        """Synchronously run `num_rounds` sampling rounds to fill windows
        (reference BootstrapTask.java; range-bootstrap via a sampler that
        serves history).  `advance_fn(seconds)` lets simulated time move
        between rounds."""
        with self._lock:
            prev = self._state
            self._state = LoadMonitorTaskRunnerState.BOOTSTRAPPING
        try:
            for _ in range(num_rounds):
                self.sample_once()
                if advance_fn is not None:
                    advance_fn(self._interval_s)
        finally:
            with self._lock:
                self._state = prev

    def set_loading(self, loading: bool) -> None:
        with self._lock:
            if loading:
                self._state_before_loading = self._state
                self._state = LoadMonitorTaskRunnerState.LOADING
            elif self._state == LoadMonitorTaskRunnerState.LOADING:
                self._state = getattr(self, "_state_before_loading",
                                      LoadMonitorTaskRunnerState.RUNNING)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=self._interval_s)
            self._wake.clear()
            with self._lock:
                if self._shutdown:
                    return
                if self._state != LoadMonitorTaskRunnerState.RUNNING:
                    continue
                self._state = LoadMonitorTaskRunnerState.SAMPLING
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - keep the loop alive
                LOG.exception("sampling round failed")
            finally:
                with self._lock:
                    if self._state == LoadMonitorTaskRunnerState.SAMPLING:
                        self._state = LoadMonitorTaskRunnerState.RUNNING
