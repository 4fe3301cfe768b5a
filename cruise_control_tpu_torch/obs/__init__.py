"""Observability (port of cruise_control_tpu/obs/).

* `obs.trace` — request-scoped span trees, minted by the facade around
  every solve and carried to the scheduler's dispatch thread.
* `obs.recorder` — the flight recorder: a ring of finished traces, with
  failed, degraded, fallback and preempted ones pinned until exported.
* `obs.export` — the OpenMetrics page of the sensor registry.
* `obs.slo` — per-class latency and error-budget objectives, burn rates
  computed from the scheduler's histograms.
"""
from cruise_control_tpu_torch.obs import export, recorder, slo, trace

__all__ = ["export", "recorder", "slo", "trace"]
