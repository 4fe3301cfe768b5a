"""Observability (port of cruise_control_tpu/obs/): request-scoped
tracing.  The flight recorder, the metrics export and the SLO evaluator
are not ported yet."""
from cruise_control_tpu_torch.obs import trace

__all__ = ["trace"]
