"""Device-time solve scheduler, the single gateway of every solve (port
of cruise_control_tpu/sched/).

policy.py (priority classes, caps, deadline budgets, aging), queue.py
(bounded admission, single-flight coalescing, backpressure),
scheduler.py (the dispatch loop: priority order, scenario folding,
segment-boundary preemption), stats.py (SchedulerState and the sched-*
sensors), runtime.py (the thread-local hooks the solver pipeline shares
with the scheduler).
"""
from cruise_control_tpu_torch.sched.policy import (PREEMPTIBLE_CLASSES,
                                                   ClassPolicy,
                                                   SchedulerClass,
                                                   SchedulerPolicy)
from cruise_control_tpu_torch.sched.queue import (AdmissionQueue,
                                                  QueueFullError, SolveTicket)
from cruise_control_tpu_torch.sched.runtime import SolvePreempted
from cruise_control_tpu_torch.sched.scheduler import (DeviceTimeScheduler,
                                                      FoldedFailure,
                                                      SchedulerStoppedError,
                                                      SolveJob)

__all__ = [
    "AdmissionQueue", "ClassPolicy", "DeviceTimeScheduler",
    "FoldedFailure", "PREEMPTIBLE_CLASSES", "QueueFullError",
    "SchedulerClass", "SchedulerPolicy", "SchedulerStoppedError",
    "SolveJob", "SolvePreempted", "SolveTicket",
]
