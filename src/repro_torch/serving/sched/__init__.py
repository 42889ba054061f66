"""``repro_torch.serving.sched`` — proactive admission control and the
continuous-batching scheduler over the hash-table page allocator (copies of
the JAX package's numpy-only modules).  ``router`` stacks one scheduler
per table shard behind hash-prefix routing (``serving/sharded_table``)."""
from repro_torch.serving.sched.forecast import (Forecast, OccupancyForecaster,
                                                pages_held, pages_needed)
from repro_torch.serving.sched.policy import (DeadlinePolicy, POLICIES,
                                              Policy, PriorityPolicy,
                                              get_policy)
from repro_torch.serving.sched.request import (DONE, QUEUED, RUNNING,
                                               Request)
from repro_torch.serving.sched.router import PrefixRouter
from repro_torch.serving.sched.scheduler import (Plan, RoundStats,
                                                 SchedStats, Scheduler)
from repro_torch.serving.sched.workload import (churn_request,
                                                churn_workload,
                                                synthetic_workload)

__all__ = [
    "DONE", "QUEUED", "RUNNING", "Request",
    "Forecast", "OccupancyForecaster", "pages_held", "pages_needed",
    "Policy", "PriorityPolicy", "DeadlinePolicy", "POLICIES", "get_policy",
    "Plan", "RoundStats", "SchedStats", "Scheduler", "PrefixRouter",
    "churn_request", "churn_workload", "synthetic_workload",
]
