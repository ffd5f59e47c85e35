"""Request scheduling for the port: ``SlotScheduler``, the step-boundary
slot pool of continuous batching (``sched/continuous.py``), and
``BatchPolicy``, the batch-close decision (``sched/policy.py``).

The service-time estimator, admission controller, request scheduler and
tenancy of the JAX package's ``sched`` come with ROADMAP.md §1 item 9.
"""

from .continuous import SlotAssignment, SlotScheduler
from .policy import CLOSE, GROW, WAIT, BatchPolicy, bucket_of

__all__ = ["BatchPolicy", "CLOSE", "GROW", "SlotAssignment",
           "SlotScheduler", "WAIT", "bucket_of"]
