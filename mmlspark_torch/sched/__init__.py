"""Request scheduling for the port: ``SlotScheduler``, the step-boundary
slot pool of continuous batching (``sched/continuous.py``).

The admission controller, batch policy, request scheduler and tenancy of
the JAX package's ``sched`` come with ROADMAP.md §1 item 9.
"""

from .continuous import SlotAssignment, SlotScheduler

__all__ = ["SlotAssignment", "SlotScheduler"]
