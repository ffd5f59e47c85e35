"""Slot scheduling for continuous batching.

The port's own copy of ``mmlspark_tpu/sched/continuous.py``, with the same
semantics: a FIXED pool of sequence slots, FIFO admission into free slots at
step boundaries, per-slot token budgets, deadline shedding at admission, and
the ``sched_continuous_*`` series in the port's registry. Pure bookkeeping
(no device); the paged engine (``serving/llm.py``) asks it what to do at
every boundary.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from ..obs import registry as _default_registry


@dataclass
class SlotAssignment:
    """One admission: write ``prompt`` into buffer row ``slot`` and
    generate ``max_new_tokens`` for it."""
    slot: int
    seq_id: object
    prompt: object
    max_new_tokens: int


class SlotScheduler:
    """Fixed-pool sequence slots with step-boundary admission.

    Protocol (driven by the generation loop):

    1. ``offer(seq_id, prompt, max_new_tokens)`` — enqueue work (FIFO).
    2. ``admit()`` at a step boundary — returns :class:`SlotAssignment`s
       for every free slot with pending work.
    3. ``step()`` after each decode step — advances every active slot's
       generated-token count and returns the ``seq_id``/slot pairs that
       just completed their budget (their slots are freed immediately,
       so the next ``admit`` can refill them).
    """

    def __init__(self, slots: int, service: str = "generate",
                 registry=None, clock=None):
        if slots < 1:
            raise ValueError("need at least one slot")
        reg = registry if registry is not None else _default_registry
        self.slots = int(slots)
        self.service = service
        # injectable for deadline tests; monotonic so wall-clock jumps
        # never mass-expire a queue
        self._clock = clock if clock is not None else time.monotonic
        self._free: deque[int] = deque(range(slots))
        self._pending: deque[tuple] = deque()
        # slot -> [seq_id, generated, budget]
        self._active: dict[int, list] = {}
        # seq_ids shed at admission, awaiting drain_expired()
        self._expired: list = []
        self._c_admitted = reg.counter(
            "sched_continuous_admitted_total",
            "sequences admitted into in-flight generation, by service")
        self._c_expired = reg.counter(
            "sched_continuous_expired_total",
            "pending sequences shed at admission because their "
            "deadline had already passed, by service")
        self._c_steps = reg.counter(
            "sched_continuous_steps_total",
            "decode steps executed, by service")
        self._g_active = reg.gauge(
            "sched_continuous_active_slots",
            "slots generating this step, by service")
        self._h_occupancy = reg.histogram(
            "sched_continuous_occupancy",
            "active slots per decode step, by service",
            buckets=tuple(float(1 << k) for k in range(11)))

    # -- intake ------------------------------------------------------------
    def offer(self, seq_id, prompt, max_new_tokens: int,
              deadline: float | None = None) -> None:
        """Enqueue work. ``deadline`` (optional) is an absolute time on
        this scheduler's clock (``time.monotonic`` by default) past
        which the sequence is WORTHLESS — :meth:`admit` sheds it
        instead of letting a dead request occupy a slot for its full
        token budget."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._pending.append((seq_id, prompt, int(max_new_tokens),
                              None if deadline is None
                              else float(deadline)))

    # -- boundary protocol -------------------------------------------------
    def admit(self) -> list[SlotAssignment]:
        """Fill free slots from the FIFO at a step boundary. Pending
        sequences whose deadline already expired are shed (counted in
        ``sched_continuous_expired_total``, returned by
        :meth:`drain_expired`) without consuming a slot."""
        out: list[SlotAssignment] = []
        now = self._clock()
        # sweep the WHOLE queue for expiry first — a dead request
        # behind a full slot pool must not wait for a free slot just to
        # be told it is dead (it would also jump ahead of live work)
        live: deque[tuple] = deque()
        for entry in self._pending:
            if entry[3] is not None and entry[3] <= now:
                self._expired.append(entry[0])
                self._c_expired.inc(1, service=self.service)
            else:
                live.append(entry)
        self._pending = live
        while self._free and self._pending:
            seq_id, prompt, budget, deadline = self._pending.popleft()
            slot = self._free.popleft()
            self._active[slot] = [seq_id, 0, budget]
            out.append(SlotAssignment(slot=slot, seq_id=seq_id,
                                      prompt=prompt,
                                      max_new_tokens=budget))
            self._c_admitted.inc(1, service=self.service)
        self._g_active.set(len(self._active), service=self.service)
        return out

    def drain_expired(self) -> list:
        """seq_ids shed by :meth:`admit` since the last drain — the
        serving layer turns these into 504-style rejections instead of
        silently dropping them."""
        out, self._expired = self._expired, []
        return out

    def step(self, tokens: dict | None = None
             ) -> list[tuple[object, int]]:
        """Account one executed decode step; returns ``(seq_id, slot)``
        for sequences that just finished (slots freed immediately).

        ``tokens`` (optional) maps slot -> tokens committed this step
        for callers whose step can advance a slot by MORE than one
        token (speculative decode accepting a burst); unlisted active
        slots advance by 1, a 0 entry holds the slot's budget still."""
        self._c_steps.inc(1, service=self.service)
        self._h_occupancy.observe(len(self._active),
                                  service=self.service)
        done: list[tuple[object, int]] = []
        for slot in list(self._active):
            state = self._active[slot]
            state[1] += 1 if tokens is None else int(tokens.get(slot, 1))
            if state[1] >= state[2]:
                done.append((state[0], slot))
                del self._active[slot]
                self._free.append(slot)
        self._g_active.set(len(self._active), service=self.service)
        return done

    # -- introspection -----------------------------------------------------
    @property
    def active_slots(self) -> dict[int, tuple]:
        """slot -> (seq_id, generated, budget) — a read-only view."""
        return {s: tuple(v) for s, v in self._active.items()}

    def remaining(self, slot: int) -> int:
        seq_id, generated, budget = self._active[slot]
        return budget - generated

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def busy(self) -> bool:
        return bool(self._active or self._pending)
